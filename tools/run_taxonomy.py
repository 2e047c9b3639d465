"""Taxonomy of the FINAL recovery misses of the patches-scale protocol.

The pre-sweep misses are blends; this script classifies what the last
unrecovered atoms are after the full protocol.  It re-runs the seeds
that did not reach 300/300 (0,1,2,5,6,9) with ``save_params`` set, then
runs
``data/diagnosis.py::diagnose_recovery`` on each FINAL dictionary and
classifies every residual miss:

  * post-sweep blend  — the blend signature is still present on a learned
    column covering the atom (the sweep's contrast gate rejected it, or
    it re-formed during the polish);
  * missing-no-donor  — atom nowhere present AND the sweep ran out of
    donor columns;
  * missing           — atom nowhere present with donors to spare
    (identifiability-limited: nothing in the dictionary points at it).

Output: per-seed JSON lines + a final summary line.

Run from the repository root:  python tools/run_taxonomy.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = [0, 1, 2, 5, 6, 9]


def classify_seed(seed: int, out_dir: str = "taxonomy_out"):
    os.makedirs(out_dir, exist_ok=True)
    from examples.patches_scale_run import main
    from prosper_tpu.data.diagnosis import diagnose_recovery, format_report

    path = f"{out_dir}/seed{seed}.npz"
    t0 = time.time()
    rec, _ = main(seed=seed, save_params=path)
    wall = time.time() - t0
    z = np.load(path)
    W, gtW = z["W"], z["gtW"]
    rep = diagnose_recovery(W, gtW)
    missed = [int(a) for a in rep["missed"]]
    # donor availability at the END: re-run the sweep's donor census on the
    # final dictionary (duplicates' weaker halves + dead + junk-wide)
    from prosper_tpu.data.diagnosis import dictionary_stats
    st = dictionary_stats(W)
    donors = set()
    coh, norms = st["coherence"], st["norms"]
    H = W.shape[1]
    for i in range(H):
        for j in range(i + 1, H):
            if coh[i, j] > 0.85:
                donors.add(j if norms[i] >= norms[j] else i)
    donors |= {int(h) for h in
               np.flatnonzero(norms < 0.1 * st["median_norm"])}
    donors |= {int(h) for h in
               np.flatnonzero(st["support"] >= 3.0 * st["median_support"])}

    classes = {}
    for atom, cls in rep["missed_classes"].items():
        if cls == "blend":
            classes[atom] = "post-sweep-blend"
        elif not donors:
            classes[atom] = "missing-no-donor"
        else:
            classes[atom] = "missing"
    row = {"seed": seed, "recovered": rec, "missed": missed,
           "classes": classes, "n_donors_left": len(donors),
           "blend_cols": {int(k): [int(v[0]), int(v[1]),
                                   round(v[2], 3), round(v[3], 3)]
                          for k, v in rep["blends"].items()},
           "wall_s": round(wall, 1)}
    print("[taxonomy] " + json.dumps(row), flush=True)
    print(format_report(rep), flush=True)
    return row


def main():
    rows = [classify_seed(s) for s in SEEDS]
    print("[taxonomy] FINAL " + json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
