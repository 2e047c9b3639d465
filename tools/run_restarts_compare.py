"""Measure run_restarts against the full recovery protocol.

Question: at roughly equal device time, is best-of-k independent restarts
better than ONE run of the full recovery protocol (revival + worst-F
reseed + coact splitting + gamma-5 refinement + blend-split sweep)?  One
seed per call.

Run from the repository root:  python tools/run_restarts_compare.py [seed]

Device-time accounting (patches config): the full protocol
is ~190 iterations of EM work (120 base + 40 refine + ~2x15 polish) plus
host sweeps; best-of-2 restarts at 120 iters with revival-only escapes
gives 240 iterations — slightly MORE device time than the protocol, so a
protocol win is conservative.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(seed=2):
    from examples.patches_scale_run import main as protocol
    from prosper_tpu.engine.em import run_restarts
    from prosper_tpu.data.patches import planted_dictionary
    from prosper_tpu.data.bars import cosine_match
    from prosper_tpu.data.patches import pad_for_mesh
    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.engine.em import EM
    from prosper_tpu.models import BSC

    N, D, H = 1_000_000, 256, 300
    model = BSC(D, H, 8, 4, chunk=8192)
    gt = {"W": planted_dictionary(D, H, seed=seed),
          "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
    data = model.generate_data(gt, N, seed=seed + 1)
    padded = pad_for_mesh(data["y"], n_shards=1, chunk=model.chunk)

    def build_em(i):
        anneal = LinearAnnealing(120)
        anneal["T"] = [(0.0, 2.0), (0.5, 1.0)]
        anneal["W_noise"] = [(0.0, 0.5), (0.5, 0.0)]
        anneal["Ncut_factor"] = [(0.75, 0.0), (0.95, 1.0)]
        return EM(model, anneal, padded, seed=seed + 100 + 17 * i,
                  params=model.standard_init(data, seed=seed + 200 + i),
                  revive_duplicates=(10, 0.85, 0.75, 0.1),
                  reseed_worst_frac=0.02,
                  split_norm_frac=1.5, split_coact=True)

    t0 = time.time()
    best_params, summary = run_restarts(build_em, 2)
    t_restarts = time.time() - t0
    _, cos = cosine_match(np.asarray(best_params["W"]), gt["W"])
    rec_restarts = int((cos > 0.8).sum())
    print(f"[restarts] best-of-2 (240 iters): {rec_restarts}/300 "
          f"F_means={['%.4f' % f for f in summary['F_means']]} "
          f"best={summary['best']} wall={t_restarts:.0f}s", flush=True)

    t0 = time.time()
    rec_protocol, _ = protocol(seed=seed)
    t_protocol = time.time() - t0
    print(f"[restarts] protocol (~190 iters + sweeps): {rec_protocol}/300 "
          f"wall={t_protocol:.0f}s", flush=True)
    print("[restarts] FINAL " + json.dumps({
        "seed": seed, "best_of_2": rec_restarts,
        "protocol": rec_protocol, "wall_restarts_s": round(t_restarts),
        "wall_protocol_s": round(t_protocol)}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
