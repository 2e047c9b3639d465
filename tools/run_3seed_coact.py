"""3-seed patches-scale run with support-size coact blend splitting.

Does co-activation-guided splitting with the support-size detector move
recovery past the plateau of the revival-only protocol?  Protocol: 120
iters + gamma=5 refinement, revival 0.85 + worst-F reseeding, plus
split_coact.

Run from the repository root:  python tools/run_3seed_coact.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.patches_scale_run import main

results = {}
for seed in (0, 1, 2):
    t0 = time.time()
    rec, per_iter = main(seed=seed, split_norm_frac=1.5, split_coact=True,
                         refine_gamma=5)
    results[seed] = rec
    print(f"[3seed] seed={seed} recovered={rec}/300 "
          f"({time.time()-t0:.0f}s)", flush=True)
print("[3seed] FINAL " + json.dumps(results), flush=True)
