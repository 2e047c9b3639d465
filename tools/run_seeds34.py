"""Seeds 3-4 of the patches-scale recovery run, default protocol (rounds
out the 3-seed coact-split sweep to 5 seeds).

Run from the repository root:  python tools/run_seeds34.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.patches_scale_run import main

results = {}
for seed in (3, 4):
    t0 = time.time()
    rec, per_iter = main(seed=seed)
    results[seed] = rec
    print(f"[seeds34] seed={seed} recovered={rec}/300 "
          f"({time.time()-t0:.0f}s)", flush=True)
print("[seeds34] FINAL " + json.dumps(results), flush=True)
