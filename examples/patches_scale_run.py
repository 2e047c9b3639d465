"""Patches-scale end-to-end run — BASELINE.json configs[4].

D = 16x16 = 256, H = 300, N = 1e6 datapoints, planted sparse dictionary:
generate data from the BSC model itself (the scaled analogue of the bars
test) and verify that EM recovers the dictionary at scale.

Run (one GPU):   python examples/patches_scale_run.py
"""

import time

import numpy as np

from prosper_tpu.data.bars import cosine_match
from prosper_tpu.data.patches import planted_dictionary
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models import BSC


def main(N=1_000_000, D=256, H=300, Hp=8, gamma=4, iters=120, seed=0,
         scanned=True, revive=(10, 0.85, 0.75, 0.1),
         reseed_worst_frac=0.02, refine_gamma=5, refine_iters=40,
         split_norm_frac=1.5, split_coact=True, save_params=None,
         final_split_sweeps=2, polish_iters=15):
    # defaults = the best recovery protocol found so far: revival with a
    # 0.85 duplicate threshold, worst-F re-seeding, support-size-guided
    # co-activation blend splitting, a gamma=5 warm-start refinement and
    # offline blend-split sweeps
    from prosper_tpu.data.patches import pad_for_mesh

    model = BSC(D, H, Hp, gamma, chunk=8192)
    gt = {"W": planted_dictionary(D, H, seed=seed),
          "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}

    t0 = time.time()
    data = model.generate_data(gt, N, seed=seed + 1)
    print(f"[patches] generated {N} datapoints in {time.time()-t0:.1f}s",
          flush=True)
    padded = pad_for_mesh(data["y"], n_shards=1, chunk=model.chunk)

    anneal = LinearAnnealing(iters)
    anneal["T"] = [(0.0, 2.0), (0.5, 1.0)]
    anneal["W_noise"] = [(0.0, 0.5), (0.5, 0.0)]
    anneal["Ncut_factor"] = [(0.75, 0.0), (0.95, 1.0)]

    em = EM(model, anneal, padded, seed=seed + 2,
            params=model.standard_init(data, seed=seed + 3),
            revive_duplicates=revive,
            reseed_worst_frac=reseed_worst_frac,
            split_norm_frac=split_norm_frac, split_coact=split_coact)
    t0 = time.time()
    params = em.run_scanned() if scanned else em.run(verbose=False)
    wall = time.time() - t0
    per_iter = np.mean([h["dt"] for h in em.history[2:]])

    _, cosines = cosine_match(np.asarray(params["W"]), gt["W"])
    rec = int((cosines > 0.8).sum())
    print(f"[patches] {iters} iters in {wall:.1f}s "
          f"({per_iter*1e3:.0f} ms/iter, "
          f"{N/per_iter/1e6:.1f} M dp/s); recovered {rec}/{H} columns; "
          f"sigma={float(params['sigma']):.3f} pi={float(params['pi']):.4f}; "
          f"revival={em.revival_stats}")

    if refine_gamma > gamma:
        # warm-start refinement with a deeper enumeration: columns that
        # converged to a *blend* of two atoms need >gamma active causes to
        # be explained apart; params are plain dicts, so they transfer
        # across models with a different (static) state space directly
        model2 = BSC(D, H, Hp, refine_gamma, chunk=model.chunk)
        anneal2 = LinearAnnealing(refine_iters)
        anneal2["T"] = 1.0
        em2 = EM(model2, anneal2, padded, seed=seed + 4, params=params,
                 revive_duplicates=revive,
                 reseed_worst_frac=reseed_worst_frac,
                 split_norm_frac=split_norm_frac, split_coact=split_coact)
        params = em2.run_scanned() if scanned else em2.run(verbose=False)
        _, cosines = cosine_match(np.asarray(params["W"]), gt["W"])
        rec = int((cosines > 0.8).sum())
        print(f"[patches] gamma={refine_gamma} refinement "
              f"({refine_iters} iters): recovered {rec}/{H} columns; "
              f"revival={em2.revival_stats}")

    # the residual misses are BLEND columns that the online splitter never
    # reaches (it only fires when revival frees a column; at convergence
    # blends outnumber freed columns).
    # The offline sweep splits every diagnosed blend into (blend col,
    # donor col) directly — donors = weaker duplicates + dead + junk-wide
    # columns — then a short warm-start polish snaps the halves onto atoms
    # and surfaces fresh duplicates, which the NEXT sweep converts into
    # donors; iterate until no splits fire.
    if final_split_sweeps:
        import jax.numpy as jnp
        from prosper_tpu.data.diagnosis import split_blend_sweep

        stride = max(1, N // 65536)
        Ysample = np.asarray(data["y"][::stride][:65536], np.float64)
        pmodel = BSC(D, H, Hp, max(refine_gamma, gamma), chunk=model.chunk)
        for it in range(final_split_sweeps):
            out = split_blend_sweep(np.asarray(params["W"]), Ysample)
            if not out["splits"]:
                print(f"[patches] split sweep {it}: no blends left")
                break
            params = dict(params, W=jnp.asarray(out["W"]))
            anneal3 = LinearAnnealing(polish_iters)
            anneal3["T"] = 1.0
            em3 = EM(pmodel, anneal3, padded, seed=seed + 5 + it,
                     params=params, revive_duplicates=revive,
                     reseed_worst_frac=reseed_worst_frac,
                     split_norm_frac=split_norm_frac,
                     split_coact=split_coact)
            params = em3.run_scanned() if scanned else em3.run()
            _, cosines = cosine_match(np.asarray(params["W"]), gt["W"])
            rec = int((cosines > 0.8).sum())
            print(f"[patches] split sweep {it}: "
                  f"{len(out['splits'])} splits + {polish_iters}-iter "
                  f"polish -> recovered {rec}/{H}", flush=True)
    if save_params:
        np.savez(save_params, W=np.asarray(params["W"]), gtW=gt["W"],
                 cosines=cosines)
        print(f"[patches] saved params -> {save_params}")
    return rec, per_iter


if __name__ == "__main__":
    main()
