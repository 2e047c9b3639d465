"""Worker process for the real multi-process test (tests/test_multiprocess.py).

Reference behavior: SURVEY.md §5.8 — the reference runs under ``mpirun -n P``
with mpi4py; every rank loads its own data stride, allreduces sufficient
statistics, and only rank 0 writes output files.  This worker is the JAX
multi-controller analogue: ``jax.distributed.initialize`` against a local
coordinator, per-process ``stride_data`` shard loading, a cross-process
device mesh with gloo collectives, and rank-0-only DataLog/H5 output.

Launched by the test as:  python multiproc_worker.py RANK NPROCS PORT WORKDIR
(not collected by pytest — the filename does not start with ``test_``).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")


def main(rank: int, nprocs: int, port: int, workdir: str,
         mode: str = "basic") -> None:
    from prosper_tpu.parallel.mesh import init_multihost, stride_data

    if nprocs > 1:
        # MUST precede any backend touch (jax.devices(), jnp ops, ...)
        init_multihost(f"127.0.0.1:{port}", nprocs, rank)
    assert jax.process_count() == nprocs, (jax.process_count(), nprocs)
    assert jax.process_index() == rank

    import numpy as np

    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.engine.em import EM
    from prosper_tpu.io.datalog import DataLog, StoreToH5
    from prosper_tpu.models.linear import BSC
    from prosper_tpu.parallel.mesh import MeshRuntime

    wd = Path(workdir)
    y = np.load(wd / "y.npy")  # full dataset on disk; each rank slices
    first, last = stride_data(y.shape[0])
    y_local = np.ascontiguousarray(y[first:last])
    n_local = y_local.shape[0]

    p0 = np.load(wd / "params0.npz")
    params0 = {k: p0[k] for k in p0.files}
    D = y.shape[1]
    H = params0["W"].shape[1]

    model = BSC(D, H, Hprime=4, gamma=3)

    def make_anneal():
        anneal = LinearAnnealing(12)
        anneal["T"] = [(0.0, 1.5), (0.6, 1.0)]
        anneal["anneal_prior"] = False
        if mode in ("revive_resume", "stream"):
            # exercise the Ncut mask (F_prev-dependent) across the resume /
            # the streamed global-threshold reduction
            anneal["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]
        return anneal

    rt = MeshRuntime()  # all devices across all processes, axis 'data'

    def make_data():
        return {
            "y": y_local.astype(np.float32),
            "valid": np.ones((n_local,), np.float32),
            "F_prev": np.zeros((n_local,), np.float32),
        }

    if mode == "stream":
        # multi-process STREAMING — each process
        # streams its own stride_data host shard segment-by-segment in
        # lockstep over the cross-process mesh (engine/stream.py module
        # docstring).  Three equivalences are produced for the test:
        #   final_stream_p{P}   — P-process streamed run
        #   final_em_p{P}       — P-process IN-MEMORY EM, same mesh/seed
        #   final_stream_resumed_p{P} — checkpoint-interrupted + resumed
        from prosper_tpu.engine.stream import StreamingEM

        model_s = BSC(D, H, Hprime=4, gamma=3, chunk=32)

        def run_stream(**kw):
            sem = StreamingEM(model_s, make_anneal(), y_local.astype(
                np.float32), seg_size=128, params=dict(params0),
                seed=5, runtime=rt, **kw)
            return sem

        sem_a = run_stream()
        n_seg = sem_a.n_seg
        sem_a.run()
        if jax.process_index() == 0:
            np.savez(wd / f"final_stream_p{nprocs}.npz",
                     **{k: np.asarray(jax.device_get(v))
                        for k, v in sem_a.params.items()})

        em = EM(model_s, make_anneal(), make_data(), params=dict(params0),
                runtime=rt, seed=5)
        em.run()
        if jax.process_index() == 0:
            np.savez(wd / f"final_em_p{nprocs}.npz",
                     **{k: np.asarray(jax.device_get(v))
                        for k, v in em.params.items()})

        # interrupted at 7 with a checkpoint at 5, then resumed: must
        # replay the uninterrupted streamed trajectory exactly (rank-0
        # checkpoint IO; global stride-ordered F_prev payload)
        ckpt = str(wd / f"stream_ckpt_p{nprocs}.h5")
        sem_b = run_stream(checkpoint_path=ckpt, checkpoint_every=5)
        for _ in range(7):
            sem_b.step_once()
        sem_c = run_stream()
        step = sem_c.resume(ckpt)
        assert step == 5, step
        sem_c.run()
        if jax.process_index() == 0:
            np.savez(wd / f"final_stream_resumed_p{nprocs}.npz",
                     **{k: np.asarray(jax.device_get(v))
                        for k, v in sem_c.params.items()})
        (wd / f"done_r{rank}.txt").write_text(
            f"proc={jax.process_index()}/{jax.process_count()} "
            f"devices={len(jax.devices())} local={len(jax.local_devices())} "
            f"n_seg={n_seg}\n")
        return

    if mode == "revive_resume":
        # Multi-host revival (rank-0-computed, broadcast)
        # + F_prev checkpointing (process_allgather) must make a resumed
        # multi-process run trajectory-exact vs the uninterrupted one.
        revive = (3, 0.2, 0.9, 0.0)  # low threshold so revival definitely fires
        kw = dict(runtime=rt, seed=5, revive_duplicates=revive,
                  reseed_worst_frac=0.1)
        # uninterrupted 12-iteration run
        em_a = EM(model, make_anneal(), make_data(), params=dict(params0),
                  **kw)
        em_a.run()
        if jax.process_index() == 0:
            np.savez(wd / "final_full.npz",
                     **{k: np.asarray(jax.device_get(v))
                        for k, v in em_a.params.items()})
        # interrupted run: checkpoint every 5, stop after 7 iterations
        ckpt = str(wd / "ckpt.h5")
        em_b = EM(model, make_anneal(), make_data(), params=dict(params0),
                  checkpoint_path=ckpt, checkpoint_every=5, **kw)
        for _ in range(7):
            em_b.step_once()
        # resume from the checkpoint (the cli.py --resume wiring, inline)
        from prosper_tpu.io import checkpoint
        params_r, step, rng_r, extra = checkpoint.restore_full(ckpt)
        anneal_r = make_anneal()
        anneal_r.reset(step)
        data_r = make_data()
        assert "F_prev" in extra, "multi-host checkpoint must carry F_prev"
        data_r["F_prev"] = np.ascontiguousarray(
            extra["F_prev"][first:last]).astype(np.float32)
        em_c = EM(model, anneal_r, data_r, params=params_r, **kw)
        em_c.rng = rng_r
        em_c.restore_revival_rng(extra["revive_rng"])
        em_c._last_revive = int(extra["revive_last"])
        em_c.run()
        if jax.process_index() == 0:
            np.savez(wd / "final_resumed.npz",
                     **{k: np.asarray(jax.device_get(v))
                        for k, v in em_c.params.items()})
        (wd / f"done_r{rank}.txt").write_text(
            f"proc={jax.process_index()}/{jax.process_count()} "
            f"revived={em_a.revival_stats['revived']}\n")
        return

    data = make_data()
    log = DataLog()
    log.set_handler(("F_mean", "n_used"), StoreToH5, str(wd / "result.h5"))

    em = EM(model, make_anneal(), data, params=params0, runtime=rt,
            dlog=log, seed=5)
    em.run()
    log.close()

    if jax.process_index() == 0:
        np.savez(wd / f"final_p{nprocs}.npz",
                 **{k: np.asarray(jax.device_get(v))
                    for k, v in em.params.items()})
    # every rank reports its view of which files it (should have) written
    (wd / f"done_r{rank}.txt").write_text(
        f"proc={jax.process_index()}/{jax.process_count()} "
        f"devices={len(jax.devices())} local={len(jax.local_devices())}\n")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5] if len(sys.argv) > 5 else "basic")
