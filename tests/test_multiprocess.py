"""Real multi-process execution test.

Reference behavior: SURVEY.md §5.8 + §4 "P=1 vs P=4 mpirun equivalence" —
the reference's MPI backend is exercised by running the same config under
different process counts and asserting identical learned parameters.

Here two OS processes connect through ``jax.distributed`` (gloo CPU
collectives, 2 virtual devices each -> one 4-device global mesh), each
loads only its ``stride_data`` slice of the dataset from disk, and EM runs
under ``shard_map`` across the cross-process mesh.  Asserts:

* the 2-process run matches a 1-process run of the same config
  (allreduce/psum reduction-order tolerance only),
* only rank 0 wrote the DataLog H5 and the final-parameter files,
* multi-process code paths (init_multihost explicit args, per-process
  shard loading, make_array_from_process_local_data) actually execute.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

WORKER = str(Path(__file__).resolve().parent / "multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def _launch(rank: int, nprocs: int, port: int, wd: Path):
    return subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(nprocs), str(port), str(wd)],
        env=_worker_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _write_inputs(wd: Path, seed=0):
    rng = np.random.default_rng(seed)
    D, H, N = 16, 8, 512
    W0 = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    np.save(wd / "y.npy", y)
    np.savez(wd / "params0.npz", W=W0,
             pi=np.float32(0.2), sigma=np.float32(1.5))


import pytest


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_process_equivalence(tmp_path, nprocs):
    """P-process run must match the P=1 run (extends the
    round-2 two-process test to four — SURVEY §4's 'P=1 vs P=4 mpirun
    equivalence' at its literal process count)."""
    wdp = tmp_path / f"p{nprocs}"
    wd1 = tmp_path / "p1"
    wdp.mkdir()
    wd1.mkdir()
    _write_inputs(wdp)
    _write_inputs(wd1)

    port = _free_port()
    procs = [_launch(r, nprocs, port, wdp) for r in range(nprocs)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank {procs.index(p)} failed:\n{out}"

    p1 = _launch(0, 1, port, wd1)
    out1 = p1.communicate(timeout=420)[0]
    assert p1.returncode == 0, f"single-process run failed:\n{out1}"

    # every rank ran its multi-process paths
    for r in range(nprocs):
        done = wdp / f"done_r{r}.txt"
        assert done.exists()
        assert f"proc={r}/{nprocs}" in done.read_text()
    assert (f"devices={2 * nprocs} local=2"
            in (wdp / "done_r0.txt").read_text())

    # rank-0-only IO: final params + DataLog H5 written exactly once
    assert (wdp / f"final_p{nprocs}.npz").exists()
    assert (wdp / "result.h5").exists()

    import h5py
    with h5py.File(wdp / "result.h5", "r") as f:
        assert f["F_mean"].shape[0] == 12  # one row per EM iteration

    # P=n matches P=1 up to collective reduction order
    fp = np.load(wdp / f"final_p{nprocs}.npz")
    f1 = np.load(wd1 / "final_p1.npz")
    assert set(fp.files) == set(f1.files)
    for k in f1.files:
        np.testing.assert_allclose(fp[k], f1[k], rtol=2e-4, atol=2e-5,
                                   err_msg=f"param {k} diverged P={nprocs} vs P=1")


def _launch_mode(rank, nprocs, port, wd, mode):
    return subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(nprocs), str(port),
         str(wd), mode],
        env=_worker_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_multiprocess_streaming_equivalence(tmp_path):
    """Multi-process STREAMING — each process
    streams its own stride_data host shard; the 2-process streamed run must
    match (a) the 1-process streamed run and (b) the 2-process in-memory EM
    on the same mesh (collective reduction-order tolerance), and a
    checkpoint-interrupted 2-process streamed run must resume
    trajectory-exactly.  Ncut is active (exercises the cross-process
    host-threshold reduction) and n_seg > 1 (multi-segment lockstep)."""
    wd2 = tmp_path / "p2"
    wd1 = tmp_path / "p1"
    wd2.mkdir()
    wd1.mkdir()
    _write_inputs(wd2, seed=7)
    _write_inputs(wd1, seed=7)

    port = _free_port()
    procs = [_launch_mode(r, 2, port, wd2, "stream") for r in range(2)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank {procs.index(p)} failed:\n{out}"

    p1 = _launch_mode(0, 1, _free_port(), wd1, "stream")
    out1 = p1.communicate(timeout=420)[0]
    assert p1.returncode == 0, f"single-process run failed:\n{out1}"

    # multi-segment lockstep actually exercised on every rank
    for r in range(2):
        done = (wd2 / f"done_r{r}.txt").read_text()
        assert "proc=" in done and "n_seg=2" in done, done
    assert "n_seg=4" in (wd1 / "done_r0.txt").read_text()

    s2 = np.load(wd2 / "final_stream_p2.npz")
    s1 = np.load(wd1 / "final_stream_p1.npz")
    e2 = np.load(wd2 / "final_em_p2.npz")
    r2 = np.load(wd2 / "final_stream_resumed_p2.npz")
    assert set(s2.files) == set(s1.files) == set(e2.files)
    for k in s1.files:
        np.testing.assert_allclose(
            s2[k], s1[k], rtol=2e-4, atol=2e-5,
            err_msg=f"param {k}: streamed P=2 vs P=1 diverged")
        np.testing.assert_allclose(
            s2[k], e2[k], rtol=2e-4, atol=2e-5,
            err_msg=f"param {k}: streamed vs in-memory EM (P=2) diverged")
        np.testing.assert_allclose(
            r2[k], s2[k], rtol=1e-5, atol=1e-5,
            err_msg=f"param {k}: resumed streamed != uninterrupted")


def test_multihost_revival_and_resume_equivalence(tmp_path):
    """Multi-host revival (rank-0 sample, broadcast) and
    F_prev checkpointing (process_allgather) make a resumed 2-process run
    trajectory-exact vs the uninterrupted one, revivals included."""
    wd = tmp_path / "rr"
    wd.mkdir()
    _write_inputs(wd, seed=3)
    port = _free_port()
    procs = [_launch_mode(r, 2, port, wd, "revive_resume") for r in range(2)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank {procs.index(p)} failed:\n{out}"

    # the equivalence must not be vacuous: revival actually fired
    done0 = (wd / "done_r0.txt").read_text()
    revived = int(done0.split("revived=")[1])
    assert revived > 0, f"revival never fired (vacuous test): {done0}"

    full = np.load(wd / "final_full.npz")
    res = np.load(wd / "final_resumed.npz")
    assert set(full.files) == set(res.files)
    for k in full.files:
        np.testing.assert_allclose(res[k], full[k], rtol=1e-5, atol=1e-5,
                                   err_msg=f"param {k}: resumed != full")
