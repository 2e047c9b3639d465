"""Checkpoint -> restore -> continue equivalence (SURVEY.md §5.4).

The reference's implicit property: restarting from the last logged params
reproduces the rest of the run.  Here the explicit checkpoint carries
(params, step, rng, F_prev), so a resumed run must match the uninterrupted
trajectory exactly (revival off) — including with Ncut active, since F_prev
(the Ncut ranking input) rides in the checkpoint.
"""

import numpy as np
import pytest

from prosper_tpu.data.bars import bars_gt_params
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.io import checkpoint
from prosper_tpu.models.linear import BSC


def _anneal(steps=20):
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 1.5), (0.6, 1.0)]
    a["W_noise"] = [(0.0, 0.5), (0.6, 0.0)]        # rng-dependent channel
    a["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]  # F_prev-dependent
    return a


def _fixture():
    model = BSC(25, 10, 6, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    data = model.generate_data(gt, 400, seed=11)
    return model, {"y": data["y"]}


def test_resume_equivalence_python_loop(tmp_path):
    model, data = _fixture()
    steps, cut = 20, 10
    ckpt = str(tmp_path / "c.h5")

    # uninterrupted
    em1 = EM(model, _anneal(steps), dict(data), seed=5)
    params1 = em1.run()

    # interrupted at `cut`, checkpointed, resumed into a FRESH EM with a
    # different seed (must not matter: rng comes from the checkpoint)
    em2 = EM(model, _anneal(steps), dict(data), seed=5,
             checkpoint_path=ckpt, checkpoint_every=cut)
    for _ in range(cut):
        em2.step_once()
    del em2

    params_r, step, rng, extra = checkpoint.restore_full(ckpt)
    assert step == cut and rng is not None and "F_prev" in extra

    anneal3 = _anneal(steps)
    anneal3.reset(step)
    data3 = dict(data, F_prev=extra["F_prev"],
                 valid=np.ones(extra["F_prev"].shape[0], np.float32))
    em3 = EM(model, anneal3, data3, params=params_r, seed=999)
    em3.rng = rng
    params3 = em3.run()

    for k in params1:
        np.testing.assert_allclose(np.asarray(params3[k]),
                                   np.asarray(params1[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # trajectory scalars match too (second half)
    F1 = [h["F_mean"] for h in em1.history[cut:]]
    F3 = [h["F_mean"] for h in em3.history]
    np.testing.assert_allclose(F3, F1, rtol=1e-5, atol=1e-5)


def test_resume_equivalence_scanned(tmp_path):
    """run_scanned uses the same rng chain as step_once, so mixing the two
    across a resume must also be trajectory-exact."""
    model, data = _fixture()
    steps, cut = 16, 8
    ckpt = str(tmp_path / "c.h5")

    em1 = EM(model, _anneal(steps), dict(data), seed=5)
    em1.run_scanned()
    params1 = em1.params

    em2 = EM(model, _anneal(steps), dict(data), seed=5,
             checkpoint_path=ckpt, checkpoint_every=cut)
    em2.run_scanned(cut)

    params_r, step, rng, extra = checkpoint.restore_full(ckpt)
    anneal3 = _anneal(steps)
    anneal3.reset(step)
    data3 = dict(data, F_prev=extra["F_prev"],
                 valid=np.ones(extra["F_prev"].shape[0], np.float32))
    em3 = EM(model, anneal3, data3, params=params_r, seed=0)
    em3.rng = rng
    em3.run_scanned()

    for k in params1:
        np.testing.assert_allclose(np.asarray(em3.params[k]),
                                   np.asarray(params1[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_scanned_checkpoint_cadence_with_unequal_periods(tmp_path, monkeypatch):
    """With checkpoint_every=6 and revival every=4, scan segments
    end at multiples of 4 — checkpoints must still fire at every boundary
    crossing (~6), not only at common multiples (12, 24, ...)."""
    saves = []
    real_save = checkpoint.save

    def spy(path, params, step, rng=None, extra=None):
        saves.append(step)
        real_save(path, params, step=step, rng=rng, extra=extra)

    monkeypatch.setattr(checkpoint, "save", spy)

    model, data = _fixture()
    em = EM(model, _anneal(24), dict(data), seed=5,
            checkpoint_path=str(tmp_path / "c.h5"), checkpoint_every=6,
            revive_duplicates=(4, 0.99))
    em.run_scanned()
    # segments end at 4, 8, 12, 16, 20, 24 -> crossings of 6: 8, 16, 24
    assert saves == [8, 16, 24], saves


def test_cli_truncate_logs(tmp_path):
    """Resume rewinds result.h5 / metrics.jsonl to the checkpoint
    step so appended rows are not duplicated."""
    import h5py

    from prosper_tpu.cli import _truncate_logs

    out = str(tmp_path)
    with h5py.File(tmp_path / "result.h5", "w") as f:
        for name, rows, shape in [("F_mean", 17, ()), ("pi", 17, ()),
                                  ("W", 9, (3, 2))]:
            f.create_dataset(name, shape=(rows,) + shape,
                             maxshape=(None,) + shape,
                             chunks=(1,) + shape if shape else (64,))
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for i in range(17):
            f.write('{"it": %d}\n' % i)

    _truncate_logs(out, step=10, log_params_every=2)

    with h5py.File(tmp_path / "result.h5") as f:
        assert f["F_mean"].shape[0] == 10
        assert f["pi"].shape[0] == 10
        assert f["W"].shape[0] == 5          # iterations 0,2,4,6,8
    assert sum(1 for _ in open(tmp_path / "metrics.jsonl")) == 10


def test_resume_equivalence_with_revival(tmp_path):
    """Revival fires BEFORE the checkpoint and its PCG64 state rides in the
    checkpoint, so a resumed run replays the identical trajectory even with
    revival active."""
    model, data = _fixture()
    steps, cut = 20, 10
    ckpt = str(tmp_path / "c.h5")
    revive = (5, 0.50, 1.0)        # aggressive: fires at 5, 10, 15, ...

    em1 = EM(model, _anneal(steps), dict(data), seed=5,
             revive_duplicates=revive)
    params1 = em1.run()

    em2 = EM(model, _anneal(steps), dict(data), seed=5,
             checkpoint_path=ckpt, checkpoint_every=cut,
             revive_duplicates=revive)
    for _ in range(cut):
        em2.step_once()
    del em2

    params_r, step, rng, extra = checkpoint.restore_full(ckpt)
    assert "revive_rng" in extra
    # the test has teeth only if revival actually drew before the cut
    fresh = EM(model, _anneal(steps), dict(data), seed=5,
               revive_duplicates=revive)
    assert not np.array_equal(extra["revive_rng"], fresh.revival_rng_state())

    anneal3 = _anneal(steps)
    anneal3.reset(step)
    data3 = dict(data, F_prev=extra["F_prev"],
                 valid=np.ones(extra["F_prev"].shape[0], np.float32))
    em3 = EM(model, anneal3, data3, params=params_r, seed=999,
             revive_duplicates=revive)
    em3.rng = rng
    em3.restore_revival_rng(extra["revive_rng"])
    params3 = em3.run()

    for k in params1:
        np.testing.assert_allclose(np.asarray(params3[k]),
                                   np.asarray(params1[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_run_scanned_collect_params_matches_python_loop(tmp_path):
    """collect_params=True restores the reference's per-iteration W history
    under the scanned driver."""
    import h5py

    from prosper_tpu.io.datalog import DataLog, StoreToH5

    model, data = _fixture()

    def make_log(name):
        log = DataLog()
        log.set_handler(("W", "pi", "F_mean"), StoreToH5,
                        str(tmp_path / name))
        return log

    log1 = make_log("loop.h5")
    em1 = EM(model, _anneal(12), dict(data), seed=5, dlog=log1,
             log_params_every=3)
    em1.run()
    log1.close()

    log2 = make_log("scan.h5")
    em2 = EM(model, _anneal(12), dict(data), seed=5, dlog=log2,
             log_params_every=3)
    em2.run_scanned(collect_params=True)
    log2.close()

    with h5py.File(tmp_path / "loop.h5") as f1, \
            h5py.File(tmp_path / "scan.h5") as f2:
        assert f2["W"].shape == f1["W"].shape        # same thinning
        np.testing.assert_allclose(np.asarray(f2["W"]), np.asarray(f1["W"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(f2["pi"]),
                                   np.asarray(f1["pi"]), rtol=1e-6)
        assert f2["F_mean"].shape[0] == 12


def test_resume_revival_cadence_misaligned(tmp_path):
    """A checkpoint step NOT aligned with the revival period must not shift
    later revivals: the last-fired iteration rides in the checkpoint
    (extra['revive_last'], review r2)."""
    model, data = _fixture()
    steps = 20
    ckpt = str(tmp_path / "c.h5")
    revive = (6, 0.50, 1.0)        # fires at 6, 12, 18
    cut = 8                        # checkpoint at 8 — between firings

    em1 = EM(model, _anneal(steps), dict(data), seed=5,
             revive_duplicates=revive)
    params1 = em1.run()

    em2 = EM(model, _anneal(steps), dict(data), seed=5,
             checkpoint_path=ckpt, checkpoint_every=cut,
             revive_duplicates=revive)
    for _ in range(cut):
        em2.step_once()
    del em2

    params_r, step, rng, extra = checkpoint.restore_full(ckpt)
    assert step == cut
    assert int(extra["revive_last"]) == 6     # last firing before the cut

    anneal3 = _anneal(steps)
    anneal3.reset(step)
    data3 = dict(data, F_prev=extra["F_prev"],
                 valid=np.ones(extra["F_prev"].shape[0], np.float32))
    em3 = EM(model, anneal3, data3, params=params_r, seed=999,
             revive_duplicates=revive)
    em3.rng = rng
    em3.restore_revival_rng(extra["revive_rng"])
    em3._last_revive = int(extra["revive_last"])
    params3 = em3.run()

    for k in params1:
        np.testing.assert_allclose(np.asarray(params3[k]),
                                   np.asarray(params1[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
