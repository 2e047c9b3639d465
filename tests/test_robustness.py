"""Multi-seed robustness: bars recovery across seeds (the reference's
statistical success criterion — recovery rates, not single runs)."""

import numpy as np
import pytest

from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.linear import BSC


@pytest.mark.parametrize("nothing", [None])
def test_bsc_bars_multiseed(nothing):
    R = 4
    D, H, Hp, gamma, N = R * R, 2 * R, 5, 3, 1000
    full = 0
    seeds = range(6)
    for seed in seeds:
        model = BSC(D, H, Hp, gamma)
        gt = bars_gt_params(model, intensity=10.0, sigma=1.5)
        data = model.generate_data(gt, N, seed=100 + seed)
        a = LinearAnnealing(80)
        a["T"] = [(0.0, 2.0), (0.7, 1.0)]
        a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
        a["Ncut_factor"] = [(0.5, 0.0), (0.9, 1.0)]
        em = EM(model, a, {"y": data["y"]}, seed=seed)
        p = em.run()
        rec = count_recovered_bars(np.asarray(p["W"]), np.asarray(gt["W"]),
                                   threshold=0.85)
        full += int(rec == H)
    assert full >= 5, f"all-bars recovery in only {full}/6 seeds"


def test_em_pads_non_chunk_multiple_library_path():
    """EM(model, anneal, {"y": y}) with N not a
    multiple of the chunk must pad with valid=0 rows internally (like the
    CLI always has) and produce EXACTLY the padded-by-hand trajectory."""
    from prosper_tpu.data.patches import pad_for_mesh

    rng = np.random.default_rng(17)
    N, D = 500, 16
    model = BSC(D, 8, 5, 3, chunk=128)       # 500 % 128 != 0
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    y = model.generate_data(gt, N, seed=3)["y"]

    def sched():
        a = LinearAnnealing(5)
        a["T"] = [(0.0, 2.0), (0.7, 1.0)]
        a["Ncut_factor"] = [(0.0, 0.0), (0.5, 0.0), (0.9, 1.0)]
        return a

    em1 = EM(model, sched(), {"y": y}, seed=5)
    assert em1.data["y"].shape[0] == 512     # padded internally
    p1 = em1.run()

    em2 = EM(model, sched(), pad_for_mesh(np.asarray(y), 1, 128), seed=5)
    p2 = em2.run()
    np.testing.assert_array_equal(np.asarray(p1["W"]), np.asarray(p2["W"]))
    F1 = [h["F_mean"] for h in em1.history]
    F2 = [h["F_mean"] for h in em2.history]
    np.testing.assert_array_equal(F1, F2)


def test_em_pads_for_mesh_shards():
    """Library-path padding also rounds to the mesh shard count."""
    from prosper_tpu.parallel.mesh import MeshRuntime

    model = BSC(16, 8, 5, 3, chunk=64)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    y = model.generate_data(gt, 300, seed=4)["y"]   # 300 % 8 != 0
    rt = MeshRuntime(mesh_shape=(8,), axis_names=("data",))
    em = EM(model, LinearAnnealing(3), {"y": y}, seed=1, runtime=rt)
    p = em.run()
    assert em.data["y"].shape[0] % 8 == 0
    assert np.isfinite(float(em.history[-1]["F_mean"]))
