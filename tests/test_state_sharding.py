"""Enumerated-state-axis sharding (sequence-parallel analogue, SURVEY §5.7).

A ('data','state') mesh splits the multi-state enumeration across devices;
the softmax over the truncated union is combined with online-logsumexp
collectives.  Results must match the single-device step exactly (up to f32
reduction order).
"""

import jax
import numpy as np
import pytest

from prosper_tpu.data.bars import bars_gt_params
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.linear import BSC, TSC
from prosper_tpu.parallel.mesh import MeshRuntime


@pytest.mark.parametrize("cls,seed", [(BSC, 2), (TSC, 3)])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8)])
def test_data_x_state_mesh_equivalence(cls, seed, mesh_shape):
    R = 4
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 4, 256
    model = cls(D, H, Hp, gamma, chunk=N)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, N, seed=seed)

    em1 = EM(model, LinearAnnealing(4), {"y": data["y"]}, seed=7)
    p1 = em1.run()

    rt = MeshRuntime(mesh_shape=mesh_shape, axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(4), {"y": data["y"]}, seed=7, runtime=rt)
    p2 = em2.run()

    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(p1["sigma"]), float(p2["sigma"]),
                               rtol=1e-3)
    F1 = [h["Q_mean"] for h in em1.history]
    F2 = [h["Q_mean"] for h in em2.history]
    np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)


def test_state_shard_count_not_dividing_S():
    """S=62 states over 8 shards (not divisible): padding must be exact."""
    model = BSC(16, 8, 6, 4, chunk=128)   # S = C(6,2)+C(6,3)+C(6,4) = 50
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 128, seed=5)
    em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=(1, 8), axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1, runtime=rt)
    p2 = em2.run()
    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)


def test_state_mesh_with_non_state_model():
    """Models without state-sharding support (mixtures — no enumerated
    state axis) run state-replicated on a ('data','state') mesh instead of
    raising TypeError.  [The ET families all support
    state sharding as of round 2 — see the equivalence tests below.]"""
    from prosper_tpu.models.mixtures import MoG
    from prosper_tpu.engine.em import EM

    model = MoG(D=8, K=4)
    rng = np.random.default_rng(4)
    mus = rng.standard_normal((4, 8)).astype(np.float32) * 4.0
    gt = {"mu": mus, "pi": np.full((4,), 0.25, np.float32),
          "sigma": np.full((4,), 0.5, np.float32)}
    data = model.generate_data(gt, 128, seed=4)
    em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=(4, 2), axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1, runtime=rt)
    p2 = em2.run()
    np.testing.assert_allclose(np.asarray(p1["mu"]), np.asarray(p2["mu"]),
                               rtol=2e-3, atol=2e-3)


def test_state_sharding_big_S_with_padding():
    """State sharding at a scale that needs it:
    TSC H'=10 gamma=5 enumerates S = sum_k C(10,k)*2^k = 12,564 signed
    multi-states; over 8 state shards S pads to 12,568 (S_loc=1571).  The
    online-logsumexp combine and the padded-state slice logic must be exact
    at this real padding ratio, matching the single-device step."""
    model = TSC(36, 12, 10, 5, chunk=32)
    assert model.sa.states.shape[0] == 12564
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    data = model.generate_data(gt, 64, seed=9)

    em1 = EM(model, LinearAnnealing(2), {"y": data["y"]}, seed=3)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=(1, 8), axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(2), {"y": data["y"]}, seed=3, runtime=rt)
    p2 = em2.run()

    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)
    F1 = [h["Q_mean"] for h in em1.history]
    F2 = [h["Q_mean"] for h in em2.history]
    np.testing.assert_allclose(F1, F2, rtol=1e-3)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_sblock_composes_with_state_sharding(mesh_shape):
    """The big-S s_block tiling composes with
    state sharding — each device scans its S/n slice in s_block tiles and
    the (max, mass, moments) are combined across the axis with the same
    online-logsumexp rescale.  Must match the replicated un-tiled step.
    Slice size (ceil(50/n) rounded to s_block multiples) exercises real
    per-shard padding."""
    model = BSC(16, 8, 6, 4, chunk=128)         # S = 50 multi states
    model_blk = BSC(16, 8, 6, 4, chunk=128, s_block=16)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 128, seed=13)

    em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=mesh_shape, axis_names=("data", "state"))
    em2 = EM(model_blk, LinearAnnealing(3), {"y": data["y"]}, seed=1,
             runtime=rt)
    p2 = em2.run()
    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)
    F1 = [h["Q_mean"] for h in em1.history]
    F2 = [h["Q_mean"] for h in em2.history]
    np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_dsc_phi_state_sharding_equivalence(mesh_shape):
    """DSC with a LEARNED value set Phi under a
    ('data','state') mesh.  Phi learning makes the state arrays traced
    functions of params['phi'] (traced_state_arrays), and those traced
    (S, Hp)/(S, Hp^2) tensors flow through the per-shard dynamic state
    slice — the previously-untested interaction.  Must match the
    single-device trajectory, phi updates included."""
    from prosper_tpu.models.linear import DSC

    model = DSC(16, 8, 5, 3, phi=(-1.0, 1.0, 2.0),
                to_learn=("W", "pi", "sigma", "phi"), chunk=64)
    gt = {"W": np.random.default_rng(31).standard_normal(
              (16, 8)).astype(np.float32) * 2.0,
          "pi": np.full((3,), 0.05, np.float32),
          "sigma": np.float32(0.5)}
    data = model.generate_data(gt, 128, seed=32)
    em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=mesh_shape, axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1,
             runtime=rt)
    p2 = em2.run()
    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(p1["phi"]), np.asarray(p2["phi"]),
                               rtol=2e-3, atol=2e-3)
    F1 = [h["Q_mean"] for h in em1.history]
    F2 = [h["Q_mean"] for h in em2.history]
    np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)


def test_mixtures_data_sharding_equivalence():
    """MoG and MoP under a pure data mesh —
    the mixtures have no enumerated state axis, so DP is their whole
    sharding story; the sharded trajectory must match single-device."""
    from prosper_tpu.models.mixtures import MoG, MoP

    rng = np.random.default_rng(41)
    for cls, gt in (
            (MoG, {"mu": rng.standard_normal((4, 8)).astype(np.float32) * 4,
                   "pi": np.full((4,), 0.25, np.float32),
                   "sigma": np.full((4,), 0.5, np.float32)}),
            (MoP, {"lam": (rng.random((4, 8)).astype(np.float32) * 6 + 0.5),
                   "pi": np.full((4,), 0.25, np.float32)})):
        model = cls(D=8, K=4)
        data = model.generate_data(gt, 128, seed=42)
        em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
        p1 = em1.run()
        rt = MeshRuntime(mesh_shape=(8,), axis_names=("data",))
        em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1,
                 runtime=rt)
        p2 = em2.run()
        for k in p1:
            np.testing.assert_allclose(
                np.asarray(p1[k]), np.asarray(p2[k]),
                rtol=2e-3, atol=2e-3, err_msg=f"{cls.__name__} param {k}")
        F1 = [h["Q_mean"] for h in em1.history]
        F2 = [h["Q_mean"] for h in em2.history]
        np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_max_family_state_sharding_equivalence(mesh_shape):
    """MCA/MMCA state sharding (round 2 — closes the 'linear family only'
    partial): sharded shards use the per-state winner loop on their slice;
    combine must match the single-device subset-lattice DP exactly."""
    from prosper_tpu.models.mca import MCA, MMCA

    for cls, seed in ((MCA, 11), (MMCA, 12)):
        model = cls(16, 8, 5, 3, chunk=64)
        gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
        data = model.generate_data(gt, 128, seed=seed)
        em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
        p1 = em1.run()
        rt = MeshRuntime(mesh_shape=mesh_shape,
                         axis_names=("data", "state"))
        em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1,
                 runtime=rt)
        p2 = em2.run()
        np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                                   rtol=2e-3, atol=2e-3)
        F1 = [h["Q_mean"] for h in em1.history]
        F2 = [h["Q_mean"] for h in em2.history]
        np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (1, 8)])
def test_gsc_state_sharding_equivalence(mesh_shape):
    """GSC state sharding: sharded slices take the padded tensor solver
    (the level-grouped path needs the static global level structure);
    results must match the single-device level-grouped step."""
    from prosper_tpu.models.gsc import GSC

    model = GSC(16, 12, 5, 3, chunk=64)
    rng = np.random.default_rng(21)
    gt = {"W": rng.standard_normal((16, 12)).astype(np.float32) * 2.0,
          "pi": np.float32(0.15), "sigma": np.float32(0.5),
          "mu": np.float32(1.0), "psi": np.float32(0.5)}
    data = model.generate_data(gt, 128, seed=22)
    em1 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1)
    p1 = em1.run()
    rt = MeshRuntime(mesh_shape=mesh_shape, axis_names=("data", "state"))
    em2 = EM(model, LinearAnnealing(3), {"y": data["y"]}, seed=1,
             runtime=rt)
    p2 = em2.run()
    np.testing.assert_allclose(np.asarray(p1["W"]), np.asarray(p2["W"]),
                               rtol=2e-3, atol=2e-3)
    F1 = [h["Q_mean"] for h in em1.history]
    F2 = [h["Q_mean"] for h in em2.history]
    np.testing.assert_allclose(F1, F2, rtol=2e-3, atol=2e-3)
