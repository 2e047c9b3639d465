"""Same-iteration Ncut semantics.

Reference behavior: SURVEY.md §3.1 — ``select_partial_data`` ranks the ET
data cut by the free energies of the *current* iteration.  This build's
default is a documented one-iteration-lag deviation; ``ncut_current=True``
restores reference semantics with a second E-step pass while the cut is
active.  The defining property tested here: a ``ncut_current`` step from
params p equals a default-mode step from p whose ``F_prev`` was set to the
current iteration's F (computed with the same params).
"""

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.base import make_blank_data
from prosper_tpu.models.linear import BSC


def _sched(ncut=0.0):
    z = jnp.float32
    return {"beta": z(1.0), "prior_beta": z(1.0), "Ncut_factor": z(ncut),
            "partial": z(1.0), "W_noise": z(0.0), "pi_noise": z(0.0),
            "sigma_noise": z(0.0), "mu_noise": z(0.0), "rho": z(0.0)}


def test_ncut_current_equals_lagged_with_true_F():
    R = 4
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 3, 512
    m_cur = BSC(D, H, Hp, gamma, chunk=N, ncut_current=True)
    m_lag = BSC(D, H, Hp, gamma, chunk=N)
    gt = bars_gt_params(m_cur, intensity=10.0, sigma=2.0)
    data_np = m_cur.generate_data(gt, N, seed=0)
    data = make_blank_data(data_np["y"])        # F_prev = zeros (fresh start)
    params = m_cur.standard_init(data_np, seed=1)
    rng = jax.random.PRNGKey(7)

    # current-iteration F (mask-independent), from an uncut step
    _, F_cur, _ = m_lag.jit_step()(params, data, _sched(0.0), rng)

    p_cur, F1, s_cur = m_cur.jit_step()(params, data, _sched(1.0), rng)
    data_oracle = dict(data, F_prev=F_cur)
    p_lag, F2, s_lag = m_lag.jit_step()(params, data_oracle, _sched(1.0), rng)

    # defining property: identical cut -> identical stats -> identical step
    assert float(s_cur["n_used"]) == float(s_lag["n_used"])
    np.testing.assert_allclose(np.asarray(p_cur["W"]), np.asarray(p_lag["W"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(p_cur["sigma"]), float(p_lag["sigma"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(F1), np.asarray(F2))

    # the fresh-start pathology the lagged mode cannot avoid: ranking by the
    # all-zero F_prev keeps everything, ranking by real F cuts properly
    _, _, s_fresh_lag = m_lag.jit_step()(params, data, _sched(1.0), rng)
    assert float(s_fresh_lag["n_used"]) == N
    assert float(s_cur["n_used"]) < N


def test_ncut_current_bars_recovery():
    """End-to-end: reference-semantics mode still learns all bars."""
    R = 5
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 3, 1000
    model = BSC(D, H, Hp, gamma, ncut_current=True)
    gt = bars_gt_params(model, intensity=10.0, sigma=2.0)
    data = model.generate_data(gt, N, seed=11)

    anneal = LinearAnnealing(60)
    anneal["T"] = [(0.0, 2.0), (0.7, 1.0)]
    anneal["Ncut_factor"] = [(0.0, 0.0), (0.5, 0.0), (0.9, 1.0)]
    anneal["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    em = EM(model, anneal, {"y": data["y"]}, seed=5)
    params = em.run()
    n_rec = count_recovered_bars(np.asarray(params["W"]),
                                 np.asarray(gt["W"]), threshold=0.85)
    assert n_rec == H, f"recovered only {n_rec}/{H} bars with ncut_current"


def test_ncut_current_max_and_gsc_families():
    """The same defining property holds for MCA and GSC (the
    deviation's 'GSC/MCA/MMCA keep the lagged default' carve-out closed —
    ncut_current is now a per-model option for every ET family)."""
    from prosper_tpu.models.gsc import GSC
    from prosper_tpu.models.mca import MCA

    rng = jax.random.PRNGKey(3)
    for make, seed in (
            (lambda nc: MCA(16, 8, 5, 3, chunk=256, ncut_current=nc), 1),
            (lambda nc: GSC(16, 8, 5, 3, chunk=256, ncut_current=nc), 2)):
        m_cur, m_lag = make(True), make(False)
        gt = (bars_gt_params(m_cur, intensity=10.0, sigma=1.0)
              if isinstance(m_cur, MCA) else
              {"W": np.random.default_rng(seed).standard_normal(
                  (16, 8)).astype(np.float32) * 3.0,
               "pi": np.float32(0.2), "sigma": np.float32(0.5),
               "mu": np.float32(1.0), "psi": np.float32(0.5)})
        data_np = m_cur.generate_data(gt, 256, seed=seed)
        data = make_blank_data(data_np["y"])
        params = m_cur.standard_init(data_np, seed=seed + 1)

        _, F_cur, _ = m_lag.jit_step()(params, data, _sched(0.0), rng)
        p_cur, F1, s_cur = m_cur.jit_step()(params, data, _sched(1.0), rng)
        data_oracle = dict(data, F_prev=F_cur)
        p_lag, F2, s_lag = m_lag.jit_step()(params, data_oracle,
                                            _sched(1.0), rng)

        name = type(m_cur).__name__
        assert float(s_cur["n_used"]) == float(s_lag["n_used"]), name
        for k in p_cur:
            np.testing.assert_allclose(
                np.asarray(p_cur[k]), np.asarray(p_lag[k]),
                rtol=1e-5, atol=1e-5, err_msg=f"{name}:{k}")
        np.testing.assert_array_equal(np.asarray(F1), np.asarray(F2),
                                      err_msg=name)
        # fresh-start pathology avoided only in current mode
        _, _, s_fresh = m_lag.jit_step()(params, data, _sched(1.0), rng)
        assert float(s_fresh["n_used"]) == 256, name
        assert float(s_cur["n_used"]) < 256, name
