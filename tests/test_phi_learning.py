"""DSC value-set (Phi) learning — oracle + integration.

SURVEY.md §2 "DSC-ET": latents from a finite value set Phi, "optionally
learned".  The closed-form update solves M phi = c from the phi_c/phi_M
E-step statistics; oracle equality pins the statistics, the integration
test recovers a planted value set (up to the W/phi scale gauge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prosper_tpu.core.etstep import (
    linear_et_estep,
    state_arrays_from,
    traced_state_arrays,
)
from prosper_tpu.core.states import discrete_state_space, slot_value_onehot
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.linear import DSC

from tests.oracle import linear_oracle_estep


def test_phi_stats_match_oracle():
    N, D, H, Hp, gamma = 24, 12, 6, 6, 3
    values = [-1.0, 1.0, 2.0]
    rng = np.random.default_rng(3)
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    sigma, pi = 1.3, 0.2
    pi_vec = np.asarray([pi / 3] * 3)

    space = discrete_state_space(Hp, gamma, values)
    sa = state_arrays_from(space)
    so = jnp.asarray(slot_value_onehot(space))
    log_odds = jnp.asarray(np.log(pi_vec) - np.log(1 - pi_vec.sum()),
                           jnp.float32)
    weight = jnp.asarray((rng.random(N) > 0.2).astype(np.float32))

    F, sums = jax.jit(
        lambda y_: linear_et_estep(
            y_, weight, jnp.asarray(W), jnp.float32(sigma ** 2), log_odds,
            sa, Hp, True, jnp.float32(1.0), jnp.float32(1.0), chunk=2048,
            collect_phi=True, slot_onehot=so)
    )(jnp.asarray(y))

    cand = np.tile(np.arange(H), (N, 1))
    _, sums_o = linear_oracle_estep(y, W, sigma, pi_vec, values, Hp, gamma,
                                    signed_select=True,
                                    weight=np.asarray(weight),
                                    candidates=cand)
    np.testing.assert_allclose(np.asarray(sums["phi_c"]), sums_o["phi_c"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(sums["phi_M"]), sums_o["phi_M"],
                               rtol=2e-4, atol=2e-4)


def test_traced_state_arrays_match_static():
    values = [-1.0, 1.0, 2.0]
    space = discrete_state_space(6, 3, values)
    sa = state_arrays_from(space)
    so = slot_value_onehot(space)
    sa_t = traced_state_arrays(so, space.value_counts, space.abs_states,
                               jnp.asarray(values, jnp.float32))
    np.testing.assert_allclose(np.asarray(sa_t.states), np.asarray(sa.states))
    np.testing.assert_allclose(np.asarray(sa_t.outer), np.asarray(sa.outer))
    np.testing.assert_allclose(np.asarray(sa_t.values), values)


def test_phi_mstep_solves_quadratic():
    """m_step's phi update must solve M phi = c (ridge-regularised), with the
    gauge rescale keeping the anchor value's initial magnitude."""
    model = DSC(12, 6, 6, 3, phi=(-1.0, 1.0, 2.0),
                to_learn=("W", "pi", "sigma", "phi"))
    rng = np.random.default_rng(0)
    K, H, D = 3, 6, 12
    A = rng.standard_normal((K, 5))
    M = A @ A.T + np.eye(K)
    c = rng.standard_normal(K)
    sums = {
        "phi_M": jnp.asarray(M, jnp.float32), "phi_c": jnp.asarray(c, jnp.float32),
        "ss": jnp.eye(H), "xs": jnp.asarray(rng.standard_normal((D, H)), jnp.float32),
        "abs": jnp.float32(10.0), "vc": jnp.asarray([3.0, 4.0, 3.0]),
        "y2": jnp.float32(100.0), "n": jnp.float32(50.0),
    }
    params = {"W": jnp.asarray(rng.standard_normal((D, H)), jnp.float32),
              "pi": jnp.asarray([0.05, 0.05, 0.05]),
              "sigma": jnp.float32(1.0),
              "phi": jnp.asarray([-1.0, 1.0, 2.0])}
    new = model.m_step(params, sums, jnp.float32(0.0), jnp.float32(0.1))

    phi_unc = np.linalg.solve(M + 1e-6 * (np.trace(M) / K + 1) * np.eye(K), c)
    alpha = 2.0 / phi_unc[2]                    # anchor = index of max |phi0|
    np.testing.assert_allclose(np.asarray(new["phi"]), phi_unc * alpha,
                               rtol=1e-5)
    # W counter-scaled so W s is invariant
    W_expect = np.linalg.solve(
        np.eye(H) + 1e-6 * (1.0 + 1.0) * np.eye(H),
        np.asarray(sums["xs"]).T).T / alpha
    np.testing.assert_allclose(np.asarray(new["W"]), W_expect, rtol=1e-4)


def test_dsc_phi_recovery_integration():
    """Planted DSC data; phi initialised WRONG; EM with phi learning must
    recover the planted value ratios (gauge-invariant comparison)."""
    rng = np.random.default_rng(7)
    D, H, Hp, gamma, N = 36, 8, 8, 3, 2000
    gt_phi = np.array([-1.0, 1.0, 2.0])
    model = DSC(D, H, Hp, gamma, phi=tuple(gt_phi),
                to_learn=("W", "pi", "sigma", "phi"))
    W_gt = rng.standard_normal((D, H)).astype(np.float32) * 2.0
    gt = {"W": jnp.asarray(W_gt), "pi": jnp.asarray([0.08, 0.08, 0.08]),
          "sigma": jnp.float32(0.3), "phi": jnp.asarray(gt_phi, jnp.float32)}
    data = model.generate_data(gt, N, seed=1)

    # start from distorted values (same signs, wrong magnitudes/ratios)
    model2 = DSC(D, H, Hp, gamma, phi=(-0.6, 1.4, 1.7),
                 to_learn=("W", "pi", "sigma", "phi"))
    anneal = LinearAnnealing(40)
    anneal["T"] = [(0.0, 1.5), (0.5, 1.0)]
    params0 = model2.standard_init({"y": data["y"]})
    params0 = dict(params0, W=jnp.asarray(
        W_gt + 0.3 * rng.standard_normal(W_gt.shape).astype(np.float32)))
    em = EM(model2, anneal, {"y": data["y"]}, params=params0, seed=2)
    params = em.run()

    phi = np.sort(np.asarray(params["phi"], np.float64))
    gt_sorted = np.sort(gt_phi)
    # gauge-invariant: ratios to the largest-|.| value must match
    np.testing.assert_allclose(phi / phi[-1], gt_sorted / gt_sorted[-1],
                               atol=0.08)
    # free energy still improves
    Q = [h["Q_mean"] for h in em.history]
    assert Q[-1] > Q[3]
