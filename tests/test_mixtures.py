"""Mixture models: EM recovery of planted components (MoG, MoP)."""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.mixtures import MoG, MoP


def mixture_oracle_step(kind, params, y, beta=1.0, prior_beta=1.0):
    """One EM step of MoG ("mog") or MoP ("mop") in float64 NumPy: the
    per-datapoint log-evidence F, the updated parameters, and each
    component's responsibility mass (``rk``)."""
    from scipy.special import gammaln, logsumexp
    y = np.asarray(y, np.float64)
    D = y.shape[1]
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    y2 = (y * y).sum(axis=1)[:, None]

    def dist2(mu):
        return np.maximum(y2 - 2.0 * y @ mu.T + (mu * mu).sum(axis=1), 0.0)

    if kind == "mog":
        s2 = p["sigma"] ** 2
        ll = -0.5 * dist2(p["mu"]) / s2 - 0.5 * D * np.log(2 * np.pi * s2)
    else:
        lam = np.maximum(p["lam"], 1e-8)
        ll = (y @ np.log(lam).T - lam.sum(axis=1)
              - gammaln(y + 1.0).sum(axis=1, keepdims=True))
    logits = beta * ll + prior_beta * np.log(np.maximum(p["pi"], 1e-12))
    F = logsumexp(logits, axis=1)
    r = np.exp(logits - F[:, None])
    rk = r.sum(axis=0)
    new = {"pi": np.maximum(rk, 1e-12) / np.maximum(rk, 1e-12).sum()}
    if kind == "mog":
        new["mu"] = (r.T @ y) / rk[:, None]
        new["sigma"] = np.sqrt((r * dist2(new["mu"])).sum(axis=0) / (rk * D))
    else:
        new["lam"] = np.maximum((r.T @ y) / rk[:, None], 1e-8)
    return F, new, rk


@pytest.mark.parametrize("kind", ["mog", "mop"])
@pytest.mark.parametrize("beta", [1.0, 0.6])
def test_mixture_step_matches_oracle(kind, beta):
    """The jitted MoG/MoP step reproduces the float64 oracle: F per
    datapoint and every updated parameter."""
    import jax
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal
    D, K, N = 12, 5, 300
    rng = np.random.default_rng(11)
    if kind == "mog":
        model = MoG(D, K)
        y = rng.standard_normal((N, D)) * 2.0
    else:
        model = MoP(D, K)
        y = rng.poisson(3.0, size=(N, D)).astype(np.float64)
    params = model.standard_init({"y": y}, seed=2)
    sched = dict(sched_from_anneal(LinearAnnealing(5)),
                 beta=jnp.float32(beta))
    new, F, _ = model.jit_step()(params, make_blank_data(y), sched,
                                 jax.random.PRNGKey(0))
    F_o, new_o, _ = mixture_oracle_step(kind, params, y, beta=beta)
    np.testing.assert_allclose(np.asarray(F), F_o, rtol=1e-5, atol=1e-4)
    for k, v in new_o.items():
        np.testing.assert_allclose(np.asarray(new[k]), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _match(est, true):
    """Hungarian match components; returns mean abs error of matched rows."""
    C = np.linalg.norm(est[:, None, :] - true[None, :, :], axis=2)
    r, c = linear_sum_assignment(C)
    return est[r][np.argsort(c)], C[r, c].mean()


def test_mog_recovers_components():
    D, K, N = 8, 3, 4000
    rng = np.random.default_rng(0)
    mu_true = rng.standard_normal((K, D)) * 4.0
    gt = {"pi": np.array([0.5, 0.3, 0.2], np.float32),
          "mu": mu_true.astype(np.float32),
          "sigma": np.array([0.5, 0.7, 0.6], np.float32)}
    model = MoG(D, K)
    data = model.generate_data(gt, N, seed=1)

    em = EM(model, LinearAnnealing(40), {"y": data["y"]}, seed=3)
    params = em.run()
    mu_est = np.asarray(params["mu"])
    _, err = _match(mu_est, mu_true)
    assert err < 0.2, f"component mean error {err:.3f}"
    Q = [h["Q_mean"] for h in em.history]
    assert all(b >= a - 1e-3 for a, b in zip(Q[-10:], Q[-9:]))


def test_mog_assignment_accuracy():
    D, K, N = 5, 3, 2000
    rng = np.random.default_rng(5)
    gt = {"pi": np.full(K, 1 / K, np.float32),
          "mu": (rng.standard_normal((K, D)) * 5).astype(np.float32),
          "sigma": np.full(K, 0.4, np.float32)}
    model = MoG(D, K)
    data = model.generate_data(gt, N, seed=6)
    out = model.inference(gt, data)
    acc = (np.asarray(out["assign"]) == data["s"]).mean()
    assert acc > 0.97


def test_mop_recovers_rates():
    D, K, N = 6, 2, 4000
    gt = {"pi": np.array([0.6, 0.4], np.float32),
          "lam": np.array([[1, 2, 3, 4, 5, 6],
                           [9, 8, 7, 6, 5, 4]], np.float32)}
    model = MoP(D, K)
    data = model.generate_data(gt, N, seed=2)
    em = EM(model, LinearAnnealing(30), {"y": data["y"]}, seed=4)
    params = em.run()
    lam_est = np.asarray(params["lam"])
    _, err = _match(lam_est, np.asarray(gt["lam"], np.float64))
    assert err < 0.6, f"rate error {err:.3f}"
    pi_est = np.sort(np.asarray(params["pi"]))
    np.testing.assert_allclose(pi_est, [0.4, 0.6], atol=0.05)


def test_mixture_on_mesh():
    from prosper_tpu.parallel.mesh import MeshRuntime
    D, K, N = 4, 2, 512
    rng = np.random.default_rng(7)
    gt = {"pi": np.array([0.5, 0.5], np.float32),
          "mu": (rng.standard_normal((K, D)) * 4).astype(np.float32),
          "sigma": np.full(K, 0.5, np.float32)}
    model = MoG(D, K)
    data = model.generate_data(gt, N, seed=8)
    em1 = EM(model, LinearAnnealing(10), {"y": data["y"]}, seed=9)
    p1 = em1.run()
    em8 = EM(model, LinearAnnealing(10), {"y": data["y"]}, seed=9,
             runtime=MeshRuntime())
    p8 = em8.run()
    np.testing.assert_allclose(np.asarray(p1["mu"]), np.asarray(p8["mu"]),
                               rtol=2e-3, atol=2e-3)
