"""Mixture models: Mixture of Gaussians (MoG) and Mixture of Poissons (MoP).

Reference behavior: SURVEY.md §2 row "Mixture models" —
``prosper/em/mixturemodels/`` (confidence [L]; mount unavailable).  Classic
EM mixtures sharing the framework's driver/annealing/logging/mesh stack:
the step function has the same (params, data, sched, rng) -> (params, F,
scalars) contract as the ET models, so ``EM``, ``MeshRuntime`` and the
DataLog all apply unchanged.

Responsibilities are one (N, K) softmax — a single fused
elementwise+reduce block after a (N,D)x(D,K)-shaped distance computation;
suff stats are two GEMMs, psum'd over the data axis.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.core.select import exact_count_mask
from prosper_tpu.parallel.mesh import maybe_psum


class MixtureModel:
    """Shared EM machinery for K-component mixtures."""

    #: single-pass (N,K) E-step — no chunk-divisibility requirement
    requires_chunk_multiple = False

    def __init__(self, D: int, K: int, to_learn=None, chunk: int = 65536):
        self.D = int(D)
        self.K = int(K)
        self.to_learn = (tuple(to_learn) if to_learn is not None
                         else self.param_names)
        self.chunk = int(chunk)
        self._jit_step = {}

    param_names = ("pi",)

    # -- subclass contract: component log-likelihoods and M-step --------------

    def component_loglik(self, params, y):
        """(N, K) log p(y | component k)."""
        raise NotImplementedError

    def m_step_components(self, params, sums, n_used):
        raise NotImplementedError

    def sample_component(self, params, comp, rng):
        raise NotImplementedError

    # -- shared step ----------------------------------------------------------

    def step_fn(self, params, data, sched, rng, axis_name: Optional[str] = None,
                saturated: bool = False):
        y = data["y"]
        valid = data["valid"]
        N = y.shape[0]

        if axis_name is not None:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis_name))
        weight = jax.lax.cond(
            sched["partial"] >= 1.0,
            lambda: valid,
            lambda: exact_count_mask(rng, N, sched["partial"], valid=valid))

        log_pi = jnp.log(jnp.maximum(params["pi"], 1e-12))
        ll = self.component_loglik(params, y)                        # (N,K)
        logits = sched["beta"] * ll + sched["prior_beta"] * log_pi[None, :]
        m = jnp.max(logits, axis=1, keepdims=True)
        p = jnp.exp(logits - m)
        Z = jnp.sum(p, axis=1, keepdims=True)
        r = p / Z * weight[:, None]                                   # (N,K)
        F = (m + jnp.log(Z))[:, 0]
        # saturated (beta == prior_beta == 1): F_true == F, skip the second
        # logsumexp (static specialization, see ETModel.step_fn)
        F_true = (F if saturated
                  else jax.nn.logsumexp(ll + log_pi[None, :], axis=1))

        sums = {
            "r": jnp.sum(r, axis=0),                                  # (K,)
            "ry": jnp.dot(r.T, y, preferred_element_type=jnp.float32),  # (K,D)
            "ry2": jnp.dot(r.T, y * y, preferred_element_type=jnp.float32),
            "n": jnp.sum(weight),
            "F": jnp.sum(F * weight),
            "F_true": jnp.sum(F_true * weight),
        }
        sums = jax.tree_util.tree_map(lambda a: maybe_psum(a, axis_name), sums)

        new = dict(params)
        n_used = jnp.maximum(sums["n"], 1.0)
        if "pi" in self.to_learn:
            pi = jnp.maximum(sums["r"], 1e-12)
            new["pi"] = pi / jnp.sum(pi)
        new.update(self.m_step_components(params, sums, n_used))

        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"],
            "N_total": maybe_psum(jnp.sum(valid), axis_name),
        }
        return new, F, scalars

    def jit_step(self, saturated: bool = False):
        from functools import partial
        if saturated not in self._jit_step:
            self._jit_step[saturated] = jax.jit(
                partial(self.step_fn, axis_name=None, saturated=saturated))
        return self._jit_step[saturated]

    # -- shared API (generation / init / inference) ---------------------------

    def generate_data(self, params, N: int, seed: int = 0) -> Dict:
        rng = np.random.default_rng(seed)
        pi = np.asarray(params["pi"], np.float64)
        comp = rng.choice(self.K, size=N, p=pi / pi.sum())
        y = self.sample_component(params, comp, rng)
        return {"y": y.astype(np.float32), "s": comp,
                "valid": np.ones((N,), np.float32)}

    def standard_init(self, data: Dict, seed: int = 0) -> Dict:
        rng = np.random.default_rng(seed)
        y = np.asarray(data["y"], np.float64)
        idx = rng.choice(y.shape[0], size=self.K, replace=False)
        params = {"pi": jnp.full((self.K,), 1.0 / self.K, jnp.float32)}
        params.update(self._init_components(y, y[idx], rng))
        return params

    def inference(self, params, data):
        """Responsibilities + hard assignments (the mixture 'decode')."""
        y = jnp.asarray(data["y"], jnp.float32)
        ll = self.component_loglik(params, y)
        log_pi = jnp.log(jnp.maximum(params["pi"], 1e-12))
        logp = ll + log_pi[None, :]
        r = jax.nn.softmax(logp, axis=1)
        return {"resp": r, "assign": jnp.argmax(logp, axis=1),
                "F": jax.nn.logsumexp(logp, axis=1)}


class MoG(MixtureModel):
    """Isotropic-per-component Gaussian mixture."""

    param_names = ("pi", "mu", "sigma")

    def component_loglik(self, params, y):
        mu = params["mu"]                                             # (K,D)
        sigma2 = params["sigma"][None, :] ** 2                        # (1,K)
        y2 = jnp.sum(y * y, axis=1, keepdims=True)                    # (N,1)
        cross = jnp.dot(y, mu.T, preferred_element_type=jnp.float32)  # (N,K)
        mu2 = jnp.sum(mu * mu, axis=1)[None, :]
        dist2 = y2 - 2.0 * cross + mu2
        return (-0.5 * dist2 / sigma2
                - 0.5 * self.D * jnp.log(2.0 * jnp.pi * sigma2))

    def m_step_components(self, params, sums, n_used):
        out = {}
        rk = jnp.maximum(sums["r"], 1e-8)[:, None]                    # (K,1)
        if "mu" in self.to_learn:
            out["mu"] = sums["ry"] / rk
        if "sigma" in self.to_learn:
            # residuals around the means actually in use (frozen mu must
            # NOT be replaced by the responsibility-weighted mean)
            mu = out.get("mu", params["mu"])
            ey2 = jnp.sum(sums["ry2"], axis=1)
            cross = jnp.sum(mu * sums["ry"], axis=1)
            mu2 = jnp.sum(mu * mu, axis=1) * rk[:, 0]
            var = jnp.maximum((ey2 - 2 * cross + mu2)
                              / (rk[:, 0] * self.D), 1e-10)
            out["sigma"] = jnp.sqrt(var)
        return out

    def _init_components(self, y, seeds, rng):
        return {"mu": jnp.asarray(seeds, jnp.float32),
                "sigma": jnp.full((self.K,), float(y.std()) + 1e-3,
                                  jnp.float32)}

    def sample_component(self, params, comp, rng):
        mu = np.asarray(params["mu"], np.float64)
        sigma = np.asarray(params["sigma"], np.float64)
        return mu[comp] + sigma[comp, None] * rng.standard_normal(
            (comp.shape[0], self.D))


class MoP(MixtureModel):
    """Mixture of independent Poissons (count data)."""

    param_names = ("pi", "lam")

    def component_loglik(self, params, y):
        lam = jnp.maximum(params["lam"], 1e-8)                        # (K,D)
        log_lam = jnp.log(lam)
        # sum_d [ y log lam - lam - log Gamma(y+1) ]
        return (jnp.dot(y, log_lam.T, preferred_element_type=jnp.float32)
                - jnp.sum(lam, axis=1)[None, :]
                - jnp.sum(jax.scipy.special.gammaln(y + 1.0), axis=1,
                          keepdims=True))

    def m_step_components(self, params, sums, n_used):
        if "lam" not in self.to_learn:
            return {}
        rk = jnp.maximum(sums["r"], 1e-8)[:, None]
        return {"lam": jnp.maximum(sums["ry"] / rk, 1e-8)}

    def _init_components(self, y, seeds, rng):
        return {"lam": jnp.asarray(np.maximum(seeds, 0.1), jnp.float32)}

    def sample_component(self, params, comp, rng):
        lam = np.asarray(params["lam"], np.float64)
        return rng.poisson(lam[comp]).astype(np.float64)
