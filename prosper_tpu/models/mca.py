"""Maximal-causes models: MCA (max) and MMCA (max-magnitude).

Reference behavior: SURVEY.md §2 rows "MCA-ET"
(prosper/em/camodels/mca_et.py) and "MMCA-ET" (mmca_et.py) — mount
unavailable, behavior-level parity.  Binary latents with Bernoulli(pi)
prior; superposition is the (signed-magnitude) pointwise max; Gaussian
observation noise.  The M-step assigns each observed dimension to its
winning cause (see core/maxstep.py for the rho -> inf note) and updates

    W_dh   <- sum_n <A_ndh y_nd> / sum_n <A_ndh>
    pi     <- ET-corrected mean activity      (as BSC)
    sigma  <- sqrt( sum <||y - ybar_s||^2> / (N_use * D) )
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.core import states as states_mod
from prosper_tpu.core.etstep import state_arrays_from
from prosper_tpu.core.maxstep import max_et_estep
from prosper_tpu.models.base import ETModel
from prosper_tpu.parallel.mesh import maybe_psum


class MCA(ETModel):
    """Maximal Causes Analysis: ybar_d = max over active h of W_dh."""

    #: |W|-ranked winner (MMCA) vs plain value max (MCA)
    magnitude: bool = False

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False):
        # chunk bounds the (chunk, S, D) winner tile; 2048 keeps it tens of
        # MB at bars/patches-like configs while amortising per-chunk
        # overheads
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        self.space = states_mod.binary_state_space(Hprime, gamma)
        self.sa = state_arrays_from(self.space)
        #: reference-parity Ncut semantics (same contract as the linear
        #: family): rank the cut by the CURRENT iteration's F via a second
        #: E-step pass while the cut is active
        self.ncut_current = bool(ncut_current)

    # -- prior helpers --------------------------------------------------------

    def _log_odds(self, params):
        pi = params["pi"]
        return jnp.log(pi) - jnp.log1p(-pi)

    # -- fused EM step --------------------------------------------------------

    def log_pi_active(self, params):
        return jnp.log(params["pi"])

    def estep_sums(self, params, y, weight, sched, saturated: bool = False,
                   state_axis: Optional[str] = None, n_state_shards: int = 1):
        """Family E-step over one device-resident block: (F, local sums).
        Shared by ``step_fn`` and engine/stream.py."""
        return max_et_estep(
            y, weight, params["W"], params["sigma"] ** 2,
            self._log_odds(params), self.sa, self.Hprime, self.magnitude,
            sched["beta"], sched["prior_beta"], self.chunk, rho=sched["rho"],
            state_axis=state_axis, n_state_shards=n_state_shards,
            collect_true=not saturated)

    def finalize_mstep(self, params, sums, N_total,
                       axis_name: Optional[str] = None,
                       state_axis: Optional[str] = None,
                       n_state_shards: int = 1):
        """Mesh reduction + winner-responsibility M-step + scalars.
        Shared by ``step_fn`` and engine/stream.py."""
        from prosper_tpu.core.etstep import truncated_prior_logmass
        sums = jax.tree_util.tree_map(lambda a: maybe_psum(a, axis_name), sums)
        if state_axis is not None and n_state_shards > 1:
            sums = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, state_axis), sums)
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)

        new = dict(params)
        n_used = jnp.maximum(sums["n"], 1.0)
        if "W" in self.to_learn:
            denom = sums["denom"]                                       # (H,D)
            W_new = jnp.where(denom > 1e-6, sums["numer"] / jnp.maximum(
                denom, 1e-6), params["W"].T).T
            new["W"] = W_new
        if "pi" in self.to_learn:
            mean_abs = sums["abs"] / n_used
            pi = params["pi"] * jnp.exp(logA - logB) * mean_abs
            new["pi"] = jnp.clip(pi, 1e-6, 1.0 - 1e-6)
        if "sigma" in self.to_learn:
            sigma2_new = jnp.maximum(sums["resid"] / (n_used * self.D), 1e-10)
            new["sigma"] = jnp.sqrt(sigma2_new)

        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"], "N_total": N_total,
        }
        return new, scalars

    def step_fn(self, params, data, sched, rng, axis_name: Optional[str] = None,
                state_axis: Optional[str] = None, n_state_shards: int = 1,
                saturated: bool = False):
        y = data["y"]

        rng_noise, rng_partial = jax.random.split(rng)
        params = self.noisify(params, sched, rng_noise)

        def estep(weight):
            return self.estep_sums(params, y, weight, sched, saturated,
                                   state_axis, n_state_shards)

        F, sums, logA, logB, N_total = self.run_estep_with_ncut(
            estep, self.log_pi_active(params), data, sched, rng_partial,
            axis_name)
        new, scalars = self.finalize_mstep(
            params, sums, N_total, axis_name, state_axis, n_state_shards)
        return new, F, scalars

    # -- generation -----------------------------------------------------------

    def sample_latents(self, params, N, rng):
        pi = float(np.asarray(params["pi"]))
        return (rng.random((N, self.H)) < pi).astype(np.float64)

    def generate_from_hidden(self, params, s, rng):
        W = np.asarray(params["W"], np.float64)                         # (D,H)
        N = s.shape[0]
        act = s > 0.5
        if self.magnitude:
            key = np.where(act[:, None, :], np.abs(W)[None, :, :], -np.inf)
            idx = np.argmax(key, axis=2)                                # (N,D)
            ybar = np.take_along_axis(W[None, :, :].repeat(N, 0), idx[:, :, None],
                                      axis=2)[:, :, 0]
            ybar[~act.any(axis=1)] = 0.0
        else:
            vals = np.where(act[:, None, :], W[None, :, :], -np.inf)
            ybar = vals.max(axis=2)
            ybar[~act.any(axis=1)] = 0.0
        return ybar


    def inference(self, params, data, top_L: int = 10, anneal=None,
                  runtime=None, dense_states=None):
        """Posterior decode (reference: CAModel.inference).
        ``dense_states``: True = dense (N, L, H) top states, False = compact
        fields (faster at serving scale), None = auto by output size (see
        LinearETModel.inference / ETModel.resolve_dense_states)."""
        from prosper_tpu.core.maxstep import max_et_posterior
        from prosper_tpu.models.base import sched_from_anneal
        sched = sched_from_anneal(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else jnp.float32(1.0)
        prior_beta = sched["prior_beta"] if sched else jnp.float32(1.0)
        y = jnp.asarray(data["y"], jnp.float32)
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        return self._cached_infer(
            ("max", top_L, self.chunk, dense_states),
            lambda y_, p, b, pb: max_et_posterior(
                y_, p["W"], p["sigma"] ** 2, self._log_odds(p), self.sa,
                self.Hprime, self.magnitude, top_L, b, pb,
                chunk=self.chunk, dense_states=dense_states),
            y, params, beta, prior_beta, runtime=runtime)


class MMCA(MCA):
    """Max-magnitude causes: the winning cause has the largest |W_dh|
    (signed version of MCA for zero-mean data — SURVEY.md §2 "MMCA-ET")."""

    magnitude = True
