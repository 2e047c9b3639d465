"""GSC: spike-and-slab / Gaussian Sparse Coding.

Reference behavior: SURVEY.md §2 row "GSC" (prosper/em/camodels/gsc.py —
mount unavailable): s_h = b_h * z_h with b ~ Bernoulli(pi),
z ~ N(mu, psi); E-step enumerates binary supports with the slab integrated
out per support (core/gscstep.py); "richer M-step" updates W, pi, sigma plus
the slab mean/variance:

  W      <- (sum_n y <sz>^T)(sum_n <sz sz^T>)^-1      (least squares)
  pi     <- ET-corrected mean support size            (as BSC)
  sigma  <- residual formula with the new W
  mu     <- sum <s_h z_h> / sum <|s|>
  psi    <- sum <s_h z_h^2> / sum <|s|>  - 2 mu sum<s_h z_h>/sum<|s|> + mu^2
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.core import states as states_mod
from prosper_tpu.core.etstep import state_arrays_from
from prosper_tpu.core.gscstep import gsc_et_estep
from prosper_tpu.models.base import ETModel
from prosper_tpu.parallel.mesh import maybe_psum


class GSC(ETModel):

    param_names = ("W", "pi", "sigma", "mu", "psi")

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=4096,
                 ncut_current: bool = False):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        self.space = states_mod.binary_state_space(Hprime, gamma)
        self.sa = state_arrays_from(self.space)
        #: reference-parity Ncut semantics (same contract as the linear
        #: family): rank the cut by the CURRENT iteration's F via a second
        #: E-step pass while the cut is active
        self.ncut_current = bool(ncut_current)

    def _extra_init(self, y, rng):
        return {"mu": jnp.float32(0.0), "psi": jnp.float32(1.0)}

    def log_pi_active(self, params):
        return jnp.log(params["pi"])

    def estep_sums(self, params, y, weight, sched, saturated: bool = False,
                   state_axis: Optional[str] = None, n_state_shards: int = 1):
        """Family E-step over one device-resident block: (F, local sums).
        Shared by ``step_fn`` and engine/stream.py."""
        return gsc_et_estep(
            y, weight, params["W"], params["sigma"] ** 2, params["pi"],
            params["mu"], params["psi"], self.sa, self.Hprime,
            sched["beta"], sched["prior_beta"], self.chunk,
            state_axis=state_axis, n_state_shards=n_state_shards,
            collect_true=not saturated)

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

    def finalize_mstep(self, params, sums, N_total,
                       axis_name: Optional[str] = None,
                       state_axis: Optional[str] = None,
                       n_state_shards: int = 1):
        """Mesh reduction + the GSC "richer M-step" (W, pi, sigma, mu, psi)
        + scalars.  Shared by ``step_fn`` and engine/stream.py."""
        from prosper_tpu.core.etstep import truncated_prior_logmass
        sums = jax.tree_util.tree_map(lambda a: maybe_psum(a, axis_name), sums)
        if state_axis is not None and n_state_shards > 1:
            sums = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, state_axis), sums)
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)

        new = dict(params)
        n_used = jnp.maximum(sums["n"], 1.0)
        H = self.H

        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (jnp.trace(ss) / H + 1.0)
            new["W"] = jnp.linalg.solve(
                ss + ridge * jnp.eye(H, dtype=ss.dtype), sums["xs"].T).T
        if "pi" in self.to_learn:
            mean_abs = sums["abs"] / n_used
            new["pi"] = jnp.clip(
                params["pi"] * jnp.exp(logA - logB) * mean_abs,
                1e-6, 1.0 - 1e-6)
        if "sigma" in self.to_learn:
            W = new["W"]
            gram = jnp.dot(W.T, W, preferred_element_type=jnp.float32)
            resid = (sums["y2"] - 2.0 * jnp.sum(W * sums["xs"])
                     + jnp.sum(gram * sums["ss"]))
            new["sigma"] = jnp.sqrt(jnp.maximum(resid / (n_used * self.D),
                                                1e-10))
        total_abs = jnp.maximum(sums["abs"], 1e-6)
        sum_z = jnp.sum(sums["s"])
        sum_z2 = jnp.trace(sums["ss"])
        if "mu" in self.to_learn:
            new["mu"] = sum_z / total_abs
        if "psi" in self.to_learn:
            mu_new = new["mu"]
            psi = sum_z2 / total_abs - 2.0 * mu_new * sum_z / total_abs \
                + mu_new ** 2
            new["psi"] = jnp.maximum(psi, 1e-6)

        scalars = {
            "F_total": sums["F"], "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"], "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"], "N_total": N_total,
        }
        return new, scalars

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  runtime=None, dense_states=None):
        """Posterior decode (reference: CAModel.inference).
        ``dense_states``: True = dense (N, L, H) top states, False = compact
        fields (faster at serving scale), None = auto by output size (see
        LinearETModel.inference / ETModel.resolve_dense_states)."""
        from prosper_tpu.core.gscstep import gsc_posterior
        from prosper_tpu.models.base import sched_from_anneal
        sched = sched_from_anneal(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else jnp.float32(1.0)
        prior_beta = sched["prior_beta"] if sched else jnp.float32(1.0)
        y = jnp.asarray(data["y"], jnp.float32)
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        return self._cached_infer(
            ("gsc", top_L, self.chunk, dense_states),
            lambda y_, p, b, pb: gsc_posterior(
                y_, p["W"], p["sigma"] ** 2, p["pi"], p["mu"], p["psi"],
                self.sa, self.Hprime, top_L, b, pb, chunk=self.chunk,
                dense_states=dense_states),
            y, params, beta, prior_beta, runtime=runtime)

    # -- generation -----------------------------------------------------------

    def sample_latents(self, params, N, rng):
        pi = float(np.asarray(params["pi"]))
        mu = float(np.asarray(params.get("mu", 0.0)))
        psi = float(np.asarray(params.get("psi", 1.0)))
        b = (rng.random((N, self.H)) < pi)
        z = mu + np.sqrt(psi) * rng.standard_normal((N, self.H))
        return b * z

    def generate_from_hidden(self, params, s, rng):
        W = np.asarray(params["W"], np.float64)
        return s @ W.T
