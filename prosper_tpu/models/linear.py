"""Linear-superposition ET models: BSC, TSC, DSC.

Reference behavior: SURVEY.md §2 rows "BSC-ET" (prosper/em/camodels/bsc_et.py),
"TSC-ET" (tsc_et.py), "DSC-ET" (dsc_et.py) — mount unavailable, behavior-level
parity.  All three share ``ybar = W @ s`` with isotropic Gaussian noise and a
factorised discrete prior; they differ only in the per-unit value set and the
prior parameterisation:

  BSC:  s_h in {0, 1},       p(s_h=1) = pi                    (scalar pi)
  TSC:  s_h in {-1, 0, +1},  p(s_h=±1) = pi/2                 (scalar pi)
  DSC:  s_h in {0} ∪ Phi,    p(s_h=phi_k) = pi_k              (vector pi)

E-step: one shared path for the family (core/etstep.py).  M-steps are closed
form after a psum of sufficient statistics:

  W     <- (sum_n y <s>^T) (sum_n <s s^T>)^-1
  pi    <- pi * (A_gamma/B_gamma) * mean<|s|>        (ET truncation correction)
  sigma <- sqrt( sum<||y - W s||^2> / (N_use * D) )
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.core import states as states_mod
from prosper_tpu.core.etstep import (
    LinearStateArrays,
    linear_et_estep,
    state_arrays_from,
)
from prosper_tpu.models.base import ETModel
from prosper_tpu.parallel.mesh import maybe_psum


class LinearETModel(ETModel):
    """Shared EM step for the linear family."""

    #: candidate scoring uses |corr| when latents may be negative
    signed_select: bool = False

    def __init__(self, D, H, Hprime, gamma, values, to_learn=None, chunk=2048,
                 min_active: int = 2, compute_dtype=None,
                 ncut_current: bool = False, s_block: int = 0):
        super().__init__(D, H, Hprime, gamma, to_learn, chunk)
        #: big-S mode: process the enumerated states in s_block-sized tiles
        #: with online-logsumexp accumulation instead of materialising the
        #: (chunk, S) logits — meant for S >~ 10^4, where the logits'
        #: memory traffic dominates (see core/etstep.py::_chunk_estats_bigs).
        #: 0 = off.
        self.s_block = int(s_block)
        #: reference-parity Ncut semantics: rank the data cut by the CURRENT
        #: iteration's free energies (SURVEY.md §3.1) at the price of a
        #: second E-step pass while the cut is active; the default one-pass
        #: design ranks by the previous iteration's F (documented deviation)
        self.ncut_current = bool(ncut_current)
        #: e.g. jnp.bfloat16 — operand dtype of the two large GEMMs
        self.compute_dtype = compute_dtype
        self.space = states_mod.discrete_state_space(
            Hprime, gamma, values, min_active=min_active)
        self.sa: LinearStateArrays = state_arrays_from(self.space)
        #: DSC sets this when the value set Phi is learned; the state arrays
        #: are then rebuilt per step as traced functions of params["phi"]
        self.learn_phi: bool = False
        self._slot_onehot = None

    def _sa_for(self, params) -> LinearStateArrays:
        """State arrays for this step (traced when Phi is a learned param)."""
        if self.learn_phi and "phi" in params:
            from prosper_tpu.core.etstep import traced_state_arrays
            return traced_state_arrays(self._slot_onehot,
                                       self.sa.value_counts,
                                       self.sa.abs_states, params["phi"])
        return self.sa

    # -- prior hooks (subclass contract) --------------------------------------

    def log_odds(self, params) -> jnp.ndarray:
        """(K,) log p(value_k) - log p(0), traced."""
        raise NotImplementedError

    def log_pi_active(self, params):
        """log P(unit active), traced (for the ET A/B corrections)."""
        raise NotImplementedError

    def update_prior(self, params, sums, n_used, logA, logB) -> Dict:
        raise NotImplementedError

    # -- the fused EM step ----------------------------------------------------

    def estep_sums(self, params, y, weight, sched, saturated: bool = False,
                   state_axis: Optional[str] = None, n_state_shards: int = 1):
        """Family E-step over one device-resident block: (F, local sums).

        ``params`` must already be noisified; the caller owns the weight
        mask and any cross-device reductions.  Shared by ``step_fn`` and
        the host->device streaming driver (engine/stream.py)."""
        sigma2 = params["sigma"] ** 2
        sa = self._sa_for(params)
        # big-S tiling composes with state sharding (the state slice is
        # tiled in s_block chunks, combined across the axis with the same
        # online-logsumexp) but not with Phi learning
        s_block = self.s_block if not self.learn_phi else 0
        return linear_et_estep(
            y, weight, params["W"], sigma2, self.log_odds(params),
            sa, self.Hprime, self.signed_select, sched["beta"],
            sched["prior_beta"], self.chunk, state_axis=state_axis,
            n_state_shards=n_state_shards,
            compute_dtype=self.compute_dtype,
            collect_phi=self.learn_phi, slot_onehot=self._slot_onehot,
            s_block=s_block, collect_true=not saturated)

    def finalize_mstep(self, params, sums, N_total,
                       axis_name: Optional[str] = None,
                       state_axis: Optional[str] = None,
                       n_state_shards: int = 1):
        """Reduce sums across the mesh, run the closed-form M-step, and
        assemble the per-iteration scalars.  ``params`` is the noisified
        pytree the E-step ran with (the ET A/B corrections are recomputed
        from it).  Shared by ``step_fn`` and engine/stream.py."""
        from prosper_tpu.core.etstep import truncated_prior_logmass
        sums = jax.tree_util.tree_map(lambda a: maybe_psum(a, axis_name), sums)
        if state_axis is not None and n_state_shards > 1:
            sums = jax.tree_util.tree_map(
                lambda a: jax.lax.psum(a, state_axis), sums)
        logA, logB = truncated_prior_logmass(self.log_pi_active(params),
                                             self.H, self.gamma)
        new_params = self.m_step(params, sums, logA, logB)
        n_used = jnp.maximum(sums["n"], 1.0)
        scalars = {
            "F_total": sums["F"],
            "F_mean": sums["F"] / n_used,
            "Q": sums["F_true"],                 # un-annealed free energy
            "Q_mean": sums["F_true"] / n_used,
            "n_used": sums["n"],
            "N_total": N_total,
        }
        return new_params, scalars

    def step_fn(self, params, data, sched, rng, axis_name: Optional[str] = None,
                state_axis: Optional[str] = None, n_state_shards: int = 1,
                saturated: bool = False):
        y = data["y"]

        rng_noise, rng_partial = jax.random.split(rng)
        params = self.noisify(params, sched, rng_noise)

        def estep(weight):
            # E-step (hot loop); the mask only scales accumulated statistics
            # — per-datapoint F values are mask-independent
            return self.estep_sums(params, y, weight, sched, saturated,
                                   state_axis, n_state_shards)

        # one-pass (lagged) vs reference-semantics (current-F) Ncut — the
        # shared base-class orchestration (models/base.py)
        F, sums, logA, logB, N_total = self.run_estep_with_ncut(
            estep, self.log_pi_active(params), data, sched, rng_partial,
            axis_name)
        new_params, scalars = self.finalize_mstep(
            params, sums, N_total, axis_name, state_axis, n_state_shards)
        return new_params, F, scalars

    # -- closed-form M-step ---------------------------------------------------

    def m_step(self, params, sums, logA, logB):
        H = self.H
        n_used = jnp.maximum(sums["n"], 1.0)
        new = dict(params)

        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (jnp.trace(ss) / H + 1.0)
            A = ss + ridge * jnp.eye(H, dtype=ss.dtype)
            new["W"] = jnp.linalg.solve(A, sums["xs"].T).T

        if "pi" in self.to_learn:
            new.update(self.update_prior(params, sums, n_used, logA, logB))

        if "sigma" in self.to_learn:
            W = new["W"]
            gram = jnp.dot(W.T, W, preferred_element_type=jnp.float32)
            resid = (sums["y2"]
                     - 2.0 * jnp.sum(W * sums["xs"])
                     + jnp.sum(gram * sums["ss"]))
            sigma2 = jnp.maximum(resid / (n_used * self.D), 1e-10)
            new["sigma"] = jnp.sqrt(sigma2)
        return new

    # -- generation -----------------------------------------------------------

    def generate_from_hidden(self, params, s, rng):
        W = np.asarray(params["W"], np.float64)
        return s @ W.T

    # -- posterior decode (reference: CAModel.inference, SURVEY.md §3.3) ------

    def inference(self, params, data, top_L: int = 10, anneal=None,
                  runtime=None, dense_states=None):
        """Posterior decode on held-out data: top states, probabilities,
        posterior mean and reconstruction (the serving path).  ``runtime``
        shards the decode over the mesh data axis (data-parallel serving).
        ``dense_states``: True returns the (N, L, H) dense top-state tensor
        (reference-parity output); False returns the compact top-state
        fields, losslessly densifiable via
        ``core.etstep.densify_top_states``; None (default) auto-selects:
        dense for small batches, compact once the dense tensor would exceed
        ``DENSE_STATES_AUTO_BYTES``."""
        from prosper_tpu.core.etstep import linear_et_posterior
        from prosper_tpu.models.base import sched_from_anneal
        sched = sched_from_anneal(anneal) if anneal is not None else None
        beta = sched["beta"] if sched else jnp.float32(1.0)
        prior_beta = sched["prior_beta"] if sched else jnp.float32(1.0)
        y = jnp.asarray(data["y"], jnp.float32)
        dense_states = self.resolve_dense_states(y.shape[0], top_L,
                                                 dense_states)
        return self._cached_infer(
            ("linear", top_L, self.chunk, dense_states),
            lambda y_, p, b, pb: linear_et_posterior(
                y_, p["W"], p["sigma"] ** 2, self.log_odds(p),
                self._sa_for(p), self.Hprime, self.signed_select, top_L, b,
                pb, chunk=self.chunk, dense_states=dense_states),
            y, params, beta, prior_beta, runtime=runtime)


class BSC(LinearETModel):
    """Binary Sparse Coding with Expectation Truncation.

    Reference: prosper/em/camodels/bsc_et.py :: BSC_ET (SURVEY.md §2).
    """

    signed_select = False

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, s_block: int = 0,
                 compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, values=[1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)

    def log_odds(self, params):
        pi = params["pi"]
        return (jnp.log(pi) - jnp.log1p(-pi))[None]

    def log_pi_active(self, params):
        return jnp.log(params["pi"])

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi = params["pi"] * jnp.exp(logA - logB) * mean_abs
        return {"pi": jnp.clip(pi, 1e-6, 1.0 - 1e-6)}

    def sample_latents(self, params, N, rng):
        pi = float(np.asarray(params["pi"]))
        return (rng.random((N, self.H)) < pi).astype(np.float64)


class TSC(LinearETModel):
    """Ternary Sparse Coding: latents in {-1, 0, +1}, symmetric prior pi/2.

    Reference: prosper/em/camodels/tsc_et.py (SURVEY.md §2 "TSC-ET",
    name confidence [M]).
    """

    signed_select = True

    def __init__(self, D, H, Hprime, gamma, to_learn=None, chunk=2048,
                 ncut_current: bool = False, s_block: int = 0,
                 compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, values=[-1.0, 1.0],
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)

    def log_odds(self, params):
        pi = params["pi"]
        lo = jnp.log(pi / 2.0) - jnp.log1p(-pi)
        return jnp.stack([lo, lo])

    def log_pi_active(self, params):
        return jnp.log(params["pi"])

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi = params["pi"] * jnp.exp(logA - logB) * mean_abs
        return {"pi": jnp.clip(pi, 1e-6, 1.0 - 1e-6)}

    def sample_latents(self, params, N, rng):
        pi = float(np.asarray(params["pi"]))
        u = rng.random((N, self.H))
        s = np.zeros((N, self.H))
        s[u < pi / 2] = -1.0
        s[(u >= pi / 2) & (u < pi)] = 1.0
        return s


class DSC(LinearETModel):
    """Discrete Sparse Coding: latents from {0} ∪ Phi with learned pi vector.

    Reference: prosper/em/camodels/dsc_et.py (SURVEY.md §2 "DSC-ET").
    ``params['pi']`` is the (K,) vector of non-zero value probabilities;
    p(0) = 1 - sum(pi).

    The value set Phi is static config by default; passing
    ``to_learn=(..., "phi")`` makes it a learned (K,) parameter with a
    closed-form M-step (SURVEY.md §2 "DSC-ET": Phi "optionally learned"):
    the expected complete-data log-likelihood is quadratic in phi, so
    phi <- M^-1 c with the phi_c/phi_M sufficient statistics from the
    E-step.  When W is learned too, the (W -> aW, phi -> phi/a) scale
    degeneracy is gauge-fixed after each update by rescaling so the
    largest-|.| initial value keeps its magnitude (W absorbs the inverse).
    """

    signed_select = True

    def __init__(self, D, H, Hprime, gamma, phi=( -1.0, 1.0, 2.0),
                 to_learn=None, chunk=2048, ncut_current: bool = False,
                 s_block: int = 0, compute_dtype=None):
        super().__init__(D, H, Hprime, gamma, values=list(phi),
                         to_learn=to_learn, chunk=chunk,
                         ncut_current=ncut_current, s_block=s_block,
                         compute_dtype=compute_dtype)
        self.phi = np.asarray(phi, np.float64)
        if "phi" in self.to_learn:
            self.learn_phi = True
            self.param_names = ("W", "pi", "sigma", "phi")
            self._slot_onehot = jnp.asarray(
                states_mod.slot_value_onehot(self.space))
            self._phi_anchor = int(np.argmax(np.abs(self.phi)))
            self._phi_anchor_val = float(self.phi[self._phi_anchor])

    def standard_init(self, data, seed: int = 0):
        params = super().standard_init(data, seed)
        K = len(self.phi)
        params["pi"] = jnp.full((K,), 1.0 / (self.H * K), jnp.float32)
        if self.learn_phi:
            params["phi"] = jnp.asarray(self.phi, jnp.float32)
        return params

    def m_step(self, params, sums, logA, logB):
        new = super().m_step(params, sums, logA, logB)
        if self.learn_phi:
            K = len(self.phi)
            M = sums["phi_M"]
            ridge = 1e-6 * (jnp.trace(M) / K + 1.0)
            phi = jnp.linalg.solve(M + ridge * jnp.eye(K, dtype=M.dtype),
                                   sums["phi_c"])
            if "W" in self.to_learn:
                # gauge fix: keep |phi[anchor]| at its initial magnitude and
                # let W absorb the scale (W s is invariant, so this projects
                # the unconstrained optimum onto the gauge slice)
                anchor = phi[self._phi_anchor]
                alpha = jnp.where(jnp.abs(anchor) > 1e-6,
                                  self._phi_anchor_val / anchor, 1.0)
                phi = phi * alpha
                new["W"] = new["W"] / alpha
            new["phi"] = phi
        return new

    def log_odds(self, params):
        pi = params["pi"]
        p0 = jnp.maximum(1.0 - jnp.sum(pi), 1e-6)
        return jnp.log(pi) - jnp.log(p0)

    def log_pi_active(self, params):
        return jnp.log(jnp.clip(jnp.sum(params["pi"]), 1e-8, 1.0 - 1e-8))

    def update_prior(self, params, sums, n_used, logA, logB):
        mean_abs = sums["abs"] / n_used
        pi_act = jnp.clip(jnp.sum(params["pi"]), 1e-8, 1.0 - 1e-8)
        pi_act_new = jnp.clip(pi_act * jnp.exp(logA - logB) * mean_abs,
                              1e-6, 1.0 - 1e-6)
        vc = jnp.maximum(sums["vc"], 1e-12)
        pi = pi_act_new * vc / jnp.sum(vc)
        return {"pi": pi}

    def sample_latents(self, params, N, rng):
        pi = np.asarray(params["pi"], np.float64)
        p0 = max(1.0 - pi.sum(), 0.0)
        probs = np.concatenate([[p0], pi])
        probs = probs / probs.sum()
        phi = np.asarray(params.get("phi", self.phi), np.float64)
        vals = np.concatenate([[0.0], phi])
        idx = rng.choice(len(vals), size=(N, self.H), p=probs)
        return vals[idx]
