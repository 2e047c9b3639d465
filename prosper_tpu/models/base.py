"""Shared model machinery — the analogue of the reference CAModel.

Reference behavior: SURVEY.md §2 "ET base (CAModel)"
(prosper/em/camodels/__init__.py — mount unavailable): constructor
``(D, H, Hprime, gamma, to_learn)``, truncated state matrix, candidate
preselection, partial-data selection, ``generate_data``, ``standard_init``,
``noisify_params``, ``inference``.

Differences by design:
  * models are *static config objects*; all numerics are pure jittable
    functions over parameter pytrees (plain dicts of arrays),
  * the per-iteration EM step is a single fused function (noisify ->
    masks -> E-step -> psum -> M-step) suitable for jit and shard_map,
  * data sub-selection is mask-based with static shapes (core/select.py),
  * the Ncut ranking uses the previous iteration's per-datapoint free
    energies (one-iteration lag) so the E-step stays single-pass — a
    deliberate, documented deviation from the reference's same-iteration
    selection (which is free there only because it materialises all
    (N, S) log-joints).
"""

from __future__ import annotations

from functools import partial as _partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class ETModel:
    """Base class: static config + pure-function EM step."""

    #: parameter names this model owns (subclasses extend)
    param_names: Tuple[str, ...] = ("W", "pi", "sigma")
    #: the chunked E-step needs shard sizes that divide ``chunk`` (loaders
    #: pad); mixture models impose no such requirement
    requires_chunk_multiple: bool = True

    def __init__(self, D: int, H: int, Hprime: int, gamma: int,
                 to_learn: Optional[Sequence[str]] = None,
                 chunk: int = 2048):
        if not (0 < Hprime <= H):
            raise ValueError(f"need 0 < Hprime <= H, got {Hprime=} {H=}")
        if not (2 <= gamma <= Hprime):
            raise ValueError(
                f"need 2 <= gamma <= Hprime, got {gamma=} {Hprime=} — the "
                "zero and singleton states are handled analytically, so "
                "gamma < 2 would leave no enumerated states")
        self.D = int(D)
        self.H = int(H)
        self.Hprime = int(Hprime)
        self.gamma = int(gamma)
        self.to_learn = tuple(to_learn) if to_learn is not None else self.param_names
        self.chunk = int(chunk)
        self._jit_step = {}      # keyed by the static ``saturated`` flag

    # -- subclass contract ----------------------------------------------------

    def step_fn(self, params: Dict, data: Dict, sched: Dict, rng,
                axis_name: Optional[str] = None, saturated: bool = False):
        """Pure EM step: returns (new_params, F (N,), scalars dict).

        ``saturated`` is a STATIC specialization hint: the caller asserts
        beta == prior_beta == 1 for this iteration (the post-anneal steady
        state), letting the E-step skip the separate un-annealed
        free-energy channel (F_true == F exactly there) — its second
        full-width softmax is the dominant VPU cost of the hot loop.  The
        engine selects it per-iteration from the HOST-side schedule values,
        so results are unchanged (params bit-identical; the logged Q equals
        F instead of being recomputed)."""
        raise NotImplementedError

    def generate_from_hidden(self, params: Dict, s: np.ndarray,
                             rng: np.random.Generator) -> np.ndarray:
        """Noise-free mean ybar given latent states (host-side numpy)."""
        raise NotImplementedError

    def sample_latents(self, params: Dict, N: int,
                       rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    # -- shared API -----------------------------------------------------------

    def generate_data(self, params: Dict, N: int, seed: int = 0) -> Dict:
        """Sample N datapoints from the generative model (host-side, f64).

        Reference: CAModel.generate_data (SURVEY.md §3.2).  Returns
        {'y': (N,D) f32, 's': ground-truth latents} plus an all-ones 'valid'
        mask (loaders may pad with zeros).
        """
        rng = np.random.default_rng(seed)
        s = self.sample_latents(params, N, rng)
        ybar = self.generate_from_hidden(params, s, rng)
        sigma = float(np.asarray(params["sigma"]))
        y = ybar + sigma * rng.standard_normal(ybar.shape)
        return {
            "y": y.astype(np.float32),
            "s": s,
            "valid": np.ones((N,), np.float32),
        }

    def standard_init(self, data: Dict, seed: int = 0) -> Dict:
        """Data-driven init (reference: CAModel.standard_init — W from the
        data mean plus noise, sigma from the data std, pi ~ 1/H)."""
        rng = np.random.default_rng(seed)
        y = np.asarray(data["y"], np.float64)
        mean = y.mean(axis=0)
        std = y.std()
        W = (mean[:, None]
             + (std / np.sqrt(self.H)) * rng.standard_normal((self.D, self.H)))
        params = {
            "W": jnp.asarray(W, jnp.float32),
            "pi": jnp.float32(1.0 / self.H),
            "sigma": jnp.float32(max(std, 1e-3)),
        }
        params.update(self._extra_init(y, rng))
        return params

    def _extra_init(self, y: np.ndarray, rng) -> Dict:
        return {}

    # -- parameter-noise annealing (reference: CAModel.noisify_params) --------

    def noisify(self, params: Dict, sched: Dict, rng) -> Dict:
        """Add scheduled jitter to W/pi/sigma (+ mu when present)."""
        kW, kp, ks, km = jax.random.split(rng, 4)
        p = dict(params)
        p["W"] = params["W"] + sched["W_noise"] * jax.random.normal(
            kW, params["W"].shape, jnp.float32)
        pi_noise = sched["pi_noise"] * jax.random.normal(
            kp, jnp.shape(params["pi"]))
        p["pi"] = jnp.clip(params["pi"] + pi_noise, 1e-6, 1.0 - 1e-6)
        p["sigma"] = jnp.clip(
            params["sigma"] + sched["sigma_noise"] * jax.random.normal(ks),
            1e-5, None)
        if "mu" in params:
            p["mu"] = params["mu"] + sched["mu_noise"] * jax.random.normal(km)
        return p

    # -- shared jitted-decoder cache (the serving path) -----------------------

    #: ``inference(dense_states=None)`` auto-selects the compact layout
    #: once the dense (N, top_L, H) tensor would exceed this many bytes —
    #: at serving scale the dense tensor dominates the decode's output
    #: traffic, while for small/interactive batches it is the convenient
    #: API.
    DENSE_STATES_AUTO_BYTES: int = 128 * 1024 * 1024

    def resolve_dense_states(self, N: int, top_L: int, dense_states):
        """Resolve the tri-state ``dense_states`` argument (None = auto by
        output size).  Compact output is losslessly densifiable via
        ``core.etstep.densify_top_states``."""
        if dense_states is None:
            return (N * top_L * self.H * 4) <= self.DENSE_STATES_AUTO_BYTES
        return bool(dense_states)

    def _cached_infer(self, key, builder, y, params, beta, prior_beta,
                      runtime=None):
        """jit the posterior decoder once per (family, top_L, chunk) — a
        fresh lambda per call would recompile on every serve request.
        With a MeshRuntime the decode is shard_map'd over the data axis
        (data-parallel serving; decode is per-datapoint independent)."""
        cache = self.__dict__.setdefault("_infer_cache", {})
        if runtime is not None:
            key = key + ("mesh", id(runtime))
        if key not in cache:
            # the runtime rides along in the cache entry so its id cannot
            # be recycled onto a different MeshRuntime while the compiled
            # decoder is still cached
            cache[key] = ((runtime.shard_decode(builder), runtime)
                          if runtime is not None
                          else (jax.jit(builder), None))
        return cache[key][0](y, params, beta, prior_beta)

    # -- shared ET data-selection masks ---------------------------------------

    def partial_mask(self, data, sched, rng_partial, axis_name):
        """Exact-count random subsampling mask (reference:
        CAModel.select_partial_data's 'partial' channel)."""
        from prosper_tpu.core.select import exact_count_mask

        valid = data["valid"]
        N = valid.shape[0]
        if axis_name is not None:
            rng_partial = jax.random.fold_in(
                rng_partial, jax.lax.axis_index(axis_name))
        return jax.lax.cond(
            sched["partial"] >= 1.0,
            lambda: valid,
            lambda: exact_count_mask(rng_partial, N, sched["partial"],
                                     valid=valid))

    def ncut_weight(self, pmask, F_rank, sched, logA, axis_name):
        """Apply the ET data cut on top of ``pmask``, ranking datapoints by
        ``F_rank`` (psum'd histogram-quantile threshold).

        The keep count applies the ET fraction to the rows actually under
        consideration (sum of ``pmask``), NOT to all valid rows — with the
        ``partial`` channel active the two differ, and a keep count larger
        than the subset degenerates the cut to a no-op: badly-explained
        rows stay in and sigma converges ~2x too high (round-5 find, via
        the streamed-vs-in-memory deviation test)."""
        from prosper_tpu.core.select import (global_quantile_threshold,
                                             ncut_keep_count)
        from prosper_tpu.parallel.mesh import maybe_psum
        n_sel = maybe_psum(jnp.sum(pmask), axis_name)
        keep = ncut_keep_count(n_sel, sched["Ncut_factor"], logA)
        thresh = global_quantile_threshold(F_rank, pmask, keep, axis_name)
        return pmask * (F_rank >= thresh).astype(jnp.float32)

    def run_estep_with_ncut(self, estep, log_pi_active, data, sched,
                            rng_partial, axis_name):
        """Shared E-step orchestration for both Ncut semantics.

        ``estep(weight) -> (F, sums)`` is the family's fused E-step.
        Default (lagged) mode ranks the cut by the previous iteration's F
        (one pass); ``self.ncut_current`` ranks by the CURRENT iteration's
        F (reference semantics, SURVEY.md §3.1) with a second pass inside
        a lax.cond that is skipped while Ncut_factor == 0.  Returns
        (F, sums, logA, logB, N_total).
        """
        from prosper_tpu.core.etstep import truncated_prior_logmass
        from prosper_tpu.parallel.mesh import maybe_psum

        if not getattr(self, "ncut_current", False):
            weight, logA, logB, N_total = self.et_weight_mask(
                log_pi_active, data, sched, rng_partial, axis_name)
            F, sums = estep(weight)
            return F, sums, logA, logB, N_total

        pmask = self.partial_mask(data, sched, rng_partial, axis_name)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H,
                                             self.gamma)
        N_total = maybe_psum(jnp.sum(data["valid"]), axis_name)
        F, sums = estep(pmask)

        def recut(_):
            w = self.ncut_weight(pmask, F, sched, logA, axis_name)
            return estep(w)[1]

        sums = jax.lax.cond(sched["Ncut_factor"] > 0, recut,
                            lambda _: sums, None)
        return F, sums, logA, logB, N_total

    def et_weight_mask(self, log_pi_active, data, sched, rng_partial,
                       axis_name):
        """Combined partial-subsampling + Ncut mask (static shapes).

        Reference behavior: CAModel.select_partial_data + the ET data cut
        (SURVEY.md §2 "ET base").  The expensive pieces (a full sort for the
        exact-count random mask; the psum'd histogram quantile) are skipped
        via lax.cond whenever the schedule disables them — predicates are
        replicated scalars so the branch is uniform across the mesh.

        Returns (weight (N,), logA, logB, N_total).
        """
        from prosper_tpu.core.etstep import truncated_prior_logmass
        from prosper_tpu.parallel.mesh import maybe_psum

        pmask = self.partial_mask(data, sched, rng_partial, axis_name)
        logA, logB = truncated_prior_logmass(log_pi_active, self.H, self.gamma)
        N_total = maybe_psum(jnp.sum(data["valid"]), axis_name)

        weight = jax.lax.cond(
            sched["Ncut_factor"] > 0,
            lambda: self.ncut_weight(pmask, data["F_prev"], sched, logA,
                                     axis_name),
            lambda: pmask)
        return weight, logA, logB, N_total

    # -- driver plumbing ------------------------------------------------------

    def jit_step(self, saturated: bool = False):
        """Single-device jitted step (lazily compiled, cached per flag)."""
        if saturated not in self._jit_step:
            self._jit_step[saturated] = jax.jit(
                _partial(self.step_fn, axis_name=None, saturated=saturated))
        return self._jit_step[saturated]

    def step(self, params, data, anneal, rng):
        """Convenience: one EM iteration on one device.

        ``data`` must contain y/valid/F_prev; returns (params, data', scalars)
        with the new per-datapoint free energies threaded into data'.
        """
        sched = sched_from_anneal(anneal)
        params, F, scalars = self.jit_step()(params, data, sched, rng)
        data = dict(data, F_prev=F)
        return params, data, scalars


def sched_floats(anneal) -> Dict[str, float]:
    """Annealing snapshot -> plain host floats (no device ops)."""
    s = anneal.as_scalars() if hasattr(anneal, "as_scalars") else dict(anneal)
    beta = float(s.get("beta", 1.0))
    anneal_prior = bool(s.get("anneal_prior", 0.0))
    return {
        "beta": beta,
        "prior_beta": beta if anneal_prior else 1.0,
        "Ncut_factor": float(s.get("Ncut_factor", 0.0)),
        "partial": float(s.get("partial", 1.0)),
        "W_noise": float(s.get("W_noise", 0.0)),
        "pi_noise": float(s.get("pi_noise", 0.0)),
        "sigma_noise": float(s.get("sigma_noise", 0.0)),
        "mu_noise": float(s.get("mu_noise", 0.0)),
        # softened-max exponent for MCA/MMCA responsibilities; <= 0 = hard max
        "rho": float(s.get("rho", 0.0)),
    }


def sched_from_anneal(anneal) -> Dict[str, jnp.ndarray]:
    """Annealing snapshot -> traced scalar dict (no recompiles across steps)."""
    return {k: jnp.float32(v) for k, v in sched_floats(anneal).items()}


def make_blank_data(y, valid=None) -> Dict:
    """Wrap raw observations into the step's data pytree."""
    y = jnp.asarray(y, jnp.float32)
    N = y.shape[0]
    if valid is None:
        valid = jnp.ones((N,), jnp.float32)
    return {"y": y, "valid": jnp.asarray(valid, jnp.float32),
            "F_prev": jnp.zeros((N,), jnp.float32)}
