"""Candidate pre-selection and data sub-selection (static shapes, mask-based).

Reference behavior: SURVEY.md §2 "ET base" —
  * ``select_Hprimes``: per-datapoint top-H' candidate latents by a W-vs-y
    affinity score (prosper/em/camodels/__init__.py).
  * ``select_partial_data``: random sub-sampling by the ``anneal['partial']``
    fraction, plus the ET "Ncut" cut keeping the best-explained datapoints
    as ``anneal['Ncut_factor']`` ramps up.

Design: the reference uses boolean indexing (dynamic shapes).
Under jit everything must stay statically shaped, so both mechanisms become
*masks* over the full shard:
  * ``partial`` -> an exact-count random mask (top-k over iid uniforms),
  * Ncut       -> a global free-energy quantile threshold computed with a
    psum'd histogram bisection (deterministic and identical on every device,
    preserving the reference's SPMD-determinism property).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from prosper_tpu.parallel.mesh import maybe_pmax, maybe_pmin, maybe_psum


def top_hprime_candidates(P_full: jnp.ndarray, w_norm: jnp.ndarray, Hp: int,
                          signed: bool) -> jnp.ndarray:
    """Per-datapoint top-H' candidate units.

    P_full : (N, H) full projection y @ W (shared with the E-step).
    w_norm : (H,) column norms of W.
    signed : score by |correlation| (models whose latents can flip sign:
             TSC/DSC with negative values, MMCA) vs plain correlation
             (non-negative latents: BSC, MCA).

    Returns (N, Hp) int32 candidate indices (descending score; ties by index).
    """
    cand, _ = top_hprime_candidates_dense(P_full, w_norm, Hp, signed)
    return cand


def top_hprime_candidates_dense(P_full: jnp.ndarray, w_norm: jnp.ndarray,
                                Hp: int, signed: bool):
    """Top-H' candidates plus their one-hot selection matrix.

    Selection is Hp iterated argmaxes — pure vector ops — and the one-hot
    matrix ``onehot (N, Hp, H)`` is built from the same comparisons.  Every
    downstream gather (candidate projections, Gram blocks) and scatter
    (sufficient statistics) then becomes a matmul against ``onehot``.
    Whether ``lax.top_k`` with index gathers does better on the GPU is open
    (ROADMAP 1.4).

    Tie behaviour matches lax.top_k (descending score, lowest index first).
    Returns (cand (N,Hp) int32, onehot (N,Hp,H) float32).

    Implemented as a stack over `top_hprime_candidate_slots` so there is ONE
    selection loop (scoring/tie-breaking cannot drift between the dense and
    per-slot forms).
    """
    cand, hots = top_hprime_candidate_slots(P_full, w_norm, Hp, signed)
    return cand, jnp.stack(hots, axis=1)                             # (N,Hp,H)


def top_hprime_candidate_slots(P_full: jnp.ndarray, w_norm: jnp.ndarray,
                               Hp: int, signed: bool):
    """Top-H' candidates as Hp separate per-slot (N, H) one-hot masks.

    Same selection as `top_hprime_candidates_dense` but WITHOUT stacking the
    hits into the (N, Hp, H) tensor: the per-slot (N, H) masks keep every
    downstream gather/scatter a plain large GEMM in the same layout as
    ``y @ W``.
    Returns (cand (N,Hp) int32, hots: list of Hp (N,H) float32 masks).
    """
    N, H = P_full.shape
    score = P_full / jnp.maximum(w_norm, 1e-12)[None, :]
    if signed:
        score = jnp.abs(score)
    iota = jax.lax.broadcasted_iota(jnp.int32, (N, H), 1)
    cands = []
    hots = []
    s = score
    for _ in range(Hp):
        i = jnp.argmax(s, axis=1).astype(jnp.int32)                  # (N,)
        hit = iota == i[:, None]                                     # (N,H)
        cands.append(i)
        hots.append(hit.astype(jnp.float32))
        s = jnp.where(hit, -jnp.inf, s)
    return jnp.stack(cands, axis=1), hots


def top_l_argmax(q: jnp.ndarray, L: int):
    """``lax.top_k`` replacement via L iterated argmaxes (decode hot path).

    Same formulation as `top_hprime_candidates_dense`.  Assumes
    non-negative entries (posterior probabilities);
    ties break like top_k (descending value, lowest index first).
    Returns (top_q (N,L), top_u (N,L) int32).
    """
    N, M = q.shape
    if L > M:
        raise ValueError(f"top_L={L} exceeds the {M} posterior columns "
                         "(lax.top_k semantics: k must be <= dimension)")
    iota = jax.lax.broadcasted_iota(jnp.int32, (N, M), 1)
    vals, idxs = [], []
    s = q
    for _ in range(L):
        i = jnp.argmax(s, axis=1).astype(jnp.int32)
        hit = iota == i[:, None]
        vals.append(jnp.max(s, axis=1))
        idxs.append(i)
        s = jnp.where(hit, -1.0, s)
    return jnp.stack(vals, axis=1), jnp.stack(idxs, axis=1)


def exact_count_mask(rng: jax.Array, N: int, frac,
                     valid: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Random {0,1} mask with exactly ceil(frac * n_valid) ones
    (static shapes).

    Equivalent of the reference's random permutation subset in
    ``select_partial_data`` — realised as a threshold on iid uniforms so the
    kept *count* is exact while shapes stay static.  With ``valid`` given,
    only valid rows participate (padding rows never count toward the
    fraction and are never selected).
    """
    u = jax.random.uniform(rng, (N,))
    if valid is not None:
        u = jnp.where(valid > 0, u, -1.0)    # padding loses every ranking
        n_valid = jnp.sum(valid)
    else:
        n_valid = jnp.float32(N)
    k = jnp.ceil(frac * n_valid).astype(jnp.int32)
    k = jnp.clip(k, 1, N)
    # threshold = k-th largest uniform -> exactly k survivors
    sorted_u = jnp.sort(u)[::-1]
    thresh = sorted_u[jnp.clip(k - 1, 0, N - 1)]
    return ((u >= thresh) & (u >= 0)).astype(jnp.float32)


def global_quantile_threshold(values: jnp.ndarray,
                              valid: jnp.ndarray,
                              keep_count: jnp.ndarray,
                              axis_name: Optional[str],
                              rounds: int = 3,
                              bins: int = 128) -> jnp.ndarray:
    """Threshold t s.t. ~``keep_count`` of the globally-valid ``values`` are >= t.

    Deterministic histogram bisection: every device computes identical psum'd
    histograms, so every device derives the identical threshold — the mask is
    then a local comparison.  Accuracy after r rounds: range / bins**r.

    values : (N,) per-datapoint scores (higher = better explained).
    valid  : (N,) {0,1} which entries participate (partial-mask etc).
    keep_count : scalar — global number of datapoints to keep.
    """
    big = jnp.float32(3e38)
    v = jnp.where(valid > 0, values, -big)
    lo = maybe_pmin(jnp.min(jnp.where(valid > 0, values, big)), axis_name)
    hi = maybe_pmax(jnp.max(v), axis_name)
    hi = hi + jnp.maximum(1e-6, 1e-6 * jnp.abs(hi))  # open upper edge

    N = v.shape[0]
    hist_chunk = 65536

    def local_hist(lo, width):
        def one(vc, wc):
            idx = jnp.clip(jnp.floor((vc - lo) / width), 0,
                           bins - 1).astype(jnp.int32)
            onehot = jax.nn.one_hot(idx, bins, dtype=jnp.float32)
            return jnp.sum(onehot * wc[:, None], axis=0)
        if N <= hist_chunk or N % hist_chunk != 0:
            return one(v, valid)
        vc = v.reshape(-1, hist_chunk)
        wc = valid.reshape(-1, hist_chunk)
        def body(acc, xs):
            return acc + one(*xs), None
        acc, _ = jax.lax.scan(body, jnp.zeros((bins,), jnp.float32), (vc, wc))
        return acc

    def round_body(_, carry):
        lo, hi = carry
        width = jnp.maximum((hi - lo) / bins, 1e-30)
        hist = maybe_psum(local_hist(lo, width), axis_name)            # (bins,)
        tail = jnp.cumsum(hist[::-1])[::-1]                            # #points in bins >= b
        # largest bin index whose tail still covers keep_count
        bidx = jnp.arange(bins)
        ok = tail >= keep_count
        b_star = jnp.max(jnp.where(ok, bidx, 0))
        new_lo = lo + b_star * width
        new_hi = new_lo + width
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, rounds, round_body, (lo, hi))
    return lo


def ncut_keep_count(N_total, Ncut_factor, log_A_gamma):
    """Global number of datapoints to keep under the ET data cut.

    As ``Ncut_factor`` ramps 0 -> 1, the kept fraction ramps from 1 down to
    A_gamma(pi) — the prior mass of the truncated state space, i.e. the
    fraction of data the truncated model can explain (ET paper prescription;
    SURVEY.md §2 "select_partial_data", confidence [M] — reference mount
    unavailable).
    """
    A = jnp.exp(log_A_gamma)
    frac = 1.0 - (1.0 - A) * Ncut_factor
    return jnp.ceil(frac * N_total)
