"""The Expectation-Truncation E-step for linear-superposition models.

Covers BSC (binary), TSC (ternary) and DSC (discrete) — every model with
``ybar = W @ s`` and isotropic Gaussian noise.  Reference behavior:
SURVEY.md §2 rows "BSC-ET"/"TSC-ET"/"DSC-ET" and §3.1's hot loop
(prosper/em/camodels/{bsc_et,tsc_et,dsc_et}.py — mount unavailable).

Formulation (NOT the reference's layout)
----------------------------------------
The reference gathers a per-datapoint dictionary ``W[:, candidates_n]`` and
computes ``(N, S, D)`` reconstructions.  Here both are avoided:

  ||y - W s||^2 = ||y||^2 - 2 s.(Wc^T y) + s.(Wc^T Wc).s

  * ``P = y @ W``            one large (N,D)x(D,H) GEMM, also reused for
                             candidate selection,
  * ``proj = P[n, cand]``    gather of N*Hp scalars,
  * ``G = (W^T W)[cand,cand]`` gather of N*Hp^2 scalars from a once-per-step
                             (H,H) Gram matrix,
  * state likelihoods        two small GEMMs: (N,Hp)x(Hp,S) and
                             (N,Hp^2)x(Hp^2,S) using the precomputed
                             per-state outer products (states.outer),
  * suff stats               (N,S)x(S,Hp) / (S,Hp^2) GEMMs + scatter-adds.

Nothing of size (N,S,D) ever exists; the big tensors are (N,S) logits per
chunk.  The truncated set per datapoint is the ET union
``{0} ∪ {singletons over ALL H units × K values} ∪ {multi states over the
H' candidates}`` with the zero/singleton parts handled in closed form
(SURVEY.md §2 "ET base": "zero and singleton states handled analytically").

Chunking: datapoints are processed in static-size chunks via ``lax.scan``
with online accumulation, bounding device-memory residency at
O(chunk * (S + H + H*K)) regardless of shard size.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from prosper_tpu.core.select import top_hprime_candidates


class LinearStateArrays(NamedTuple):
    """Device-resident static enumeration (from core.states.StateSpace)."""
    states: jnp.ndarray        # (S, Hp)
    outer: jnp.ndarray         # (S, Hp*Hp)
    abs_states: jnp.ndarray    # (S,)
    value_counts: jnp.ndarray  # (S, K)
    values: jnp.ndarray        # (K,)


def state_arrays_from(space) -> LinearStateArrays:
    return LinearStateArrays(
        states=jnp.asarray(space.states),
        outer=jnp.asarray(space.outer),
        abs_states=jnp.asarray(space.abs_states),
        value_counts=jnp.asarray(space.value_counts),
        values=jnp.asarray(space.values),
    )


def traced_state_arrays(slot_onehot, value_counts, abs_states,
                        phi) -> LinearStateArrays:
    """State arrays as traced functions of a learned value vector ``phi``.

    ``slot_onehot`` is the static (S, Hp, K) assignment indicator
    (core.states.slot_value_onehot); states/outer/values become functions of
    the (K,) parameter so DSC value-set learning re-enumerates nothing."""
    phi = jnp.asarray(phi, jnp.float32)
    states = jnp.einsum("sak,k->sa", jnp.asarray(slot_onehot), phi)
    S, Hp = states.shape
    outer = (states[:, :, None] * states[:, None, :]).reshape(S, Hp * Hp)
    return LinearStateArrays(
        states=states, outer=outer,
        abs_states=jnp.asarray(abs_states),
        value_counts=jnp.asarray(value_counts),
        values=phi,
    )


def slice_state_shard(state_axis, n_state_shards: int, arrays):
    """This device's slice of state-indexed arrays under state sharding.

    Shared by all three ET E-step cores (SURVEY §5.7): pads each array's
    leading S axis to a multiple of ``n_state_shards``, takes the
    contiguous per-shard slice at this device's ``axis_index``, and
    returns ``(sliced_list, svalid, own_zs)`` where ``svalid`` masks the
    padding states (logits -> -inf) and ``own_zs`` is 1.0 only on
    state-rank 0 (zero/singleton-state and per-datapoint-scalar owner —
    the caller psums sums over the state axis, so those must count once).
    """
    S = arrays[0].shape[0]
    S_pad = -(-S // n_state_shards) * n_state_shards
    S_loc = S_pad // n_state_shards
    pad = S_pad - S
    srank = jax.lax.axis_index(state_axis)

    def sl(a):
        a_p = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return jax.lax.dynamic_slice_in_dim(a_p, srank * S_loc, S_loc, 0)

    svalid = sl(jnp.ones((S,), jnp.float32))
    own_zs = (srank == 0).astype(jnp.float32)
    return [sl(a) for a in arrays], svalid, own_zs


def per_slot_candidates(P, w_norm, Hp: int, signed_select: bool, gram):
    """Candidate selection + Gram machinery in the per-slot formulation.

    The tiny Hp axis is unrolled, so every op is a large (C,H) GEMM or a
    fused row reduction in the same layout as ``P = y @ W``; no stacked
    (C,Hp,H) one-hot or batched (C,Hp,H)/(C,Hp,Hp) einsum is formed.

    Returns (cand (C,Hp) int32, hots [Hp x (C,H) f32], proj (C,Hp),
    Gf (C,Hp^2) with Gf[:, a*Hp+b] = w_cand_a . w_cand_b).
    """
    from prosper_tpu.core.select import top_hprime_candidate_slots

    f32 = jnp.float32
    Hp = int(Hp)
    cand, hots = top_hprime_candidate_slots(P, w_norm, Hp, signed_select)
    Ts = [jnp.dot(hots[a], gram, preferred_element_type=f32)
          for a in range(Hp)]                                    # Hp x (C,H)
    proj = jnp.stack([jnp.sum(hots[a] * P, axis=1)
                      for a in range(Hp)], axis=1)                   # (C,Hp)
    cols = [None] * (Hp * Hp)
    for a in range(Hp):
        for b in range(a + 1):
            gab = jnp.sum(Ts[a] * hots[b], axis=1)                   # (C,)
            cols[a * Hp + b] = gab
            cols[b * Hp + a] = gab
    Gf = jnp.stack(cols, axis=1)                                 # (C,Hp^2)
    return cand, hots, proj, Gf


def slot_scatter_vec(base, vals, hots):
    """base (C,H) + sum_a hots[a] * vals[:,a] — the candidate-frame ->
    full-H scatter as Hp fused (C,H) broadcast mult-adds."""
    out = base
    for a, hot in enumerate(hots):
        out = out + hot * vals[:, a][:, None]
    return out


def slot_scatter_mat(ssw, hots, H: int):
    """sum_ss[h,k] = sum_n sum_ab hots[a][n,h] ssw[n,a*Hp+b] hots[b][n,k]
    as Hp plain (H,C)x(C,H) GEMMs over fused per-slot intermediates."""
    f32 = jnp.float32
    Hp = len(hots)
    C = ssw.shape[0]
    out = jnp.zeros((H, H), f32)
    for a in range(Hp):
        T2a = jnp.zeros((C, H), f32)
        for b in range(Hp):
            T2a = T2a + hots[b] * ssw[:, a * Hp + b][:, None]
        out = out + jax.lax.dot_general(
            hots[a], T2a, (((0,), (0,)), ((), ())),
            preferred_element_type=f32)
    return out


def _chunk_estats(y, w, W, gram, gram_diag, sigma2, log_odds, sa: LinearStateArrays,
                  Hp: int, signed_select: bool, beta, prior_beta,
                  state_axis=None, n_state_shards: int = 1,
                  dense_gather: bool = True, compute_dtype=None,
                  collect_phi: bool = False, slot_onehot=None,
                  collect_true: bool = True):
    """E-statistics for one chunk of datapoints.

    y : (C, D), w : (C,) accumulation weights (Ncut/partial/padding mask).
    Returns (F, partial-sum pytree).  F is the per-datapoint truncated
    log-pseudo-likelihood *including* all constant terms (used for logging
    free energy and for the next iteration's Ncut ranking).

    State sharding (the sequence-parallel analogue, SURVEY.md §5.7): with
    ``state_axis`` set (inside shard_map over a ('data','state') mesh), the
    S multi-states are split into ``n_state_shards`` contiguous slices; each
    device evaluates only its slice and the softmax is combined across the
    axis with the online-logsumexp algebra (pmax of the running max, psum of
    the rescaled mass) — exactly ring-attention's correction.  The
    zero/singleton parts and the per-datapoint scalars are owned by
    state-rank 0 so nothing is double counted; the caller psums the suff
    stats over BOTH mesh axes.
    """
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    S = sa.states.shape[0]
    f32 = jnp.float32

    inv2s2 = 0.5 / sigma2
    if compute_dtype is not None:
        # explicit low-precision operands / f32 accumulation on the two
        # large GEMMs
        P = jnp.dot(y.astype(compute_dtype), W.astype(compute_dtype),
                    preferred_element_type=f32)                        # (C, H)
    else:
        P = jnp.dot(y, W, preferred_element_type=f32)                  # (C, H)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))

    if dense_gather:
        # candidate selection produces per-slot one-hot masks and every
        # gather becomes a matmul / fused row reduction (see
        # per_slot_candidates)
        cand, hots, proj, Gf = per_slot_candidates(P, w_norm, Hp,
                                                   signed_select, gram)
    else:
        cand = top_hprime_candidates(P, w_norm, Hp, signed_select)      # (C, Hp)
        proj = jnp.take_along_axis(P, cand, axis=1)                     # (C, Hp)
        G = gram[cand[:, :, None], cand[:, None, :]]                    # (C,Hp,Hp)
        Gf = G.reshape(C, Hp * Hp)

    # ---- local slice of the enumerated states -------------------------------
    if state_axis is not None and n_state_shards > 1:
        to_slice = [sa.states, sa.outer, sa.value_counts, sa.abs_states]
        if collect_phi:
            to_slice.append(jnp.asarray(slot_onehot))
        sliced, svalid, own_zs = slice_state_shard(
            state_axis, n_state_shards, to_slice)
        states, outer, vcounts, absst = sliced[:4]
        if collect_phi:
            slot_onehot = sliced[4]
    else:
        states, outer, vcounts, absst = (sa.states, sa.outer,
                                         sa.value_counts, sa.abs_states)
        svalid = jnp.ones((S,), f32)
        own_zs = jnp.float32(1.0)

    neg = jnp.float32(-3e38)

    # ---- log pseudo-joint over the truncated union --------------------------
    lik_multi = (2.0 * jnp.dot(proj, states.T, preferred_element_type=f32)
                 - jnp.dot(Gf, outer.T, preferred_element_type=f32)) * inv2s2
    prior_multi = vcounts @ log_odds                                    # (S_loc,)
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    logits_multi = jnp.where(svalid[None, :] > 0, logits_multi, neg)

    # singletons over ALL H units, one per non-zero value
    v = sa.values                                                       # (K,)
    lik_single = (2.0 * P[:, :, None] * v[None, None, :]
                  - gram_diag[None, :, None] * (v ** 2)[None, None, :]) * inv2s2
    logits_single = beta * lik_single + prior_beta * log_odds[None, None, :]
    logits_single = logits_single.reshape(C, H * K)
    logits_single = jnp.where(own_zs > 0, logits_single, neg)

    zero_logit = jnp.where(own_zs > 0, jnp.zeros((C, 1), f32), neg)
    logits = jnp.concatenate([zero_logit, logits_single, logits_multi], axis=1)

    m = jnp.max(logits, axis=1, keepdims=True)
    if state_axis is not None and n_state_shards > 1:
        m = jax.lax.pmax(m, state_axis)
    p = jnp.exp(logits - m)
    Z_local = jnp.sum(p, axis=1, keepdims=True)
    Z = (jax.lax.psum(Z_local, state_axis)
         if state_axis is not None and n_state_shards > 1 else Z_local)
    q = p / Z                                                            # posterior
    logZ = (m + jnp.log(Z))[:, 0]

    y2 = jnp.sum(y * y, axis=1)                                          # (C,)
    log_p0 = -jnp.log1p(jnp.sum(jnp.exp(log_odds)))  # log pi_0 from odds
    log_norm = 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
    const = -beta * (y2 * inv2s2) - beta * log_norm + prior_beta * H * log_p0
    F = logZ + const                                                     # (C,)

    # un-annealed truncated log-likelihood (beta = prior_beta = 1): the
    # temperature-comparable free energy used for logging / monotonicity.
    # Statically skipped when the caller knows the schedule is saturated
    # (beta == prior_beta == 1): F_true == F exactly, and this second
    # full-width softmax is a large elementwise cost of the steady state
    if collect_true:
        logits_true = jnp.concatenate(
            [zero_logit,
             jnp.where(own_zs > 0,
                       (lik_single + log_odds[None, None, :]).reshape(C, H * K),
                       neg),
             jnp.where(svalid[None, :] > 0, lik_multi + prior_multi[None, :],
                       neg)], axis=1)
        m_t = jnp.max(logits_true, axis=1, keepdims=True)
        if state_axis is not None and n_state_shards > 1:
            m_t = jax.lax.pmax(m_t, state_axis)
            Z_t = jax.lax.psum(
                jnp.sum(jnp.exp(logits_true - m_t), axis=1, keepdims=True),
                state_axis)
        else:
            Z_t = jnp.sum(jnp.exp(logits_true - m_t), axis=1, keepdims=True)
        F_true = ((m_t + jnp.log(Z_t))[:, 0]
                  - y2 * inv2s2 - log_norm + H * log_p0)
    else:
        F_true = F

    # ---- sufficient statistics ---------------------------------------------
    q_single = q[:, 1:1 + H * K].reshape(C, H, K)
    q_multi = q[:, 1 + H * K:]

    s_single = q_single @ v                                              # (C, H)
    ss_diag_single = q_single @ (v ** 2)                                 # (C, H)
    s_cand = jnp.dot(q_multi, states, preferred_element_type=f32)        # (C, Hp)
    ss_cand = jnp.dot(q_multi, outer, preferred_element_type=f32)        # (C, Hp^2)

    wv = w.astype(f32)
    if dense_gather:
        # scatters -> per-slot fused mult-adds + plain GEMMs (copy-free)
        s_full = slot_scatter_vec(s_single, s_cand, hots)                # (C, H)
        sum_ss = slot_scatter_mat(ss_cand * wv[:, None], hots, H)        # (H, H)
    else:
        # flat 1-D scatters (broadcasting-index scatters showed
        # pathological compile times)
        row_base = jnp.arange(C, dtype=jnp.int32)[:, None] * H
        s_flat_idx = (row_base + cand).reshape(-1)
        s_full = (s_single.reshape(-1).at[s_flat_idx].add(s_cand.reshape(-1))
                  .reshape(C, H))                                        # (C, H)
        ss_flat_idx = (cand[:, :, None] * H + cand[:, None, :]).reshape(-1)
        ss3 = (ss_cand.reshape(C, Hp, Hp) * wv[:, None, None]).reshape(-1)
        sum_ss = (jnp.zeros((H * H,), f32).at[ss_flat_idx].add(ss3)
                  .reshape(H, H))

    sw = s_full * wv[:, None]
    if compute_dtype is not None:
        sum_xs = jnp.dot(y.T.astype(compute_dtype), sw.astype(compute_dtype),
                         preferred_element_type=f32)                     # (D, H)
    else:
        sum_xs = jnp.dot(y.T, sw, preferred_element_type=f32)            # (D, H)
    sum_s = jnp.sum(sw, axis=0)                                          # (H,)
    sum_ss_diag = jnp.sum(ss_diag_single * wv[:, None], axis=0)          # (H,)
    sum_ss = sum_ss + jnp.diag(sum_ss_diag)                              # (H, H)

    abs_n = (jnp.sum(q_single, axis=(1, 2))
             + jnp.dot(q_multi, absst, preferred_element_type=f32))
    sum_abs = jnp.sum(abs_n * wv)
    vc_n = jnp.sum(q_single, axis=1) + jnp.dot(q_multi, vcounts,
                                               preferred_element_type=f32)  # (C,K)
    sum_vc = jnp.sum(vc_n * wv[:, None], axis=0)                         # (K,)

    # per-datapoint scalars are owned by state-rank 0 (the caller psums the
    # sums over the state axis too, so contributions must count once)
    sums = dict(
        xs=sum_xs, ss=sum_ss, s=sum_s, abs=sum_abs, vc=sum_vc,
        y2=own_zs * jnp.sum(y2 * wv), n=own_zs * jnp.sum(wv),
        F=own_zs * jnp.sum(F * wv),
        F_true=own_zs * jnp.sum(F_true * wv),
    )

    if collect_phi:
        # Value-set (Phi) learning statistics.  With s = sum_k phi_k b_k
        # (b_k the indicator of value k per unit), the expected complete-data
        # log-likelihood is quadratic in phi; its stationary point solves
        # M phi = c with
        #   c_k  = sum_n w E[b_k]^T W^T y_n
        #   M_kj = sum_n w E[b_k^T (W^T W) b_j]
        # Multi-state part uses the candidate-space posterior; singletons
        # contribute only to the diagonal (one active unit).
        so = jnp.asarray(slot_onehot)                       # (S_loc, Hp, K)
        S_loc = so.shape[0]
        # Qsel[n,a,k] = sum_s q_multi[n,s] so[s,a,k] — one flat (C,S)x(S,Hp*K)
        # GEMM instead of a batched einsum
        Qsel = jnp.dot(q_multi, so.reshape(S_loc, Hp * K),
                       preferred_element_type=f32).reshape(C, Hp, K)
        phi_c_multi = jnp.einsum("nak,na,n->k", Qsel, proj, wv)
        # per-slot form of the QG contraction: the C-axis reduction runs on
        # the FLAT Gf — one (S,C)x(C,Hp^2) GEMM, no re-materialised
        # (C,Hp,Hp) batch; the remaining state-space contraction is tiny
        # (S_loc * Hp^2 * K^2)
        qw = q_multi * wv[:, None]                           # (C, S_loc)
        QGf = jax.lax.dot_general(qw, Gf, (((0,), (0,)), ((), ())),
                                  preferred_element_type=f32)  # (S_loc, Hp^2)
        phi_M_multi = jnp.einsum("sab,sak,sbj->kj",
                                 QGf.reshape(S_loc, Hp, Hp), so, so)
        phi_c_single = jnp.einsum("nhk,nh,n->k", q_single, P, wv)
        phi_M_single = jnp.einsum("nhk,h,n->k", q_single, gram_diag, wv)
        sums["phi_c"] = phi_c_multi + own_zs * phi_c_single
        sums["phi_M"] = phi_M_multi + own_zs * jnp.diag(phi_M_single)

    return F, sums


def _chunk_estats_bigs(y, w, W, gram, gram_diag, sigma2, log_odds,
                       sa: LinearStateArrays, Hp: int, signed_select: bool,
                       beta, prior_beta, s_block: int, compute_dtype=None,
                       state_axis=None, n_state_shards: int = 1,
                       collect_true: bool = True):
    """Big-S E-statistics for one chunk: S-blocked online logsumexp.

    The standard path materialises (C, S) logits; at S ~ 10^4+ the step
    becomes bound by the memory traffic of that tensor.  Here the enumerated states are processed in ``s_block``-sized tiles via
    ``lax.scan`` with flash-attention-style running (max, mass, moment)
    accumulators — the same online-logsumexp algebra the state-sharded path
    applies across devices (SURVEY.md §5.7), applied sequentially within one
    device.  Nothing of size (C, S) is ever materialised.

    Composes with state sharding (SURVEY §5.7's real DSC S=1e5+ regime —
    shard the state axis ACROSS devices, tile the per-device slice in
    s_block chunks): each device scans only its contiguous S/n slice; the
    per-device (max, mass) pairs and moment accumulators are combined with
    the identical online-logsumexp rescale via pmax/psum over
    ``state_axis``.  Zero/singleton states and per-datapoint scalars are
    owned by state-rank 0, exactly as in _chunk_estats.
    """
    C, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    S = sa.states.shape[0]
    f32 = jnp.float32
    neg = jnp.float32(-3e38)
    inv2s2 = 0.5 / sigma2
    sharded = state_axis is not None and n_state_shards > 1

    if compute_dtype is not None:
        P = jnp.dot(y.astype(compute_dtype), W.astype(compute_dtype),
                    preferred_element_type=f32)                      # (C, H)
    else:
        P = jnp.dot(y, W, preferred_element_type=f32)                # (C, H)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    cand, hots, proj, Gf = per_slot_candidates(P, w_norm, Hp, signed_select,
                                               gram)

    # ---- zero + singleton part (small: 1 + H*K columns), rank-0-owned ------
    if sharded:
        own_zs = (jax.lax.axis_index(state_axis) == 0).astype(f32)
    else:
        own_zs = jnp.float32(1.0)
    v = sa.values
    lik_single = (2.0 * P[:, :, None] * v[None, None, :]
                  - gram_diag[None, :, None] * (v ** 2)[None, None, :]) * inv2s2
    logits_single = (beta * lik_single
                     + prior_beta * log_odds[None, None, :]).reshape(C, H * K)
    logits_single = jnp.where(own_zs > 0, logits_single, neg)
    zero_logit = jnp.where(own_zs > 0, 0.0, neg)
    m_a = jnp.maximum(zero_logit, jnp.max(logits_single, axis=1))
    l_a = (jnp.exp(zero_logit - m_a)
           + jnp.sum(jnp.exp(logits_single - m_a[:, None]), 1))
    if collect_true:
        logits_single_t = (lik_single
                           + log_odds[None, None, :]).reshape(C, H * K)
        logits_single_t = jnp.where(own_zs > 0, logits_single_t, neg)
        m_at = jnp.maximum(zero_logit, jnp.max(logits_single_t, axis=1))
        l_at = (jnp.exp(zero_logit - m_at)
                + jnp.sum(jnp.exp(logits_single_t - m_at[:, None]), 1))

    # ---- multi part: scan over state blocks (this device's slice) ----------
    # pad the GLOBAL state axis so each of n_state_shards contiguous slices
    # is a whole number of s_block tiles, then slice locally
    S_loc_raw = -(-S // n_state_shards)
    S_loc = -(-S_loc_raw // s_block) * s_block
    nblocks = S_loc // s_block
    pad = S_loc * n_state_shards - S
    states_p = jnp.pad(sa.states, ((0, pad), (0, 0)))
    outer_p = jnp.pad(sa.outer, ((0, pad), (0, 0)))
    vcounts_p = jnp.pad(sa.value_counts, ((0, pad), (0, 0)))
    absst_p = jnp.pad(sa.abs_states, ((0, pad),))
    prior = vcounts_p @ log_odds
    # mask padded states with an explicit validity vector — encoding the
    # mask as prior=neg silently breaks at prior_beta=0 (a legal public-API
    # argument), corrupting F/q/stats
    valid = (jnp.arange(S_loc * n_state_shards) < S).astype(f32)
    if sharded:
        srank = jax.lax.axis_index(state_axis)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(  # noqa: E731
            a, srank * S_loc, S_loc, 0)
        states_p, outer_p, vcounts_p, absst_p, prior, valid = (
            sl(states_p), sl(outer_p), sl(vcounts_p), sl(absst_p),
            sl(prior), sl(valid))

    # Merged-GEMM scan body.  Each block is exactly TWO GEMMs:
    #   * logits = Xa @ A_b.T — the prior and the padding mask ride
    #     along as two extra CONTRACTION columns (A = [st|ot|pr|mask],
    #     Xa = [2*beta*inv2s2*proj | -beta*inv2s2*Gf | prior_beta | 1]),
    #     eliminating the per-block prior-FMA and mask-where passes;
    #   * acc += p @ B_b — ONE (C,s_block)x(s_block, Hp+Hp^2+K+2) GEMM
    #     produces every accumulator moment (s | ss | vc | abs | mass).
    # The running accumulator is ONE (C, nB) tensor rescaled by r once.
    maskcol = jnp.where(valid > 0, 0.0, neg)[:, None]
    Acols = jnp.concatenate([states_p, outer_p, prior[:, None],
                             maskcol], axis=1)       # (S_loc, nA)
    Bcols = jnp.concatenate([states_p, outer_p, vcounts_p,
                             absst_p[:, None],
                             jnp.ones((S_loc, 1), f32)],
                            axis=1)                  # (S_loc, nB)
    nA = Hp + Hp * Hp + 2
    nB = Hp + Hp * Hp + K + 2
    X = jnp.concatenate([(2.0 * inv2s2) * proj, (-inv2s2) * Gf],
                        axis=1)                      # (C, Hp+Hp^2)
    Xa = jnp.concatenate([beta * X,
                          jnp.full((C, 1), prior_beta, f32),
                          jnp.ones((C, 1), f32)], axis=1)
    if collect_true:
        # un-annealed channel shares A_b: Xt = [X | 1 | 1]
        Xt = jnp.concatenate([X, jnp.ones((C, 2), f32)], axis=1)
    xs = (Acols.reshape(nblocks, s_block, nA),
          Bcols.reshape(nblocks, s_block, nB))

    def body(carry, xb):
        m, m_t, l_t, acc = carry
        A_b, B_b = xb
        logits = jnp.dot(Xa, A_b.T, preferred_element_type=f32)
        m_new = jnp.maximum(m, jnp.max(logits, axis=1))
        r = jnp.exp(m - m_new)
        p = jnp.exp(logits - m_new[:, None])
        acc = acc * r[:, None] + jnp.dot(p, B_b,
                                         preferred_element_type=f32)
        if collect_true:
            logits_t = jnp.dot(Xt, A_b.T, preferred_element_type=f32)
            m_tn = jnp.maximum(m_t, jnp.max(logits_t, axis=1))
            l_t = (l_t * jnp.exp(m_t - m_tn)
                   + jnp.sum(jnp.exp(logits_t - m_tn[:, None]), axis=1))
        else:
            m_tn = m_t
        return (m_new, m_tn, l_t, acc), None

    init = (jnp.full((C,), neg), jnp.full((C,), neg),
            jnp.zeros((C,), f32), jnp.zeros((C, nB), f32))
    (m_b, m_bt, l_bt, acc), _ = jax.lax.scan(body, init, xs)
    a_s = acc[:, :Hp]
    a_ss = acc[:, Hp:Hp + Hp * Hp]
    a_vc = acc[:, Hp + Hp * Hp:Hp + Hp * Hp + K]
    a_abs = acc[:, nB - 2]
    l_b = acc[:, nB - 1]

    # ---- combine the two partial softmaxes (and, sharded, across devices) ---
    M = jnp.maximum(m_a, m_b)
    if sharded:
        M = jax.lax.pmax(M, state_axis)
    Z = l_a * jnp.exp(m_a - M) + l_b * jnp.exp(m_b - M)
    if sharded:
        Z = jax.lax.psum(Z, state_axis)
    logZ = M + jnp.log(Z)

    y2 = jnp.sum(y * y, axis=1)
    log_p0 = -jnp.log1p(jnp.sum(jnp.exp(log_odds)))
    log_norm = 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
    F = logZ - beta * (y2 * inv2s2) - beta * log_norm + prior_beta * H * log_p0
    if collect_true:
        M_t = jnp.maximum(m_at, m_bt)
        if sharded:
            M_t = jax.lax.pmax(M_t, state_axis)
        Z_t = l_at * jnp.exp(m_at - M_t) + l_bt * jnp.exp(m_bt - M_t)
        if sharded:
            Z_t = jax.lax.psum(Z_t, state_axis)
        F_true = (M_t + jnp.log(Z_t)) - y2 * inv2s2 - log_norm + H * log_p0
    else:
        F_true = F

    # normalized posteriors / moments
    q_single = (jnp.exp(logits_single - M[:, None]) / Z[:, None]
                ).reshape(C, H, K)
    scale_b = (jnp.exp(m_b - M) / Z)[:, None]                       # (C, 1)
    s_cand = a_s * scale_b                                          # (C, Hp)
    ss_cand = a_ss * scale_b                                        # (C, Hp^2)
    vc_cand = a_vc * scale_b                                        # (C, K)
    abs_cand = a_abs * scale_b[:, 0]                                # (C,)

    # ---- sufficient statistics (identical algebra to _chunk_estats) ---------
    wv = w.astype(f32)
    s_single = q_single @ v
    ss_diag_single = q_single @ (v ** 2)
    s_full = slot_scatter_vec(s_single, s_cand, hots)
    sum_ss = slot_scatter_mat(ss_cand * wv[:, None], hots, H)
    sw = s_full * wv[:, None]
    if compute_dtype is not None:
        sum_xs = jnp.dot(y.T.astype(compute_dtype), sw.astype(compute_dtype),
                         preferred_element_type=f32)
    else:
        sum_xs = jnp.dot(y.T, sw, preferred_element_type=f32)
    sum_s = jnp.sum(sw, axis=0)
    sum_ss = sum_ss + jnp.diag(jnp.sum(ss_diag_single * wv[:, None], axis=0))

    abs_n = jnp.sum(q_single, axis=(1, 2)) + abs_cand
    vc_n = jnp.sum(q_single, axis=1) + vc_cand
    # per-datapoint scalars are owned by state-rank 0 (the caller psums the
    # sums over the state axis too, so contributions must count once)
    sums = dict(
        xs=sum_xs, ss=sum_ss, s=sum_s,
        abs=jnp.sum(abs_n * wv), vc=jnp.sum(vc_n * wv[:, None], axis=0),
        y2=own_zs * jnp.sum(y2 * wv), n=own_zs * jnp.sum(wv),
        F=own_zs * jnp.sum(F * wv), F_true=own_zs * jnp.sum(F_true * wv),
    )
    return F, sums


def linear_et_estep(y: jnp.ndarray, weight: jnp.ndarray, W: jnp.ndarray,
                    sigma2, log_odds: jnp.ndarray, sa: LinearStateArrays,
                    Hp: int, signed_select: bool, beta, prior_beta,
                    chunk: int = 2048, state_axis=None,
                    n_state_shards: int = 1, compute_dtype=None,
                    collect_phi: bool = False, slot_onehot=None,
                    s_block: int = 0, collect_true: bool = True
                    ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Full-shard E-step with chunked online accumulation.

    Returns (F_per_datapoint (N,), summed-suff-stats dict).  The chunk size
    is static; N must be a multiple of it unless N <= chunk (pad upstream
    with ``weight==0`` rows — see data loaders).  With ``state_axis`` set,
    the enumerated-state dimension is sharded across that mesh axis
    (see _chunk_estats) and the caller must psum the sums over it as well.
    """
    N, D = y.shape
    H = W.shape[1]
    gram = jnp.dot(W.T, W, preferred_element_type=jnp.float32)           # (H, H)
    gram_diag = jnp.diagonal(gram)

    if s_block > 0:
        if collect_phi:
            raise ValueError("s_block (the big-S online-logsumexp path) "
                             "does not compose with Phi learning; use one "
                             "or the other")
        # same one-hot memory guard as the standard path — the bigs
        # formulation is built around the dense one-hot (proj/T/G
        # and the suff-stat scatters), so an oversized (chunk, Hp, H)
        # one-hot is an error here rather than a silent fallback
        if (min(N, chunk) * Hp * H * 4) > 512 * 1024 * 1024:
            raise ValueError(
                f"s_block path: the (chunk={min(N, chunk)}, Hp={Hp}, H={H}) "
                "candidate one-hot would exceed 512MB; shrink chunk")
        body = partial(_chunk_estats_bigs, W=W, gram=gram,
                       gram_diag=gram_diag, sigma2=sigma2,
                       log_odds=log_odds, sa=sa, Hp=Hp,
                       signed_select=signed_select, beta=beta,
                       prior_beta=prior_beta, s_block=s_block,
                       compute_dtype=compute_dtype,
                       state_axis=state_axis,
                       n_state_shards=n_state_shards,
                       collect_true=collect_true)
    else:
        # one-hot GEMM gathers by default; index gathers/scatters when the
        # (chunk, Hp, H) one-hot would be huge
        dense = (min(N, chunk) * Hp * H * 4) <= 512 * 1024 * 1024

        body = partial(_chunk_estats, W=W, gram=gram, gram_diag=gram_diag,
                       sigma2=sigma2, log_odds=log_odds, sa=sa, Hp=Hp,
                       signed_select=signed_select, beta=beta,
                       prior_beta=prior_beta,
                       state_axis=state_axis, n_state_shards=n_state_shards,
                       dense_gather=dense, compute_dtype=compute_dtype,
                       collect_phi=collect_phi, slot_onehot=slot_onehot,
                       collect_true=collect_true)

    if N <= chunk:
        return body(y, weight)

    if N % chunk != 0:
        raise ValueError(f"shard size {N} not a multiple of chunk {chunk}; "
                         "pad the shard (loaders do this) or pick another chunk")
    nchunks = N // chunk
    yc = y.reshape(nchunks, chunk, D)
    wc = weight.reshape(nchunks, chunk)

    def scan_body(carry, xs):
        y_i, w_i = xs
        F_i, sums_i = body(y_i, w_i)
        carry = jax.tree_util.tree_map(jnp.add, carry, sums_i)
        return carry, F_i

    zeros = dict(
        xs=jnp.zeros((D, H), jnp.float32), ss=jnp.zeros((H, H), jnp.float32),
        s=jnp.zeros((H,), jnp.float32), abs=jnp.float32(0.0),
        vc=jnp.zeros_like(log_odds), y2=jnp.float32(0.0),
        n=jnp.float32(0.0), F=jnp.float32(0.0), F_true=jnp.float32(0.0),
    )
    if collect_phi:
        K = log_odds.shape[0]
        zeros["phi_c"] = jnp.zeros((K,), jnp.float32)
        zeros["phi_M"] = jnp.zeros((K, K), jnp.float32)
    sums, F = jax.lax.scan(scan_body, zeros, (yc, wc))
    return F.reshape(N), sums


def chunked_decode(fn, y: jnp.ndarray, chunk: int) -> Dict[str, jnp.ndarray]:
    """Shared serving-decode chunker: run ``fn(chunk_of_y) -> dict`` over
    row-chunks with zero padding to the chunk boundary and slice the outputs
    back to N (bounds per-chunk intermediates at any batch size).

    Transposed-output convention: keys ending in ``_T`` carry the datapoint
    dimension LAST (e.g. s_mean as (H, C)); they are transposed back and the
    suffix stripped here, OUTSIDE the chunk loop, so the stacked per-chunk
    loop buffer's minor dim is the chunk axis and each chunk writes whole
    tiles; the single transpose per output happens once on the final
    array."""
    N = y.shape[0]

    def unT(out, n_pad, stacked):
        res = {}
        for k, v in out.items():
            if k.endswith("_T"):
                if stacked:
                    v = jnp.moveaxis(v, 0, -2)              # (d.., nc, C)
                    v = v.reshape(v.shape[:-2] + (n_pad,))  # (d.., N_pad)
                res[k[:-2]] = jnp.moveaxis(v, -1, 0)[:N]
            else:
                if stacked:
                    v = v.reshape((n_pad,) + v.shape[2:])
                res[k] = v[:N]
        return res

    if N <= chunk:
        return unT(fn(y), N, stacked=False)
    N_pad = -(-N // chunk) * chunk
    y_pad = jnp.pad(y, ((0, N_pad - N), (0, 0))) if N_pad != N else y
    yc = y_pad.reshape(N_pad // chunk, chunk, y.shape[1])
    return unT(jax.lax.map(fn, yc), N_pad, stacked=True)


def top_states_outputs(q: jnp.ndarray, L: int, H: int, K: int,
                       values: jnp.ndarray, multi_states: jnp.ndarray,
                       onehot: jnp.ndarray, dense: bool
                       ) -> Dict[str, jnp.ndarray]:
    """Top-L posterior states from the q columns ``[zero | singles | multi]``.

    Shared by the linear/GSC/max decoders.  ``dense=True`` returns full-H
    vectors ``top_states (N, L, H)``; ``dense=False`` returns the compact
    form instead:

      top_single_unit  (N, L) int32  unit index of singleton states, -1 else
      top_single_value (N, L)        its value (0 for zero/multi states)
      top_cand_states  (N, L, Hp)    multi-state values over the candidate
                                     set (all-zero rows for zero/singleton)

    plus ``top_probs`` in both forms; the caller adds ``cand``.  Use
    ``densify_top_states`` to reconstruct the dense tensor exactly.
    """
    from prosper_tpu.core.select import top_l_argmax

    f32 = jnp.float32
    N = q.shape[0]
    S, Hp = multi_states.shape
    top_q, top_u = top_l_argmax(q, L)
    u = top_u - 1                                         # -1 -> zero state
    is_single = (u >= 0) & (u < H * K)
    sh = jnp.where(is_single, u // K, 0)
    sv = jnp.where(is_single, values[jnp.clip(u % K, 0, K - 1)], 0.0)
    s_idx = jnp.clip(u - H * K, 0, S - 1)
    is_multi = u >= H * K
    if dense:
        single_vec = jax.nn.one_hot(sh, H, dtype=f32) * sv[..., None]
        mcv = multi_states[s_idx] * is_multi[..., None]   # (N, L, Hp)
        if isinstance(onehot, (list, tuple)):
            # per-slot fused scatter: Hp broadcast mult-adds on the
            # (N, L, H) output — no stacked (N, Hp, H) tensor
            out = single_vec
            for a, hot in enumerate(onehot):
                out = out + mcv[:, :, a][:, :, None] * hot[:, None, :]
        else:
            out = single_vec + jnp.einsum("nla,nah->nlh", mcv, onehot)
        # _T convention (see chunked_decode)
        return {"top_probs_T": top_q.T,
                "top_states_T": jnp.transpose(out, (1, 2, 0))}
    # compact: states gathered by one-hot GEMM; outputs transposed
    # (datapoint dim last) per the chunked_decode _T convention
    su = jax.nn.one_hot(s_idx, S, dtype=f32) * is_multi[..., None]
    mcv = jnp.dot(su.reshape(N * L, S), multi_states,
                  preferred_element_type=f32).reshape(N, L, Hp)
    return {"top_probs_T": top_q.T,
            "top_single_unit_T":
                jnp.where(is_single, sh, -1).astype(jnp.int32).T,
            "top_single_value_T": sv.T,
            "top_cand_states_T": jnp.transpose(mcv, (1, 2, 0))}


def densify_top_states(out: Dict[str, jnp.ndarray], H: int) -> jnp.ndarray:
    """Reconstruct dense ``top_states (N, L, H)`` from a compact decode
    (``inference(..., dense_states=False)``) — bit-identical to the dense
    path; run on host/CPU or small batches, not in the serving hot loop."""
    f32 = jnp.float32
    unit = out["top_single_unit"]
    sv = out["top_single_value"]
    single_vec = (jax.nn.one_hot(jnp.maximum(unit, 0), H, dtype=f32)
                  * sv[..., None])
    cand_hot = jax.nn.one_hot(out["cand"], H, dtype=f32)     # (N, Hp, H)
    multi_vec = jnp.einsum("nla,nah->nlh", out["top_cand_states"], cand_hot)
    return single_vec + multi_vec


def linear_et_posterior(y: jnp.ndarray, W: jnp.ndarray, sigma2,
                        log_odds: jnp.ndarray, sa: LinearStateArrays,
                        Hp: int, signed_select: bool, top_L: int = 10,
                        beta=1.0, prior_beta=1.0,
                        chunk: int = 4096,
                        dense_states: bool = True) -> Dict[str, jnp.ndarray]:
    """Chunked posterior decode — bounds the decode's intermediates (the
    (N,Hp,H) one-hot alone is >1GB at serving scale); the (H,H) Gram is
    computed once, outside the chunk loop."""
    gram = jnp.dot(W.T, W, preferred_element_type=jnp.float32)
    gram_diag = jnp.diagonal(gram)
    return chunked_decode(
        lambda y_i: _linear_et_posterior_chunk(
            y_i, W, gram, gram_diag, sigma2, log_odds, sa, Hp, signed_select,
            top_L, beta, prior_beta, dense_states), y, chunk)


def _linear_et_posterior_chunk(y: jnp.ndarray, W: jnp.ndarray,
                               gram: jnp.ndarray, gram_diag: jnp.ndarray,
                               sigma2, log_odds: jnp.ndarray,
                               sa: LinearStateArrays,
                               Hp: int, signed_select: bool, top_L: int = 10,
                               beta=1.0, prior_beta=1.0,
                               dense_states: bool = True
                               ) -> Dict[str, jnp.ndarray]:
    """Posterior decode for held-out data (reference: CAModel.inference,
    SURVEY.md §3.3): per datapoint the top-L truncated states sorted by
    posterior probability, the posterior mean <s>, the reconstruction
    W<s>, and the truncated log-likelihood F.

    Returns dict with:
      top_states (N, L, H)  full-H latent vectors of the L best states
                            (``dense_states=True``; with False the compact
                            fields from ``top_states_outputs`` + ``cand``
                            replace it)
      top_probs  (N, L)     their posterior probabilities
      s_mean     (N, H)     posterior mean of s
      recon      (N, D)     W @ <s>
      F          (N,)       truncated log-pseudo-likelihood
    """
    f32 = jnp.float32
    N, D = y.shape
    H = W.shape[1]
    K = sa.values.shape[0]
    S = sa.states.shape[0]
    beta = jnp.asarray(beta, f32)
    prior_beta = jnp.asarray(prior_beta, f32)

    inv2s2 = 0.5 / sigma2
    P = jnp.dot(y, W, preferred_element_type=f32)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    cand, hots, proj, Gf = per_slot_candidates(P, w_norm, Hp, signed_select,
                                               gram)
    lik_multi = (2.0 * jnp.dot(proj, sa.states.T, preferred_element_type=f32)
                 - jnp.dot(Gf, sa.outer.T, preferred_element_type=f32)) * inv2s2
    prior_multi = sa.value_counts @ log_odds
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    v = sa.values
    lik_single = (2.0 * P[:, :, None] * v[None, None, :]
                  - gram_diag[None, :, None] * (v ** 2)[None, None, :]) * inv2s2
    logits_single = (beta * lik_single
                     + prior_beta * log_odds[None, None, :]).reshape(N, H * K)
    logits = jnp.concatenate(
        [jnp.zeros((N, 1), f32), logits_single, logits_multi], axis=1)

    m = jnp.max(logits, axis=1, keepdims=True)
    p = jnp.exp(logits - m)
    Z = jnp.sum(p, axis=1, keepdims=True)
    q = p / Z

    y2 = jnp.sum(y * y, axis=1)
    log_p0 = -jnp.log1p(jnp.sum(jnp.exp(log_odds)))
    F = ((m + jnp.log(Z))[:, 0] - beta * (y2 * inv2s2)
         - beta * 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
         + prior_beta * H * log_p0)

    # posterior mean (scatter-free: dense one-hot GEMMs), computed with the
    # datapoint dim LAST (_T convention, see chunked_decode) so the chunk
    # loop's stacked buffers take full-tile writes
    q_single = q[:, 1:1 + H * K].reshape(N, H, K)
    q_multi = q[:, 1 + H * K:]
    s_cand = jnp.dot(q_multi, sa.states, preferred_element_type=f32)
    s_meanT = slot_scatter_vec(q_single @ v, s_cand, hots).T
    reconT = jnp.dot(W, s_meanT, preferred_element_type=f32)     # (D, C)

    out = top_states_outputs(q, top_L, H, K, v, sa.states, hots,
                             dense_states)
    if not dense_states:
        out["cand_T"] = cand.T
    out.update({"s_mean_T": s_meanT, "recon_T": reconT, "F": F})
    return out


def truncated_prior_logmass(log_pi_active, H: int, gamma: int):
    """log A_gamma and log B_gamma for the ET corrections, in log space.

    A = sum_{k<=gamma} C(H,k) pi_a^k (1-pi_a)^(H-k)   (prior mass of |s|<=gamma)
    B = sum_{k<=gamma} k * C(H,k) pi_a^k (1-pi_a)^(H-k)  (so B/A = E_trunc|s|)

    where pi_a is the probability that a unit is active (sum over non-zero
    values).  Used by the pi M-step correction and the Ncut keep fraction
    (SURVEY.md §2 "BSC-ET" M-step row: "ET correction factor").
    """
    from scipy.special import gammaln
    ks = jnp.arange(gamma + 1, dtype=jnp.float32)
    log_comb = jnp.asarray(
        [float(gammaln(H + 1) - gammaln(k + 1) - gammaln(H - k + 1))
         for k in range(gamma + 1)], jnp.float32)
    log_1m = jnp.log(-jnp.expm1(jnp.minimum(log_pi_active, -1e-8)))
    terms = log_comb + ks * log_pi_active + (H - ks) * log_1m
    logA = jax.nn.logsumexp(terms)
    # B: k=0 term vanishes; add log k for k>=1
    logk = jnp.log(jnp.maximum(ks, 1.0))
    termsB = jnp.where(ks >= 1, terms + logk, -jnp.inf)
    logB = jax.nn.logsumexp(termsB)
    return logA, logB
