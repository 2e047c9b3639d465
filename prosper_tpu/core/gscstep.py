"""The ET E-step for spike-and-slab / Gaussian sparse coding (GSC).

Reference behavior: SURVEY.md §2 row "GSC (spike-and-slab / Gaussian SC)"
(prosper/em/camodels/gsc.py — mount unavailable): latents s_h = b_h * z_h
with b ~ Bernoulli(pi), z ~ N(mu, psi); binary supports are enumerated (ET
truncation) and the continuous slab is integrated out in closed form per
support:

  log p(y|s) = -D/2 log(2 pi sigma^2) - ||y||^2/(2 sigma^2) - k/2 log psi
               - 1/2 log det M_s - k mu^2/(2 psi) + 1/2 b_s^T M_s^-1 b_s

  M_s = I/psi + W_s^T W_s / sigma^2          (k x k posterior precision)
  b_s = W_s^T y / sigma^2 + (mu/psi) 1       (natural parameter)
  q(z|y,s) = N(kappa_s = M_s^-1 b_s,  Sigma_s = M_s^-1)

Formulation: supports have varying size k, which would mean ragged
linear algebra.  We instead pad every support system to a fixed (Hp x Hp)
matrix with identity rows/columns on inactive slots:

  det(M_pad) = det(M_active),   M_pad^-1 b_pad restricted to the support
  equals the true kappa, and the padded inverse carries the identity on
  inactive slots (masked out when accumulating <s z z s^T>).

This turns the whole E-step into ONE batched (chunk*S, Hp, Hp) Cholesky —
static shapes, vmap-friendly, exactly the "batched small-matrix
cholesky over states" called out in SURVEY.md §2.  Gram entries come from
the same (H,H) precompute as the linear family; no (N,S,D) tensors exist.

Sufficient statistics share the linear family's schema (xs, ss, s, abs, y2,
n, F, F_true) — the slab M-step needs only sum(s) and trace(ss) extras:
  sum_z  = sum_h <s_h z_h>      = sums['s'].sum()
  sum_z2 = sum_h <s_h z_h^2>    = trace(sums['ss'])
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from prosper_tpu.core.etstep import LinearStateArrays
from prosper_tpu.core.select import top_hprime_candidates


# ---------------------------------------------------------------------------
# Hand-rolled batched small-matrix linalg.
#
# Since Hp is a small static constant (<= ~10), the Cholesky-Banachiewicz
# recurrences are unrolled over columns instead of calling
# jnp.linalg.cholesky / cho_solve on (B, Hp, Hp) batches: every step is one
# vectorised elementwise op over the whole (chunk*S) batch (the "batched
# small-matrix cholesky over states" design of SURVEY.md §7 M3).  Whether
# the batched library calls do as well on the GPU is open (ROADMAP 1.4).
# ---------------------------------------------------------------------------

def chol_small(M: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular Cholesky of SPD matrices, unrolled over the (small,
    static) matrix dimension; batch dims arbitrary.  M: (..., n, n)."""
    n = M.shape[-1]
    L = jnp.zeros_like(M)
    arange = jnp.arange(n)
    for j in range(n):
        if j > 0:
            # s_i = sum_{k<j} L_ik L_jk
            s = jnp.einsum("...ik,...k->...i", L[..., :, :j], L[..., j, :j])
            col = M[..., :, j] - s
        else:
            col = M[..., :, j]
        d = jnp.sqrt(jnp.maximum(col[..., j], 1e-30))
        colL = col / d[..., None]
        L = L.at[..., :, j].set(jnp.where(arange >= j, colL, L[..., :, j]))
    return L


def cho_logdet_small(L: jnp.ndarray) -> jnp.ndarray:
    """log det(M) from its Cholesky factor."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), -1)


def cho_solve_vec_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve M x = b with M = L L^T; b: (..., n)."""
    n = L.shape[-1]
    y = jnp.zeros_like(b)
    for i in range(n):
        s = (jnp.einsum("...k,...k->...", L[..., i, :i], y[..., :i])
             if i > 0 else 0.0)
        y = y.at[..., i].set((b[..., i] - s) / L[..., i, i])
    x = jnp.zeros_like(b)
    for i in range(n - 1, -1, -1):
        s = (jnp.einsum("...k,...k->...", L[..., i + 1:, i], x[..., i + 1:])
             if i < n - 1 else 0.0)
        x = x.at[..., i].set((y[..., i] - s) / L[..., i, i])
    return x


def cho_inverse_small(L: jnp.ndarray) -> jnp.ndarray:
    """Full inverse of M = L L^T via unrolled triangular solves against I."""
    n = L.shape[-1]
    batch = L.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), batch + (n, n))
    # forward: L Y = I  (rows of Y computed top-down), Y: (..., n, n)
    Y = jnp.zeros_like(eye)
    for i in range(n):
        s = (jnp.einsum("...k,...km->...m", L[..., i, :i], Y[..., :i, :])
             if i > 0 else 0.0)
        Y = Y.at[..., i, :].set((eye[..., i, :] - s) / L[..., i, i][..., None])
    # backward: L^T X = Y
    X = jnp.zeros_like(eye)
    for i in range(n - 1, -1, -1):
        s = (jnp.einsum("...k,...km->...m", L[..., i + 1:, i],
                        X[..., i + 1:, :]) if i < n - 1 else 0.0)
        X = X.at[..., i, :].set((Y[..., i, :] - s) / L[..., i, i][..., None])
    return X


# ---------------------------------------------------------------------------
# Batch-last small linalg: the (C,S,Hp,Hp) layout above puts Hp (<=10) in
# the minor dimension, so every unrolled step materialises a tensor with a
# tiny minor axis.  The batch-last form keeps each matrix ENTRY as a flat
# (C*S,) vector and unrolls the recurrences over scalar indices: ~Hp^3 fused
# elementwise ops over big vectors.
# ---------------------------------------------------------------------------

def chol_bl(M):
    """Cholesky of entry-wise matrices: M[i][j] (i>=j) are (B,) vectors."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            t = M[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    return L


def logdet_bl(L):
    out = jnp.log(L[0][0])
    for j in range(1, len(L)):
        out = out + jnp.log(L[j][j])
    return 2.0 * out


def solve_bl(L, b):
    """Solve (L L^T) x = b; b is a list of (B,) vectors (or scalars).
    Python-constant zeros are skipped, so unit-vector solves (inverse_bl)
    emit no dead ops."""
    def is0(v):
        return isinstance(v, float) and v == 0.0

    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            if not is0(y[k]):
                s = s - L[i][k] * y[k]
        y[i] = 0.0 if is0(s) else s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            if not is0(x[k]):
                s = s - L[k][i] * x[k]
        x[i] = 0.0 if is0(s) else s / L[i][i]
    return x


def inverse_bl(L):
    """Sig[i][j] (full symmetric) of (L L^T)^-1, entry-wise."""
    n = len(L)
    Sig = [[None] * n for _ in range(n)]
    for j in range(n):
        col = solve_bl(L, [1.0 if i == j else 0.0 for i in range(n)])
        for i in range(j, n):
            Sig[i][j] = col[i]
            Sig[j][i] = col[i]
    return Sig


def _gsc_level_plan(act_np):
    """Group enumerated supports by size m (static host combinatorics).

    States from binary_state_space are size-ordered, so each level is a
    contiguous [off, off+S_m) slice of the state axis.  Returns
    [(off, idx_m)] with idx_m the (S_m, m) active-slot indices per state.
    The padded Hp x Hp systems spend ~m^3/Hp^3 of their recurrence work on
    real entries (8/216 at m=2), so solving each level at its true size
    removes ~90% of it.
    """
    import numpy as np

    sizes = act_np.astype(bool).sum(axis=1)
    plan = []
    off = 0
    for m in range(int(sizes.min()), int(sizes.max()) + 1):
        rows = np.flatnonzero(sizes == m)
        if rows.size == 0:
            continue
        assert rows[0] == off and rows[-1] == off + rows.size - 1, (
            "state enumeration is not size-ordered")
        idx = np.stack([np.flatnonzero(act_np[r]) for r in rows])
        plan.append((off, idx.astype(np.int32)))
        off += rows.size
    return plan


def _gsc_shard_level_arrays(act_np, n_shards: int):
    """Level-ALIGNED shard layout (host combinatorics).

    SPMD state sharding traces ONE program for every shard, so per-shard
    static level plans are only possible if every shard's local slice has
    the SAME level structure.  This builds it: each size-m level's states
    are dealt round-robin over the shards and padded per (level, shard) to
    L_m = ceil(S_m / n_shards); the E/EE gather tensors become arrays with
    a leading shard axis (sliced by ``lax.axis_index`` on device) instead
    of host-baked constants.  Padding states use slots (0..m-1) — a real
    SPD system, masked out of the logits via svalid.

    Returns (S_loc, levels) with levels = [(m, L_m, E_np, EE_np, sl)]:
      E_np  (m, n_shards, L_m, Hp)       per-active-slot one-hots
      EE_np (m, m, n_shards, L_m, Hp*Hp) slot-pair outer one-hots (i >= j)
      sl                                  slice [off, off+L_m) in local order
    plus per-shard states/svalid/absst (n_shards, S_loc, ...) arrays.
    """
    import numpy as np

    act = act_np.astype(bool)
    Hp = act.shape[1]
    sizes = act.sum(axis=1)
    eye = np.eye(Hp, dtype=np.float32)
    levels = []
    states_sh, svalid_sh, absst_sh = [], [], []
    off = 0
    for m in range(int(sizes.min()), int(sizes.max()) + 1):
        rows = np.flatnonzero(sizes == m)
        if rows.size == 0:
            continue
        L_m = -(-rows.size // n_shards)
        idx = np.zeros((n_shards, L_m, m), np.int32)
        valid = np.zeros((n_shards, L_m), np.float32)
        st = np.zeros((n_shards, L_m, Hp), np.float32)
        for r in range(n_shards):
            sub = rows[r::n_shards]
            for k in range(L_m):
                if k < sub.size:
                    ii = np.flatnonzero(act[sub[k]])
                    valid[r, k] = 1.0
                else:
                    ii = np.arange(m)
                idx[r, k] = ii
                st[r, k, ii] = 1.0
        E_np = np.stack([eye[idx[:, :, i]] for i in range(m)])
        EE_np = np.zeros((m, m, n_shards, L_m, Hp * Hp), np.float32)
        for i in range(m):
            for j in range(i + 1):
                EE_np[i, j] = (eye[idx[:, :, i]][..., :, None]
                               * eye[idx[:, :, j]][..., None, :]
                               ).reshape(n_shards, L_m, Hp * Hp)
        levels.append((m, L_m, E_np, EE_np, slice(off, off + L_m)))
        states_sh.append(st)
        svalid_sh.append(valid)
        absst_sh.append(np.full((n_shards, L_m), float(m), np.float32))
        off += L_m
    return (off, levels,
            np.concatenate(states_sh, axis=1),
            np.concatenate(svalid_sh, axis=1),
            np.concatenate(absst_sh, axis=1))


def _chunk_gsc_estats(y, w, W, gram, gram_diag, sigma2, pi, mu, psi,
                      sa: LinearStateArrays, Hp: int, beta, prior_beta,
                      batch_last: bool = True, state_axis=None,
                      n_state_shards: int = 1, collect_true: bool = True):
    C, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    f32 = jnp.float32

    inv_s2 = 1.0 / sigma2
    inv_psi = 1.0 / psi
    log_odds = jnp.log(pi) - jnp.log1p(-pi)

    # ---- local slice of the enumerated supports (SURVEY §5.7), in the
    # LEVEL-ALIGNED layout so every shard keeps the level-grouped
    # batch-last solver.  batch_last=False still selects the padded
    # tensor path (kept as the oracle formulation + for tests).
    sharded = state_axis is not None and n_state_shards > 1
    shard_levels = None
    if sharded and batch_last:
        import numpy as _np
        S_loc, lvls, st_np, sv_np, ab_np = _gsc_shard_level_arrays(
            _np.asarray(sa.states) > 0.5, n_state_shards)
        srank = jax.lax.axis_index(state_axis)

        def take(a_np):
            return jax.lax.dynamic_index_in_dim(
                jnp.asarray(a_np), srank, 0, keepdims=False)

        states_l = take(st_np)
        svalid = take(sv_np)
        absst = take(ab_np)
        own_zs = (srank == 0).astype(f32)
        S = S_loc
        shard_levels = []
        for m, L_m, E_np, EE_np, sl in lvls:
            E = [take(E_np[i]) for i in range(m)]                 # (L_m,Hp)
            EE = {(i, j): take(EE_np[i, j])
                  for i in range(m) for j in range(i + 1)}
            shard_levels.append((sl.start, L_m, m, E, EE))
    elif sharded:
        from prosper_tpu.core.etstep import slice_state_shard
        (states_l, absst), svalid, own_zs = slice_state_shard(
            state_axis, n_state_shards, [sa.states, sa.abs_states])
        S = states_l.shape[0]
    else:
        states_l, absst = sa.states, sa.abs_states
        svalid = jnp.ones((S,), f32)
        own_zs = jnp.float32(1.0)

    P = jnp.dot(y, W, preferred_element_type=f32)                       # (C,H)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    if batch_last:
        # per-slot formulation: no stacked (C,Hp,H) one-hot and no batched
        # (C,Hp,Hp) T/G einsums.  Shared machinery: core/etstep.py.
        from prosper_tpu.core.etstep import per_slot_candidates
        _, hots, proj, G_flat = per_slot_candidates(P, w_norm, Hp, True,
                                                    gram)
    else:
        from prosper_tpu.core.select import top_hprime_candidates_dense
        cand, onehot = top_hprime_candidates_dense(P, w_norm, Hp,
                                                   signed=True)
        proj = jnp.einsum("nah,nh->na", onehot, P)                      # (C,Hp)
        T = jnp.dot(onehot.reshape(C * Hp, H), gram,
                    preferred_element_type=f32).reshape(C, Hp, H)
        G = jnp.einsum("nak,nbk->nab", T, onehot)                   # (C,Hp,Hp)

    act = (states_l > 0.5).astype(f32)                                  # (S,Hp)
    k_s = absst                                                         # (S,)

    # padded per-(datapoint,state) posterior precision and natural params:
    # M_pad = act_a*act_b*G/sigma2 + diag(act/psi + (1-act))
    if batch_last:
        # level-grouped entry-wise layout: states of support size m solve
        # an m x m system (not a padded Hp x Hp one) as flat (C*S_m,)
        # entry vectors with fully packed lanes; Gram sub-blocks and the
        # natural parameter are gathered per level with STATIC one-hot
        # GEMMs (no act masking needed — every gathered entry is active).
        # Sharded: the per-level E/EE come pre-sliced for THIS shard from
        # the level-aligned layout (identical static structure per shard).
        if shard_levels is None:
            import numpy as _np

            plan = _gsc_level_plan(_np.asarray(sa.states) > 0.5)
            level_defs = []
            for off, idx in plan:
                S_m, m = idx.shape
                E = [jnp.asarray(_np.eye(Hp, dtype=_np.float32)[idx[:, i]])
                     for i in range(m)]                                 # (S_m,Hp)
                EE = {}
                for i in range(m):
                    for j in range(i + 1):
                        EE[(i, j)] = jnp.asarray(
                            (_np.eye(Hp, dtype=_np.float32)[idx[:, i]][:, :, None]
                             * _np.eye(Hp, dtype=_np.float32)[idx[:, j]][:, None, :]
                             ).reshape(S_m, Hp * Hp))
                level_defs.append((off, S_m, m, E, EE))
        else:
            level_defs = shard_levels
        bsrc = proj * inv_s2 + mu * inv_psi                             # (C,Hp)
        logdet_parts, bMb_parts = [], []
        level_data = []          # (off, S_m, m, E, EE, kap, Sig entries)
        for off, S_m, m, E, EE in level_defs:
            B_m = C * S_m
            Mbl = [[None] * m for _ in range(m)]
            for i in range(m):
                for j in range(i + 1):
                    e = jnp.dot(G_flat, EE[(i, j)].T,
                                preferred_element_type=f32) * inv_s2    # (C,S_m)
                    if i == j:
                        e = e + inv_psi
                    Mbl[i][j] = e.reshape(B_m)
            bbl = [jnp.dot(bsrc, E[i].T,
                           preferred_element_type=f32).reshape(B_m)
                   for i in range(m)]
            L = chol_bl(Mbl)
            logdet_parts.append(logdet_bl(L).reshape(C, S_m))
            kap = solve_bl(L, bbl)
            Sig_lvl = inverse_bl(L)
            bMb_parts.append(
                sum(bbl[i] * kap[i] for i in range(m)).reshape(C, S_m))
            level_data.append((off, S_m, m, E, EE, kap, Sig_lvl))
        logdet = jnp.concatenate(logdet_parts, axis=1)                  # (C,S)
        bMb = jnp.concatenate(bMb_parts, axis=1)                        # (C,S)
    else:
        act_ab = act[:, :, None] * act[:, None, :]                      # (S,Hp,Hp)
        eye = jnp.eye(Hp, dtype=f32)
        diag_term = act * inv_psi + (1.0 - act)                         # (S,Hp)
        M = (act_ab[None] * (G[:, None] * inv_s2)
             + jnp.einsum("sh,hk->shk", diag_term, eye)[None])          # (C,S,Hp,Hp)
        b = act[None] * (proj[:, None, :] * inv_s2 + mu * inv_psi)      # (C,S,Hp)

        chol = chol_small(M)                                            # (C,S,Hp,Hp)
        logdet = cho_logdet_small(chol)                                 # (C,S)
        kappa = cho_solve_vec_small(chol, b)                            # (C,S,Hp)
        Sig = cho_inverse_small(chol)                                   # (C,S,Hp,Hp)

        bMb = jnp.sum(b * kappa, axis=-1)                               # (C,S)
    y2 = jnp.sum(y * y, axis=1)                                         # (C,)

    lik_multi = (-0.5 * k_s[None, :] * jnp.log(psi)
                 - 0.5 * logdet
                 - k_s[None, :] * (mu * mu) * (0.5 * inv_psi)
                 + 0.5 * bMb)                                           # (C,S)
    prior_multi = k_s * log_odds                                        # (S,)
    neg_inf = jnp.float32(-3e38)
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    logits_multi = jnp.where(svalid[None, :] > 0, logits_multi, neg_inf)

    # singletons over ALL H (k = 1, scalar algebra); zero/singletons are
    # owned by state-rank 0 under state sharding
    M1 = inv_psi + gram_diag * inv_s2                                   # (H,)
    b1 = P * inv_s2 + mu * inv_psi                                      # (C,H)
    kappa1 = b1 / M1[None, :]
    lik_single = (-0.5 * jnp.log(psi) - 0.5 * jnp.log(M1)[None, :]
                  - (mu * mu) * (0.5 * inv_psi) + 0.5 * b1 * kappa1)
    logits_single = beta * lik_single + prior_beta * log_odds
    logits_single = jnp.where(own_zs > 0, logits_single, neg_inf)

    zero_logit = jnp.where(own_zs > 0, jnp.zeros((C, 1), f32), neg_inf)
    logits = jnp.concatenate([zero_logit, logits_single, logits_multi], 1)
    m = jnp.max(logits, axis=1, keepdims=True)
    if sharded:
        m = jax.lax.pmax(m, state_axis)
    p = jnp.exp(logits - m)
    Z_local = jnp.sum(p, axis=1, keepdims=True)
    Z = jax.lax.psum(Z_local, state_axis) if sharded else Z_local
    q = p / Z
    logZ = (m + jnp.log(Z))[:, 0]

    log_norm = 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
    log_1mpi = jnp.log1p(-pi)
    F = logZ + (-beta * (0.5 * y2 * inv_s2) - beta * log_norm
                + prior_beta * H * log_1mpi)
    # un-annealed channel — statically dropped when saturated (F_true == F)
    if collect_true:
        logits_true = jnp.concatenate(
            [zero_logit,
             jnp.where(own_zs > 0, lik_single + log_odds, neg_inf),
             jnp.where(svalid[None, :] > 0, lik_multi + prior_multi[None, :],
                       neg_inf)], axis=1)
        m_t = jnp.max(logits_true, axis=1, keepdims=True)
        if sharded:
            m_t = jax.lax.pmax(m_t, state_axis)
            Z_t = jax.lax.psum(
                jnp.sum(jnp.exp(logits_true - m_t), axis=1, keepdims=True),
                state_axis)
        else:
            Z_t = jnp.sum(jnp.exp(logits_true - m_t), axis=1, keepdims=True)
        F_true = ((m_t + jnp.log(Z_t))[:, 0]
                  - 0.5 * y2 * inv_s2 - log_norm + H * log_1mpi)
    else:
        F_true = F

    q_single = q[:, 1:1 + H]                                            # (C,H)
    q_multi = q[:, 1 + H:]                                              # (C,S)
    wv = w.astype(f32)

    # ---- sufficient statistics over the continuous latents sz = b*z
    if batch_last:
        # accumulate <sz> and <sz sz^T> into the (Hp) candidate frame with
        # the same static one-hot GEMMs, level by level
        sz_cand = jnp.zeros((C, Hp), f32)
        szsz_flat = jnp.zeros((C, Hp * Hp), f32)
        for off, S_m, m, E, EE, kap, Sig_lvl in level_data:
            q_m = q_multi[:, off:off + S_m]                             # (C,S_m)
            kap_cs = [kap[i].reshape(C, S_m) for i in range(m)]
            for i in range(m):
                sz_cand = sz_cand + jnp.dot(q_m * kap_cs[i], E[i],
                                            preferred_element_type=f32)
                for j in range(i + 1):
                    val = q_m * (Sig_lvl[i][j].reshape(C, S_m)
                                 + kap_cs[i] * kap_cs[j])               # (C,S_m)
                    ee = EE[(i, j)]
                    if i != j:
                        # symmetric scatter: (a_i,a_j) and (a_j,a_i)
                        ee = ee + jnp.asarray(
                            ee.reshape(S_m, Hp, Hp).transpose(0, 2, 1)
                            .reshape(S_m, Hp * Hp))
                    szsz_flat = szsz_flat + jnp.dot(
                        val, ee, preferred_element_type=f32)
    else:
        sz_cand = jnp.einsum("ns,nsh->nh", q_multi, kappa)              # (C,Hp)
        outer = (Sig * act_ab[None]
                 + kappa[..., :, None] * kappa[..., None, :])
        szsz_cand = jnp.einsum("ns,nsab->nab", q_multi, outer)          # (C,Hp,Hp)

    sz_single = q_single * kappa1                                       # (C,H)
    Sig1 = 1.0 / M1                                                     # (H,)
    szsz_diag_single = q_single * (Sig1[None, :] + kappa1 ** 2)         # (C,H)

    # scatters -> one-hot GEMMs (see core/select.py)
    if batch_last:
        # per-slot fused scatters (shared w/ etstep.py)
        from prosper_tpu.core.etstep import (slot_scatter_mat,
                                             slot_scatter_vec)
        sz_full = slot_scatter_vec(sz_single, sz_cand, hots)
    else:
        sz_full = sz_single + jnp.einsum("na,nah->nh", sz_cand, onehot)

    sw = sz_full * wv[:, None]
    sum_xs = jnp.dot(y.T, sw, preferred_element_type=f32)               # (D,H)
    sum_s = jnp.sum(sw, axis=0)                                         # (H,)
    sum_ss_diag = jnp.sum(szsz_diag_single * wv[:, None], axis=0)       # (H,)

    if batch_last:
        sum_ss = slot_scatter_mat(szsz_flat * wv[:, None], hots, H)
    else:
        ssw = szsz_cand * wv[:, None, None]
        T2 = jnp.einsum("nab,nbh->nah", ssw, onehot)                # (C,Hp,H)
        sum_ss = jnp.einsum("nah,nak->hk", onehot, T2)              # (H,H)
    sum_ss = sum_ss + jnp.diag(sum_ss_diag)

    abs_n = jnp.sum(q_single, axis=1) + jnp.dot(
        q_multi, k_s, preferred_element_type=f32)
    sum_abs = jnp.sum(abs_n * wv)

    # per-datapoint scalars owned by state-rank 0 (caller psums over the
    # state axis too)
    sums = dict(
        xs=sum_xs, ss=sum_ss, s=sum_s, abs=sum_abs,
        y2=own_zs * jnp.sum(y2 * wv), n=own_zs * jnp.sum(wv),
        F=own_zs * jnp.sum(F * wv), F_true=own_zs * jnp.sum(F_true * wv),
    )
    return F, sums


def gsc_posterior(y: jnp.ndarray, W: jnp.ndarray, sigma2, pi, mu, psi,
                  sa: LinearStateArrays, Hp: int, top_L: int = 10,
                  beta=1.0, prior_beta=1.0,
                  chunk: int = 1024,
                  dense_states: bool = True) -> Dict[str, jnp.ndarray]:
    """Chunked posterior decode for GSC — bounds the (chunk,S,Hp,Hp)
    per-support linalg tiles at serving scale."""
    from prosper_tpu.core.etstep import chunked_decode
    return chunked_decode(
        lambda y_i: _gsc_posterior_chunk(
            y_i, W, sigma2, pi, mu, psi, sa, Hp, top_L, beta, prior_beta,
            dense_states),
        y, chunk)


def _gsc_posterior_chunk(y: jnp.ndarray, W: jnp.ndarray, sigma2, pi, mu, psi,
                         sa: LinearStateArrays, Hp: int, top_L: int = 10,
                         beta=1.0, prior_beta=1.0,
                         dense_states: bool = True) -> Dict[str, jnp.ndarray]:
    """Posterior decode for GSC: support probabilities p(b_h=1|y), slab
    means <s_h z_h>, reconstruction W<sz>, top supports, and F."""
    f32 = jnp.float32
    N, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    beta = jnp.asarray(beta, f32)
    prior_beta = jnp.asarray(prior_beta, f32)

    gram = jnp.dot(W.T, W, preferred_element_type=f32)
    gram_diag = jnp.diagonal(gram)
    inv_s2 = 1.0 / sigma2
    inv_psi = 1.0 / psi
    log_odds = jnp.log(pi) - jnp.log1p(-pi)

    P = jnp.dot(y, W, preferred_element_type=f32)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    from prosper_tpu.core.etstep import per_slot_candidates
    cand, hots, proj, Gf = per_slot_candidates(P, w_norm, Hp, True, gram)
    G = Gf.reshape(N, Hp, Hp)

    act = (sa.states > 0.5).astype(f32)
    k_s = sa.abs_states
    act_ab = act[:, :, None] * act[:, None, :]
    eye = jnp.eye(Hp, dtype=f32)
    diag_term = act * inv_psi + (1.0 - act)
    M = (act_ab[None] * (G[:, None] * inv_s2)
         + jnp.einsum("sh,hk->shk", diag_term, eye)[None])
    b = act[None] * (proj[:, None, :] * inv_s2 + mu * inv_psi)
    chol = chol_small(M)
    logdet = cho_logdet_small(chol)
    kappa = cho_solve_vec_small(chol, b)
    bMb = jnp.sum(b * kappa, axis=-1)

    lik_multi = (-0.5 * k_s[None, :] * jnp.log(psi) - 0.5 * logdet
                 - k_s[None, :] * (mu * mu) * (0.5 * inv_psi) + 0.5 * bMb)
    prior_multi = k_s * log_odds
    M1 = inv_psi + gram_diag * inv_s2
    b1 = P * inv_s2 + mu * inv_psi
    kappa1 = b1 / M1[None, :]
    lik_single = (-0.5 * jnp.log(psi) - 0.5 * jnp.log(M1)[None, :]
                  - (mu * mu) * (0.5 * inv_psi) + 0.5 * b1 * kappa1)
    logits = jnp.concatenate(
        [jnp.zeros((N, 1), f32),
         beta * lik_single + prior_beta * log_odds,
         beta * lik_multi + prior_beta * prior_multi[None, :]], 1)
    m = jnp.max(logits, axis=1, keepdims=True)
    p = jnp.exp(logits - m)
    Z = jnp.sum(p, axis=1, keepdims=True)
    q = p / Z
    y2 = jnp.sum(y * y, axis=1)
    F = ((m + jnp.log(Z))[:, 0] - beta * (0.5 * y2 * inv_s2)
         - beta * 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
         + prior_beta * H * jnp.log1p(-pi))

    q_single = q[:, 1:1 + H]
    q_multi = q[:, 1 + H:]
    # support posterior p(b_h = 1 | y); posterior means computed with the
    # datapoint dim LAST (_T convention, chunked_decode round-3 decode fix)
    from prosper_tpu.core.etstep import slot_scatter_vec, top_states_outputs
    b_cand = jnp.dot(q_multi, act, preferred_element_type=f32)
    b_meanT = slot_scatter_vec(q_single, b_cand, hots).T
    # slab means <s_h z_h>
    sz_cand = jnp.einsum("ns,nsh->nh", q_multi, kappa)
    sz_meanT = slot_scatter_vec(q_single * kappa1, sz_cand, hots).T
    reconT = jnp.dot(W, sz_meanT, preferred_element_type=f32)    # (D, C)

    out = top_states_outputs(q, top_L, H, 1, jnp.ones((1,), f32), act,
                             hots, dense_states)
    if not dense_states:
        out["cand_T"] = cand.T
    out.update({"b_mean_T": b_meanT, "s_mean_T": sz_meanT,
                "recon_T": reconT, "F": F})
    return out


def gsc_et_estep(y: jnp.ndarray, weight: jnp.ndarray, W: jnp.ndarray,
                 sigma2, pi, mu, psi, sa: LinearStateArrays, Hp: int,
                 beta, prior_beta, chunk: int = 1024,
                 batch_last: bool = True, state_axis=None,
                 n_state_shards: int = 1,
                 collect_true: bool = True) -> Tuple[jnp.ndarray, Dict]:
    N, D = y.shape
    H = W.shape[1]
    gram = jnp.dot(W.T, W, preferred_element_type=jnp.float32)
    gram_diag = jnp.diagonal(gram)

    body = partial(_chunk_gsc_estats, W=W, gram=gram, gram_diag=gram_diag,
                   sigma2=sigma2, pi=pi, mu=mu, psi=psi, sa=sa, Hp=Hp,
                   beta=beta, prior_beta=prior_beta, batch_last=batch_last,
                   state_axis=state_axis, n_state_shards=n_state_shards,
                   collect_true=collect_true)
    if N <= chunk:
        return body(y, weight)
    if N % chunk != 0:
        raise ValueError(f"shard size {N} not a multiple of chunk {chunk}")
    nchunks = N // chunk
    yc = y.reshape(nchunks, chunk, D)
    wc = weight.reshape(nchunks, chunk)

    def scan_body(carry, xs):
        F_i, sums_i = body(*xs)
        return jax.tree_util.tree_map(jnp.add, carry, sums_i), F_i

    zeros = dict(
        xs=jnp.zeros((D, H), jnp.float32), ss=jnp.zeros((H, H), jnp.float32),
        s=jnp.zeros((H,), jnp.float32), abs=jnp.float32(0.0),
        y2=jnp.float32(0.0), n=jnp.float32(0.0),
        F=jnp.float32(0.0), F_true=jnp.float32(0.0),
    )
    sums, F = jax.lax.scan(scan_body, zeros, (yc, wc))
    return F.reshape(N), sums
