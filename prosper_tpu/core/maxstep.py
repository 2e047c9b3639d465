"""The ET E-step for max-superposition models (MCA, MMCA).

Reference behavior: SURVEY.md §2 rows "MCA-ET" (prosper/em/camodels/mca_et.py)
and "MMCA-ET" (mmca_et.py) — mount unavailable, behavior-level parity:

  MCA :  ybar_d = max_{h active} W_dh         (occlusion-like non-linear
                                               superposition, W >= 0 data)
  MMCA:  ybar_d = W_dh*,  h* = argmax_{h active} |W_dh|   (signed variant)

with isotropic Gaussian noise and a Bernoulli(pi) prior, and an M-step that
distributes each observed dimension's responsibility onto its causes: the
hard winner by default (rho <= 0), or an annealed softened max
A propto exp(rho (K_h - K_max)/|K_max|) when the 'rho' annealing channel is
scheduled (scale-invariant and sign-safe; rho -> inf gives the hard winner).

Formulation: unlike the linear family, `max` admits no Gram shortcut, so
the reconstruction ybar IS materialised per (datapoint, state, dim) — but
only for one (chunk x S x D) tile at a time, with the chunk size chosen so
the tile stays well inside the device's working memory.  The winner indices from the
max computation are reused for the M-step responsibilities, so the heavy
tile is built exactly once.  The zero state and the H singleton states are
closed-form as in the linear family (SURVEY.md §2 "ET base").
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from prosper_tpu.core.etstep import LinearStateArrays
from prosper_tpu.core.select import top_hprime_candidates


def _subset_dp_plan(states_np):
    """Static DP plan over the subset lattice of the enumerated states.

    States are binary supports over the Hp candidate slots, enumerated by
    size (core/states.py::binary_state_space).  Each size-m state extends a
    unique size-(m-1) parent (drop its largest active slot), so the
    winner-take-all reconstruction can be built level by level with ONE
    elementwise max per state instead of Hp passes over the full
    (chunk, S, D) tile.  Returns [(parent_pos, add_slot)] per level m>=2,
    where parent_pos indexes the previous level's array (level 1 = the Hp
    singleton slots themselves), plus a permutation check that
    concatenating levels reproduces the global state order.
    """
    import numpy as np

    act = states_np > 0.5
    sizes = act.sum(axis=1).astype(int)
    order = []
    levels = []
    pos_of = {}                 # active-tuple -> position within its level
    for m in range(2, sizes.max() + 1):
        rows = np.flatnonzero(sizes == m)
        parent_pos, add_slot = [], []
        for j, r in enumerate(rows):
            sup = tuple(np.flatnonzero(act[r]))
            pos_of[sup] = j
            parent = sup[:-1]
            parent_pos.append(parent[0] if m == 2 else pos_of[parent])
            add_slot.append(sup[-1])
        levels.append((np.asarray(parent_pos, np.int32),
                       np.asarray(add_slot, np.int32)))
        order.extend(rows.tolist())
    assert order == list(range(states_np.shape[0])), (
        "state enumeration is not size-ordered; DP plan needs the "
        "binary_state_space ordering")
    return levels


def _dp_winner_tile(Wc, states_np, magnitude, collect=("ybar",)):
    """Winner tile over all multi states via the subset-lattice DP — same
    results as the Hp-pass masked-max loop, ~Hp/2x less VPU work.

    Returns (out, aux): ``out`` maps each requested name in ``collect``
    ("ybar" / "key") to its (C, S, D) concatenation; ``aux`` carries the
    per-level plan and 'added slot wins' masks for the responsibility flow
    DP.  Only requested tensors are concatenated/materialised — the hard
    path needs just ybar (key feeds only the softened-max branch, which
    rebuilds it inside its own lax.cond branch so the memory traffic is
    paid only when rho > 0 actually executes).
    """
    C, Hp, D = Wc.shape
    f32 = jnp.float32
    key1 = jnp.abs(Wc) if magnitude else Wc                      # (C,Hp,D)

    plan = _subset_dp_plan(states_np)
    ybar_prev, key_prev = Wc, key1
    outs = {name: [] for name in collect}
    masks = []
    for parent_pos, add_slot in plan:
        pp = jnp.asarray(parent_pos)
        aa = jnp.asarray(add_slot)
        pv = jnp.take(ybar_prev, pp, axis=1)
        kv = jnp.take(key_prev, pp, axis=1)
        va = jnp.take(Wc, aa, axis=1)
        ka = jnp.take(key1, aa, axis=1)
        better = ka > kv
        ybar_prev = jnp.where(better, va, pv).astype(f32)
        key_prev = jnp.where(better, ka, kv).astype(f32)
        if "ybar" in outs:
            outs["ybar"].append(ybar_prev)
        if "key" in outs:
            outs["key"].append(key_prev)
        masks.append(better)
    return ({name: jnp.concatenate(v, axis=1) for name, v in outs.items()},
            (plan, masks))


def _dp_hard_resp(qa, plan, masks, Hp):
    """Hard winner responsibilities A[n,h,d] = sum_s qa[n,s]·[winner=h] via
    a reverse flow over the subset lattice: each state's mass goes to its
    added slot where that slot won (mask) and flows to its parent state
    otherwise — one elementwise pass + two small contractions per level
    instead of Hp masked (C,S,D) reductions."""
    f32 = jnp.float32
    C = qa.shape[0]
    D = masks[0].shape[2]
    sizes = [len(p[0]) for p in plan]
    offs = [0]
    for s_l in sizes:
        offs.append(offs[-1] + s_l)

    A = jnp.zeros((C, Hp, D), f32)
    inflow = None
    for lev in range(len(plan) - 1, -1, -1):
        parent_pos, add_slot = plan[lev]
        s_l = sizes[lev]
        w = jnp.broadcast_to(
            qa[:, offs[lev]:offs[lev] + s_l, None], masks[lev].shape)
        if inflow is not None:
            w = w + inflow
        m = masks[lev].astype(f32)
        win = w * m
        oh_add = jax.nn.one_hot(jnp.asarray(add_slot), Hp, dtype=f32)
        A = A + jnp.einsum("nsd,sh->nhd", win, oh_add)
        down = w - win
        if lev > 0:
            oh_par = jax.nn.one_hot(jnp.asarray(parent_pos),
                                    sizes[lev - 1], dtype=f32)
            inflow = jnp.einsum("nsd,sp->npd", down, oh_par)
        else:
            # level-2 parents ARE the singleton slots
            oh_par = jax.nn.one_hot(jnp.asarray(parent_pos), Hp, dtype=f32)
            A = A + jnp.einsum("nsd,sh->nhd", down, oh_par)
    return A


def _chunk_max_estats(y, w, W, gram_diag, sigma2, log_odds_scalar,
                      sa: LinearStateArrays, Hp: int, magnitude: bool,
                      beta, prior_beta, rho=0.0, dp_winner: bool = True,
                      state_axis=None, n_state_shards: int = 1,
                      collect_true: bool = True):
    """E-statistics for one chunk: union {0} ∪ {singletons} ∪ {multi}."""
    C, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    f32 = jnp.float32
    inv2s2 = 0.5 / sigma2

    # ---- local slice of the enumerated states (SURVEY §5.7: the state axis
    # is sharded like the linear family's, with the same online-logsumexp
    # combine; the subset-lattice DP needs the GLOBAL lattice, so sharded
    # shards use the per-state fori formulation on their slice)
    if state_axis is not None and n_state_shards > 1:
        from prosper_tpu.core.etstep import slice_state_shard
        (states_l, absst), svalid, own_zs = slice_state_shard(
            state_axis, n_state_shards, [sa.states, sa.abs_states])
        S = states_l.shape[0]
        dp_winner = False
    else:
        states_l, absst = sa.states, sa.abs_states
        svalid = jnp.ones((S,), f32)
        own_zs = jnp.float32(1.0)

    P = jnp.dot(y, W, preferred_element_type=f32)                       # (C,H)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    from prosper_tpu.core.select import top_hprime_candidates_dense
    cand, onehot = top_hprime_candidates_dense(P, w_norm, Hp, magnitude)
    Wc = jnp.dot(onehot.reshape(C * Hp, H), W.T,
                 preferred_element_type=f32).reshape(C, Hp, D)           # (C,Hp,D)

    # ---- reconstruction per multi state: winner-take-all over active slots
    act = states_l > 0.5                                                # (S,Hp) bool
    neg_inf = jnp.float32(-3e38)

    dp_aux = None
    best = key_val = None
    if dp_winner:
        # subset-lattice DP: one masked max per state (each size-m state
        # extends its size-(m-1) parent) instead of Hp full (C,S,D) passes;
        # only the ybar tile is materialised (best is never needed in this
        # path, key only inside the soft-rho branch)
        import numpy as _np
        tile, dp_aux = _dp_winner_tile(
            Wc, _np.asarray(sa.states), magnitude, collect=("ybar",))
        ybar = tile["ybar"]
        y_dot = jnp.einsum("nd,nsd->ns", y, ybar)                       # (C,S)
        ybar2 = jnp.sum(ybar * ybar, axis=2)                            # (C,S)
    else:
        # reference formulation (fori_loop rather than a Python unroll:
        # the unrolled (C,S,D) chain made remote compiles take minutes)
        def win_body(h, carry):
            ybar, best, key_val = carry
            vh = jax.lax.dynamic_slice_in_dim(Wc, h, 1, axis=1)         # (C,1,D)
            kh = jnp.abs(vh) if magnitude else vh
            act_h = jax.lax.dynamic_slice_in_dim(act, h, 1, axis=1)     # (S,1)
            kh = jnp.where(act_h[None, :, 0, None], kh, neg_inf)        # (C,S,D)
            better = kh > key_val
            return (jnp.where(better, vh, ybar),
                    jnp.where(better, h, best),
                    jnp.where(better, kh, key_val))

        ybar, best, key_val = jax.lax.fori_loop(
            0, Hp, win_body,
            (jnp.full((C, S, D), neg_inf), jnp.zeros((C, S, D), jnp.int32),
             jnp.full((C, S, D), neg_inf)))
        # every REAL multi state has >=2 active slots; padded states (state
        # sharding) have none — zero their ybar so downstream arithmetic
        # stays finite (their logits are masked to neg via svalid anyway)
        ybar = jnp.where(key_val > neg_inf / 2, ybar, 0.0)
        y_dot = jnp.einsum("nd,nsd->ns", y, ybar)                       # (C,S)
        ybar2 = jnp.sum(ybar * ybar, axis=2)                            # (C,S)
    lik_multi = (2.0 * y_dot - ybar2) * inv2s2
    prior_multi = absst * log_odds_scalar                               # (S,)
    logits_multi = beta * lik_multi + prior_beta * prior_multi[None, :]
    logits_multi = jnp.where(svalid[None, :] > 0, logits_multi, neg_inf)

    # ---- singletons over ALL H (ybar = W_h for both MCA and MMCA);
    # zero/singleton states are owned by state-rank 0
    lik_single = (2.0 * P - gram_diag[None, :]) * inv2s2                # (C,H)
    logits_single = beta * lik_single + prior_beta * log_odds_scalar
    logits_single = jnp.where(own_zs > 0, logits_single, neg_inf)

    zero_logit = jnp.where(own_zs > 0, jnp.zeros((C, 1), f32), neg_inf)
    logits = jnp.concatenate([zero_logit, logits_single, logits_multi], 1)
    m = jnp.max(logits, axis=1, keepdims=True)
    if state_axis is not None and n_state_shards > 1:
        m = jax.lax.pmax(m, state_axis)
    p = jnp.exp(logits - m)
    Z_local = jnp.sum(p, axis=1, keepdims=True)
    Z = (jax.lax.psum(Z_local, state_axis)
         if state_axis is not None and n_state_shards > 1 else Z_local)
    q = p / Z
    logZ = (m + jnp.log(Z))[:, 0]

    y2 = jnp.sum(y * y, axis=1)
    log_p0 = -jnp.log1p(jnp.exp(log_odds_scalar))
    log_norm = 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
    F = logZ + (-beta * (y2 * inv2s2) - beta * log_norm
                + prior_beta * H * log_p0)

    # un-annealed channel — statically dropped when saturated (F_true == F)
    if collect_true:
        logits_true = jnp.concatenate(
            [zero_logit,
             jnp.where(own_zs > 0, lik_single + log_odds_scalar, neg_inf),
             jnp.where(svalid[None, :] > 0, lik_multi + prior_multi[None, :],
                       neg_inf)], 1)
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

    q_zero = q[:, 0]
    q_single = q[:, 1:1 + H]                                            # (C,H)
    q_multi = q[:, 1 + H:]                                              # (C,S)
    wv = w.astype(f32)

    # ---- <s> and activity (q_single/q_zero are exactly zero on non-owner
    # state shards — the neg logits above — so local sums psum correctly)
    s_cand = jnp.dot(q_multi, states_l, preferred_element_type=f32)     # (C,Hp)
    s_full = q_single + jnp.einsum("na,nah->nh", s_cand, onehot)
    sum_s = jnp.sum(s_full * wv[:, None], axis=0)
    abs_n = jnp.sum(q_single, axis=1) + jnp.dot(
        q_multi, absst, preferred_element_type=f32)
    sum_abs = jnp.sum(abs_n * wv)

    # ---- winner responsibilities for the M-step:
    #   hard (rho <= 0): A_ndh = sum_s q_ns [slot h wins dim d in state s]
    #   soft (rho > 0):  A_ndh = sum_s q_ns exp(rho (K_h-K_max)/|K_max|) / Z
    # The soft form is the reference-style annealed softened max — relative
    # gaps make the rho schedule scale-invariant (like the W^rho ratio form)
    # while staying sign-safe; rho -> inf recovers the hard winner.
    qa = q_multi * wv[:, None]                                          # (C,S)

    def hard_resp():
        if dp_aux is not None:
            return _dp_hard_resp(qa, dp_aux[0], dp_aux[1], Hp)

        def body(h, accA):
            mask_h = ((best == h) & (key_val > neg_inf / 2)).astype(f32)
            acc_h = jnp.einsum("ns,nsd->nd", qa, mask_h)
            return jax.lax.dynamic_update_slice_in_dim(
                accA, acc_h[:, None, :], h, axis=1)
        return jax.lax.fori_loop(0, Hp, body, jnp.zeros((C, Hp, D), f32))

    def soft_resp():
        # value-space softened max: A propto exp(rho * (K_h - K_max)) — well
        # defined for any sign of W (a ratio form K^rho/K_max^rho misbehaves
        # for negative losers), bounded <= 1, and -> the hard winner as
        # rho -> inf.  Needs the full (C,S,D) winner-key tile; in the DP
        # path it is rebuilt HERE so the tile only costs memory traffic when
        # the rho>0 branch actually executes at runtime
        if dp_aux is not None:
            import numpy as _np
            kv_full = _dp_winner_tile(
                Wc, _np.asarray(sa.states), magnitude,
                collect=("key",))[0]["key"]
        else:
            kv_full = key_val
        kv_scale = jnp.maximum(jnp.abs(kv_full), 1e-6)   # scale invariance

        def powers(h):
            vh = jax.lax.dynamic_slice_in_dim(Wc, h, 1, axis=1)
            kh = jnp.abs(vh) if magnitude else vh
            act_h = jax.lax.dynamic_slice_in_dim(act_f, h, 1, axis=1)
            gap = jnp.minimum(kh - kv_full, 0.0) / kv_scale             # <= 0
            return act_h[None, :, 0, None] * jnp.exp(rho * gap)         # (C,S,D)

        def dbody(h, denom):
            return denom + powers(h)
        denom = jax.lax.fori_loop(0, Hp, dbody,
                                  jnp.full((C, S, D), 1e-20, f32))

        def nbody(h, accA):
            A_h = powers(h) / denom
            acc_h = jnp.einsum("ns,nsd->nd", qa, A_h)
            return jax.lax.dynamic_update_slice_in_dim(
                accA, acc_h[:, None, :], h, axis=1)
        return jax.lax.fori_loop(0, Hp, nbody, jnp.zeros((C, Hp, D), f32))

    act_f = act.astype(f32)
    accA = jax.lax.cond(rho > 0, soft_resp, hard_resp)                  # (C,Hp,D)

    # (C,Hp,D) -> (H,D) via one-hot GEMMs, plus singleton contributions
    denom = jnp.einsum("nah,nad->hd", onehot, accA)                     # (H,D)
    numer = jnp.einsum("nah,nad->hd", onehot, accA * y[:, None, :])
    qsw = q_single * wv[:, None]
    denom = denom + jnp.sum(qsw, axis=0)[:, None]                       # (H,D)
    numer = numer + jnp.dot(qsw.T, y, preferred_element_type=f32)       # (H,D)

    # ---- noise residual <||y - ybar||^2>
    resid_multi = jnp.einsum("ns,ns->n", q_multi, y2[:, None] - 2 * y_dot + ybar2)
    resid_single = jnp.sum(
        q_single * (y2[:, None] - 2.0 * P + gram_diag[None, :]), axis=1)
    resid = q_zero * y2 + resid_single + resid_multi
    sum_resid = jnp.sum(resid * wv)

    # per-datapoint scalars are owned by state-rank 0 (the caller psums
    # sums over the state axis too, so contributions must count once)
    sums = dict(
        numer=numer, denom=denom, s=sum_s, abs=sum_abs,
        resid=sum_resid, y2=own_zs * jnp.sum(y2 * wv),
        n=own_zs * jnp.sum(wv),
        F=own_zs * jnp.sum(F * wv), F_true=own_zs * jnp.sum(F_true * wv),
    )
    return F, sums


def max_et_posterior(y: jnp.ndarray, W: jnp.ndarray, sigma2,
                     log_odds_scalar, sa: LinearStateArrays, Hp: int,
                     magnitude: bool, top_L: int = 10,
                     beta=1.0, prior_beta=1.0,
                     chunk: int = 256,
                     dense_states: bool = True) -> Dict[str, jnp.ndarray]:
    """Chunked posterior decode for max models — the (chunk, S, D)
    reconstruction tile must stay bounded exactly as in training."""
    from prosper_tpu.core.etstep import chunked_decode
    return chunked_decode(
        lambda y_i: _max_et_posterior_chunk(
            y_i, W, sigma2, log_odds_scalar, sa, Hp, magnitude, top_L,
            beta, prior_beta, dense_states), y, chunk)


def _max_et_posterior_chunk(y: jnp.ndarray, W: jnp.ndarray, sigma2,
                            log_odds_scalar, sa: LinearStateArrays, Hp: int,
                            magnitude: bool, top_L: int = 10,
                            beta=1.0, prior_beta=1.0,
                            dense_states: bool = True) -> Dict[str, jnp.ndarray]:
    """Posterior decode for max models (reference: inference, SURVEY §3.3).

    Returns top_states/top_probs (full-H binary vectors over the truncated
    union), s_mean, the posterior-mean reconstruction E[ybar], and F.
    """
    f32 = jnp.float32
    N, D = y.shape
    H = W.shape[1]
    S = sa.states.shape[0]
    beta = jnp.asarray(beta, f32)
    prior_beta = jnp.asarray(prior_beta, f32)
    gram_diag = jnp.sum(W * W, axis=0)
    inv2s2 = 0.5 / sigma2

    P = jnp.dot(y, W, preferred_element_type=f32)
    w_norm = jnp.sqrt(jnp.maximum(gram_diag, 1e-30))
    from prosper_tpu.core.select import top_hprime_candidates_dense
    cand, onehot = top_hprime_candidates_dense(P, w_norm, Hp, magnitude)
    Wc = jnp.dot(onehot.reshape(N * Hp, H), W.T,
                 preferred_element_type=f32).reshape(N, Hp, D)

    act = sa.states > 0.5
    neg_inf = jnp.float32(-3e38)
    ybar = jnp.full((N, S, D), neg_inf)
    key_val = jnp.full((N, S, D), neg_inf)
    for h in range(Hp):
        vh = Wc[:, h, :][:, None, :]
        kh = jnp.abs(vh) if magnitude else vh
        kh = jnp.where(act[None, :, h, None], kh, neg_inf)
        better = kh > key_val
        key_val = jnp.where(better, kh, key_val)
        ybar = jnp.where(better, vh, ybar)

    y_dot = jnp.einsum("nd,nsd->ns", y, ybar)
    ybar2 = jnp.sum(ybar * ybar, axis=2)
    lik_multi = (2.0 * y_dot - ybar2) * inv2s2
    prior_multi = sa.abs_states * log_odds_scalar
    lik_single = (2.0 * P - gram_diag[None, :]) * inv2s2
    logits = jnp.concatenate(
        [jnp.zeros((N, 1), f32),
         beta * lik_single + prior_beta * log_odds_scalar,
         beta * lik_multi + prior_beta * prior_multi[None, :]], 1)
    m = jnp.max(logits, axis=1, keepdims=True)
    p = jnp.exp(logits - m)
    Z = jnp.sum(p, axis=1, keepdims=True)
    q = p / Z

    y2 = jnp.sum(y * y, axis=1)
    log_p0 = -jnp.log1p(jnp.exp(log_odds_scalar))
    F = ((m + jnp.log(Z))[:, 0] - beta * (y2 * inv2s2)
         - beta * 0.5 * D * jnp.log(2.0 * jnp.pi * sigma2)
         + prior_beta * H * log_p0)

    q_single = q[:, 1:1 + H]
    q_multi = q[:, 1 + H:]
    # posterior means with the datapoint dim LAST (_T convention,
    # chunked_decode round-3 decode fix)
    s_cand = jnp.dot(q_multi, sa.states, preferred_element_type=f32)
    s_meanT = q_single.T + jnp.einsum("na,nah->hn", s_cand, onehot)
    reconT = (jnp.dot(W, q_single.T, preferred_element_type=f32)
              + jnp.einsum("ns,nsd->dn", q_multi,
                           jnp.where(ybar > neg_inf / 2, ybar, 0.0)))

    from prosper_tpu.core.etstep import top_states_outputs
    out = top_states_outputs(q, top_L, H, 1, jnp.ones((1,), f32), sa.states,
                             onehot, dense_states)
    if not dense_states:
        out["cand_T"] = cand.T
    out.update({"s_mean_T": s_meanT, "recon_T": reconT, "F": F})
    return out


def max_et_estep(y: jnp.ndarray, weight: jnp.ndarray, W: jnp.ndarray,
                 sigma2, log_odds_scalar, sa: LinearStateArrays, Hp: int,
                 magnitude: bool, beta, prior_beta,
                 chunk: int = 256, rho=0.0,
                 dp_winner: bool = True, state_axis=None,
                 n_state_shards: int = 1,
                 collect_true: bool = True) -> Tuple[jnp.ndarray, Dict]:
    """Full-shard max-superposition E-step, chunked like linear_et_estep.

    ``chunk`` bounds the (chunk, S, D) reconstruction tile; pick it so
    chunk * S * D * ~16 bytes fits comfortably in device memory.
    With ``state_axis`` the enumerated states are sharded over that mesh
    axis (SURVEY §5.7) and the caller must psum the sums over it as well.
    """
    N, D = y.shape
    H = W.shape[1]
    gram_diag = jnp.sum(W * W, axis=0)

    body = partial(_chunk_max_estats, W=W, gram_diag=gram_diag,
                   sigma2=sigma2, log_odds_scalar=log_odds_scalar, sa=sa,
                   Hp=Hp, magnitude=magnitude, beta=beta,
                   prior_beta=prior_beta, rho=rho, dp_winner=dp_winner,
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
        y_i, w_i = xs
        F_i, sums_i = body(y_i, w_i)
        return jax.tree_util.tree_map(jnp.add, carry, sums_i), F_i

    zeros = dict(
        numer=jnp.zeros((H, D), jnp.float32), denom=jnp.zeros((H, D), jnp.float32),
        s=jnp.zeros((H,), jnp.float32), abs=jnp.float32(0.0),
        resid=jnp.float32(0.0), y2=jnp.float32(0.0), n=jnp.float32(0.0),
        F=jnp.float32(0.0), F_true=jnp.float32(0.0),
    )
    sums, F = jax.lax.scan(scan_body, zeros, (yc, wc))
    return F.reshape(N), sums
