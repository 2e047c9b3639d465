"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline metric (BASELINE.json): E-step datapoints/s/GPU on the scaling
config "BSC on natural image patches": D=16x16=256, H=300, H'=8, gamma=4.
The reference publishes no perf numbers, so ``vs_baseline`` is measured
against a reference-equivalent vectorized NumPy/BLAS implementation of the
same truncated E-step on this host's CPU — the reference's compute stack
(SURVEY.md §0 "all heavy math goes through NumPy->BLAS").

Beyond the headline, ``families`` holds a per-model-family matrix, and each
entry carries achieved TFLOP/s and, on a device in ``PEAK_TFLOPS``, the
useful-FLOPs utilisation against that device's peak.  ``device`` names the
GPU every number was taken on (platform, kind, count, each card's name and
power limit).  The harness refuses to run without a GPU, and exits non-zero
when any family fails.

Run ``python bench.py`` for the full matrix, ``python bench.py bsc tsc``
for a subset.
"""

import json
import sys
import time
import traceback

import numpy as np


# ---- configs ----------------------------------------------------------------
D, H, Hp, GAMMA = 256, 300, 8, 4        # headline: BSC patches config
N_DEV = 131072
CHUNK = 8192
N_CPU = 2048
ITERS = 10

#: ``dps`` times ITERS separately dispatched steps; ``dps_chained`` times
#: CHAIN_ITERS steps chained inside ONE jitted lax.scan (the production
#: shape — engine.EM.run_scanned dispatches whole segments the same way).
CHAIN_ITERS = 50

#: dense tensor-core peaks, TFLOP/s, by ``device_kind`` (NVIDIA's H100 SXM
#: data sheet, at the 700 W power limit).  float32 dots run as TF32 under
#: JAX's default matmul precision on this card, so MFU divides by "tf32".
#: A device not in this table gets no MFU field.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0},
}


def numpy_baseline_dps(y, W, sigma, pi):
    """Reference-equivalent vectorized NumPy E-step (suff stats incl.)."""
    import itertools

    N = y.shape[0]
    states = []
    for k in range(2, GAMMA + 1):
        for sup in itertools.combinations(range(Hp), k):
            s = np.zeros(Hp)
            s[list(sup)] = 1.0
            states.append(s)
    SM = np.array(states)                     # (S, Hp)
    log_odds = np.log(pi) - np.log1p(-pi)
    inv2s2 = 0.5 / sigma ** 2

    t0 = time.perf_counter()
    P = y @ W                                  # (N, H)
    wn = np.linalg.norm(W, axis=0)
    cand = np.argpartition(-(P / wn), Hp, axis=1)[:, :Hp]       # (N, Hp)
    gram = W.T @ W
    proj = np.take_along_axis(P, cand, axis=1)                  # (N, Hp)
    G = gram[cand[:, :, None], cand[:, None, :]]                # (N, Hp, Hp)
    lik_multi = (2 * proj @ SM.T
                 - np.einsum("nab,sa,sb->ns", G, SM, SM)) * inv2s2
    gd = np.diag(gram)
    lik_single = (2 * P - gd[None, :]) * inv2s2                 # (N, H)
    logits = np.concatenate(
        [np.zeros((N, 1)),
         lik_single + log_odds,
         lik_multi + SM.sum(1)[None, :] * log_odds], axis=1)
    m = logits.max(1, keepdims=True)
    q = np.exp(logits - m)
    q /= q.sum(1, keepdims=True)
    q_single = q[:, 1:1 + H]
    q_multi = q[:, 1 + H:]
    s_cand = q_multi @ SM                                       # (N, Hp)
    s_full = q_single.copy()
    np.add.at(s_full, (np.arange(N)[:, None], cand), s_cand)
    xs = y.T @ s_full                                           # (D, H)
    ss_cand = np.einsum("ns,sa,sb->nab", q_multi, SM, SM)
    ss = np.zeros((H, H))
    np.add.at(ss, (cand[:, :, None], cand[:, None, :]), ss_cand)
    ss[np.arange(H), np.arange(H)] += q_single.sum(0)
    _ = (xs, ss)
    dt = time.perf_counter() - t0
    return N / dt


def _numpy_multi_states(Hp, gamma, values):
    """(S, Hp) valued multi-states (2 <= |support| <= gamma) + (S, K)
    per-value counts — the enumeration the reference-equivalent baselines
    share (SURVEY.md §2 'ET base': state matrix)."""
    import itertools
    K = len(values)
    states, counts = [], []
    for k in range(2, gamma + 1):
        for sup in itertools.combinations(range(Hp), k):
            for assign in itertools.product(range(K), repeat=k):
                s = np.zeros(Hp)
                c = np.zeros(K)
                for slot, vi in zip(sup, assign):
                    s[slot] = values[vi]
                    c[vi] += 1
                states.append(s)
                counts.append(c)
    return np.array(states), np.array(counts)


def numpy_linear_baseline_dps(y, W, sigma, pi_vec, values, Hp, gamma):
    """Reference-equivalent vectorized NumPy E-step for the LINEAR family
    (BSC/TSC/DSC by value set) incl. suff stats — the per-family CPU
    baseline (generalises the BSC-only numpy_baseline_dps above)."""
    N, Dd = y.shape
    Hh = W.shape[1]
    K = len(values)
    vals = np.asarray(values, np.float64)
    SM, NK = _numpy_multi_states(Hp, gamma, values)
    pi_vec = np.asarray(pi_vec, np.float64)
    log_odds = np.log(pi_vec) - np.log(1.0 - pi_vec.sum())
    inv2s2 = 0.5 / sigma ** 2

    t0 = time.perf_counter()
    P = y @ W
    wn = np.linalg.norm(W, axis=0)
    score = P / wn
    if (vals < 0).any():
        score = np.abs(score)
    cand = np.argpartition(-score, Hp, axis=1)[:, :Hp]
    gram = W.T @ W
    proj = np.take_along_axis(P, cand, axis=1)
    G = gram[cand[:, :, None], cand[:, None, :]]                # (N,Hp,Hp)
    lik_multi = (2 * proj @ SM.T
                 - np.einsum("nab,sa,sb->ns", G, SM, SM)) * inv2s2
    gd = np.diag(gram)
    # singletons over all H x K values
    lik_single = (2 * P[:, :, None] * vals[None, None, :]
                  - gd[None, :, None] * (vals ** 2)[None, None, :]) * inv2s2
    logits = np.concatenate(
        [np.zeros((N, 1)),
         (lik_single + log_odds[None, None, :]).reshape(N, Hh * K),
         lik_multi + (NK @ log_odds)[None, :]], axis=1)
    m = logits.max(1, keepdims=True)
    q = np.exp(logits - m)
    q /= q.sum(1, keepdims=True)
    q_single = q[:, 1:1 + Hh * K].reshape(N, Hh, K)
    q_multi = q[:, 1 + Hh * K:]
    s_full = q_single @ vals
    s_cand = q_multi @ SM
    np.add.at(s_full, (np.arange(N)[:, None], cand), s_cand)
    xs = y.T @ s_full
    ss_cand = np.einsum("ns,sa,sb->nab", q_multi, SM, SM)
    ss = np.zeros((Hh, Hh))
    np.add.at(ss, (cand[:, :, None], cand[:, None, :]), ss_cand)
    ss[np.arange(Hh), np.arange(Hh)] += (q_single @ (vals ** 2)).sum(axis=0)
    _ = (xs, ss)
    dt = time.perf_counter() - t0
    return N / dt


def numpy_gsc_baseline_dps(y, W, sigma, pi, mu, psi, Hp, gamma):
    """Reference-equivalent vectorized NumPy GSC E-step: per-support
    integrated-slab Gaussian algebra (posterior covariance solve, logdet,
    quadratic form per enumerated support), batched over (N, S) with
    supports padded to gamma (SURVEY.md §2 'GSC')."""
    import itertools
    N, Dd = y.shape
    Hh = W.shape[1]
    supports = [sup for k in range(2, gamma + 1)
                for sup in itertools.combinations(range(Hp), k)]
    S = len(supports)
    inv2s2 = 0.5 / sigma ** 2

    t0 = time.perf_counter()
    P = y @ W
    wn = np.linalg.norm(W, axis=0)
    cand = np.argpartition(-(P / wn), Hp, axis=1)[:, :Hp]
    gram = W.T @ W
    G = gram[cand[:, :, None], cand[:, None, :]]                # (N,Hp,Hp)
    proj = np.take_along_axis(P, cand, axis=1)                  # (N,Hp)
    lo = np.log(pi) - np.log1p(-pi)
    logliks = np.empty((N, S))
    for si, sup in enumerate(supports):                         # vec over N
        k = len(sup)
        idx = list(sup)
        Gs = G[:, idx][:, :, idx]                               # (N,k,k)
        A = Gs / sigma ** 2 + np.eye(k) / psi                   # precision
        b = proj[:, idx] / sigma ** 2 + mu / psi                # (N,k)
        L = np.linalg.cholesky(A)
        z = np.linalg.solve(L, b[..., None])[..., 0]
        quad = 0.5 * (z ** 2).sum(axis=1)
        logdet = np.log(np.diagonal(L, axis1=1, axis2=2)).sum(axis=1)
        logliks[:, si] = (quad - logdet - 0.5 * k * np.log(psi)
                          - 0.5 * k * mu * mu / psi + k * lo)
    y2 = (y * y).sum(axis=1)
    logits = np.concatenate([np.zeros((N, 1)), logliks], axis=1)
    m = logits.max(1, keepdims=True)
    q = np.exp(logits - m)
    q /= q.sum(1, keepdims=True)
    _ = (q, y2)
    dt = time.perf_counter() - t0
    return N / dt


def numpy_max_baseline_dps(y, W, sigma, pi, Hp, gamma, signed=False):
    """Reference-equivalent vectorized NumPy MCA/MMCA E-step: the winner
    tile IS the work — ybar[n,s,d] = max over active causes (max-magnitude
    when signed) with no Gram shortcut (SURVEY.md §2 'MCA-ET')."""
    N, Dd = y.shape
    SM, _ = _numpy_multi_states(Hp, gamma, [1.0])
    S = SM.shape[0]
    inv2s2 = 0.5 / sigma ** 2
    lo = np.log(pi) - np.log1p(-pi)

    t0 = time.perf_counter()
    P = y @ W
    wn = np.linalg.norm(W, axis=0)
    score = np.abs(P / wn) if signed else P / wn
    cand = np.argpartition(-score, Hp, axis=1)[:, :Hp]
    Wc = W.T[cand]                                              # (N,Hp,D)
    act = (SM > 0)                                              # (S,Hp)
    # winner tile (N, S, D): masked max over active causes, built per
    # state (bounds the temporary at (N, Hp, D))
    big = -1e30
    ybar = np.empty((N, S, Dd))
    for si in range(S):
        msk = act[si]
        Wm = np.where(msk[None, :, None], Wc, big)              # (N,Hp,D)
        if signed:
            mag = np.where(msk[None, :, None], np.abs(Wc), big)
            wsel = np.argmax(mag, axis=1)                       # (N,D)
            ybar[:, si] = np.take_along_axis(
                Wm, wsel[:, None, :], axis=1)[:, 0]
        else:
            ybar[:, si] = Wm.max(axis=1)
    resid = y[:, None, :] - ybar
    lik = -(resid ** 2).sum(axis=2) * inv2s2
    logits = np.concatenate(
        [-(y ** 2).sum(1, keepdims=True) * inv2s2,
         lik + (act.sum(1) * lo)[None, :]], axis=1)
    m = logits.max(1, keepdims=True)
    q = np.exp(logits - m)
    q /= q.sum(1, keepdims=True)
    # responsibility-weighted accumulators (suff-stat stage)
    qs = q[:, 1:]
    s_cand = qs @ act.astype(np.float64)                        # (N,Hp)
    xs_c = np.einsum("ns,nd,nsd->n", qs, y, ybar)               # proxy accum
    _ = (s_cand, xs_c)
    dt = time.perf_counter() - t0
    return N / dt


def numpy_mix_baseline_dps(y, K, kind="mog"):
    """Vectorized NumPy mixture EM step (MoG/MoP): the (N,K) log-likelihood
    GEMM + responsibility-weighted moment GEMMs."""
    rng = np.random.default_rng(0)
    N, Dd = y.shape
    mu = rng.standard_normal((K, Dd))
    t0 = time.perf_counter()
    if kind == "mog":
        ll = (y @ mu.T - 0.5 * (mu * mu).sum(1)[None, :])
    else:
        lam = np.abs(mu) + 0.5
        ll = y @ np.log(lam).T - lam.sum(1)[None, :]
    m = ll.max(1, keepdims=True)
    r = np.exp(ll - m)
    r /= r.sum(1, keepdims=True)
    nk = r.sum(0)
    mu_new = (r.T @ y) / np.maximum(nk, 1e-9)[:, None]
    _ = mu_new
    dt = time.perf_counter() - t0
    return N / dt


def linear_flops_per_dp(Dd, Hh, Hhp, S, K=1):
    """(raw, useful) FLOPs/datapoint of the fused linear-family E-step.

    raw counts the executed matmul work including the one-hot
    gather/scatter GEMMs (2*Hp*H^2 MACs each for T-gather and ss-scatter —
    one-hot GEMMs ARE the executed formulation); useful counts only the
    algorithmically necessary work an ideal sparse implementation needs.
    K>1 (TSC/DSC) multiplies the candidate-table width.
    """
    necessary = 2 * (2 * Dd * Hh) + 2 * (K * Hhp + (K * Hhp) ** 2) * S
    gather = 2 * 2 * (K * Hhp) * Hh * Hh
    return necessary + gather, necessary


def gsc_flops_per_dp(Dd, Hh, Hhp, S):
    """(raw, useful) FLOPs/datapoint of the GSC E-step (analytic
    estimate).  Dominant terms: the selection + xs GEMMs
    (2DH each) and the per-state padded slab systems — an (Hp x Hp)
    Cholesky (Hp^3/3 MACs) plus triangular solves / logdet / quadratic
    forms (~5 Hp^2) per enumerated support.  raw adds the one-hot Gram
    gather GEMMs (same formulation as the linear family)."""
    useful = 2 * (2 * Dd * Hh) + S * (Hhp ** 3 // 3 + 5 * Hhp * Hhp)
    gather = 2 * 2 * Hhp * Hh * Hh
    return useful + gather, useful


def max_flops_per_dp(Dd, Hh, Hhp, S):
    """(raw, useful) FLOPs/datapoint of the MCA/MMCA E-step (analytic
    estimate).  The max superposition admits no Gram shortcut, so the
    (S, D) winner tile IS the work: ~1 op/state/dim for the subset-lattice
    DP max, ~3 for the residual log-joint, ~3 for the responsibility /
    suff-stat accumulation — plus the selection and xs GEMMs.  raw adds
    the W-candidate gather and winner-scatter one-hot GEMMs."""
    useful = 2 * (2 * Dd * Hh) + 7 * S * Dd
    gather = 2 * 2 * Hhp * Hh * Dd
    return useful + gather, useful


def mix_flops_per_dp(Dd, K):
    """(raw, useful) FLOPs/datapoint of a mixture EM step: the (N,K)
    log-likelihood GEMM (2DK) plus the two (K,D) suff-stat GEMMs."""
    useful = 3 * (2 * Dd * K)
    return useful, useful


def _measure_step(model, params, N, iters, groups=3, data_tf=None):
    """Best-of-groups EM-step throughput with forced host sync."""
    import jax
    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal

    rng = np.random.default_rng(1)
    y = rng.standard_normal((N, model.D)).astype(np.float32)
    if data_tf is not None:
        y = data_tf(y)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(10))
    key = jax.random.PRNGKey(0)

    # the engine's per-iteration saturation rule (EM._sat_now): beta ==
    # prior_beta == 1 on the host schedule selects the specialized step
    # that skips the duplicate un-annealed F channel — LinearAnnealing's
    # default schedule is saturated, i.e. this measures the production
    # steady state (the anneal window is the short transient)
    saturated = (float(sched["beta"]) == 1.0
                 and float(sched["prior_beta"]) == 1.0)
    step = model.jit_step(saturated=saturated)
    p, F, s = step(params, data, sched, key)      # warmup/compile
    float(np.asarray(s["F_mean"]))
    data2 = dict(data, F_prev=F)
    best = 0.0
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(iters):
            p, F, s = step(p, data2, sched, key)
        float(np.asarray(s["F_mean"]))            # force full sync
        best = max(best, N * iters / (time.perf_counter() - t0))
    return best


def _measure_step_chained(model, params, N, iters=CHAIN_ITERS, groups=2,
                          data_tf=None):
    """Production-shaped throughput: ``iters`` EM steps chained inside ONE
    jitted lax.scan (the shape engine.EM.run_scanned dispatches).  The scan
    body carries (params, F_prev) — a REAL iteration chain, nothing is
    loop-invariant."""
    import jax
    import jax.numpy as jnp
    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal

    rng = np.random.default_rng(1)
    y = rng.standard_normal((N, model.D)).astype(np.float32)
    if data_tf is not None:
        y = data_tf(y)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(10))
    key = jax.random.PRNGKey(0)
    saturated = (float(sched["beta"]) == 1.0
                 and float(sched["prior_beta"]) == 1.0)
    step = model.jit_step(saturated=saturated)

    # data rides as jit ARGUMENTS: closing over the (N, D) array would
    # embed it in the compiled module as a constant
    @jax.jit
    def chain(p, d):
        def body(carry, _):
            p_c, F_c = carry
            p2, F2, s = step(p_c, dict(d, F_prev=F_c), sched, key)
            return (p2, F2), s["F_mean"]
        (p2, _), fs = jax.lax.scan(body, (p, d["F_prev"]), None,
                                   length=iters)
        return fs[-1] + jnp.sum(fs) * 1e-30

    data = {k: jnp.asarray(v) for k, v in data.items()}
    out = chain(params, data)                         # warmup/compile
    float(np.asarray(out))
    best = 0.0
    for _ in range(groups):
        t0 = time.perf_counter()
        out = chain(params, data)
        float(np.asarray(out))                        # force full sync
        best = max(best, N * iters / (time.perf_counter() - t0))
    return best


def _family_entry(dps, flops=None, chained=None, kind=None):
    e = {"dps": round(dps, 1)}
    if chained:
        e["dps_chained"] = round(chained, 1)
    rate = chained or dps       # efficiency from the production-shaped rate
    if flops is not None:
        raw, useful = flops
        e["tflops_raw"] = round(rate * raw / 1e12, 2)
        peak = PEAK_TFLOPS.get(kind)
        if peak is not None:
            e["mfu_useful_pct"] = round(
                100 * rate * useful / 1e12 / peak["tf32"], 2)
    return e


def main():
    import jax.numpy as jnp
    from prosper_tpu.models.gsc import GSC
    from prosper_tpu.models.linear import BSC, DSC, TSC
    from prosper_tpu.models.mca import MCA, MMCA
    from prosper_tpu.utils import enable_compile_cache, gpu_device_info

    enable_compile_cache()
    device = gpu_device_info()
    kind = device["kind"]
    only = set(a.lower() for a in sys.argv[1:])
    failed = []

    def want(name):
        return not only or name in only

    def cell(name, fn):
        """Run one family; a failure is recorded with its traceback and
        makes the run exit non-zero."""
        if not want(name):
            return
        try:
            fn()
        except Exception:                           # noqa: BLE001
            traceback.print_exc()
            failed.append(name)

    rng = np.random.default_rng(0)
    W0 = rng.standard_normal((D, H)).astype(np.float32)
    pi0, sigma0 = 2.0 / H, 1.0
    families = {}

    def attach_baseline(name, fn):
        """Per-family reference-equivalent NumPy E-step on the host CPU."""
        if name not in families:
            return
        cpu = fn()
        families[name]["baseline"] = {"numpy_cpu_dps": round(cpu, 1)}
        rate = families[name].get("dps_chained", families[name]["dps"])
        families[name]["vs_baseline"] = round(rate / cpu, 1)

    def _cpu_y(n, d, seed=11):
        return np.random.default_rng(seed).standard_normal((n, d))

    def init_params(model):
        return model.standard_init(
            {"y": np.random.default_rng(2).standard_normal(
                (256, model.D)).astype(np.float32)}, seed=4)

    def run_family(name, factory, N, iters=5, flops=None,
                   with_chained=True, chain_iters=CHAIN_ITERS,
                   data_tf=None, params_fn=init_params):
        model = factory()
        params = params_fn(model)
        dps = _measure_step(model, params, N, iters, groups=2,
                            data_tf=data_tf)
        chained = (_measure_step_chained(model, params, N, iters=chain_iters,
                                         data_tf=data_tf)
                   if with_chained else None)
        families[name] = _family_entry(
            dps, flops(model) if flops else None, chained=chained,
            kind=kind)

    # ---- headline: BSC patches config ----------------------------------------
    def bsc():
        run_family(
            "bsc", lambda: BSC(D, H, Hp, GAMMA, chunk=CHUNK), N_DEV,
            iters=ITERS,
            flops=lambda m: linear_flops_per_dp(D, H, Hp,
                                                m.sa.states.shape[0]),
            params_fn=lambda m: {"W": jnp.asarray(W0),
                                 "pi": jnp.float32(pi0),
                                 "sigma": jnp.float32(sigma0)})
        attach_baseline("bsc", lambda: numpy_baseline_dps(
            np.random.default_rng(0).standard_normal((N_CPU, D)),
            W0.astype(np.float64), sigma0, pi0))
    cell("bsc", bsc)

    # ---- family matrix at the patches width ----------------------------------
    def tsc():
        run_family("tsc", lambda: TSC(D, H, 6, 3, chunk=CHUNK), N_DEV,
                   flops=lambda m: linear_flops_per_dp(
                       D, H, 6, m.sa.states.shape[0], K=2))
        attach_baseline("tsc", lambda: numpy_linear_baseline_dps(
            _cpu_y(N_CPU, D), W0.astype(np.float64), sigma0,
            [pi0 / 2, pi0 / 2], [-1.0, 1.0], 6, 3))
    cell("tsc", tsc)

    def dsc():
        run_family("dsc", lambda: DSC(D, H, 5, 3, phi=(-1.0, 1.0, 2.0),
                                      chunk=CHUNK), N_DEV,
                   flops=lambda m: linear_flops_per_dp(
                       D, H, 5, m.sa.states.shape[0], K=3))
        attach_baseline("dsc", lambda: numpy_linear_baseline_dps(
            _cpu_y(N_CPU, D), W0.astype(np.float64), sigma0,
            [pi0 / 3] * 3, [-1.0, 1.0, 2.0], 5, 3))
    cell("dsc", dsc)

    # big-S: s_block = the online-logsumexp state-tiled path, the (chunk, S)
    # logits are never materialised (SURVEY §5.7: S explodes
    # combinatorially; state-sharded on a mesh)
    def tsc_bigs():
        run_family("tsc_bigs", lambda: TSC(64, 32, 10, 5, chunk=8192,
                                           s_block=1024),
                   524288, iters=2, chain_iters=12)
        attach_baseline("tsc_bigs", lambda: numpy_linear_baseline_dps(
            _cpu_y(256, 64),
            np.random.default_rng(2).standard_normal((64, 32)), sigma0,
            [0.05, 0.05], [-1.0, 1.0], 10, 5))
    cell("tsc_bigs", tsc_bigs)

    def gsc():
        run_family("gsc", lambda: GSC(D, H, 6, 3, chunk=CHUNK), N_DEV,
                   iters=ITERS, flops=lambda m: gsc_flops_per_dp(
                       D, H, 6, m.sa.states.shape[0]))
        attach_baseline("gsc", lambda: numpy_gsc_baseline_dps(
            _cpu_y(N_CPU, D), W0.astype(np.float64), sigma0, pi0,
            mu=1.0, psi=0.25, Hp=6, gamma=3))
    cell("gsc", gsc)

    def gsc_small():
        run_family("gsc_small", lambda: GSC(64, 100, 6, 3, chunk=8192),
                   262144, iters=ITERS, flops=lambda m: gsc_flops_per_dp(
                       64, 100, 6, m.sa.states.shape[0]),
                   with_chained=False)
        attach_baseline("gsc_small", lambda: numpy_gsc_baseline_dps(
            _cpu_y(N_CPU, 64),
            np.random.default_rng(2).standard_normal((64, 100)), sigma0,
            pi0, mu=1.0, psi=0.25, Hp=6, gamma=3))
    cell("gsc_small", gsc_small)

    for name, cls, Dm, Hm, N_m, chunk in (
            ("mca", MCA, D, H, 131072, 4096),
            ("mmca", MMCA, D, H, 131072, 4096),
            ("mca_small", MCA, 64, 100, 262144, 8192),
            ("mmca_small", MMCA, 64, 100, 262144, 8192)):
        def max_family(name=name, cls=cls, Dm=Dm, Hm=Hm, N_m=N_m,
                       chunk=chunk):
            run_family(name, lambda: cls(Dm, Hm, 6, 3, chunk=chunk), N_m,
                       iters=ITERS,
                       flops=lambda m: max_flops_per_dp(
                           Dm, Hm, 6, m.sa.states.shape[0]),
                       with_chained=not name.endswith("_small"))
            W_cpu = (W0.astype(np.float64) if Dm == D else
                     np.random.default_rng(2).standard_normal((Dm, Hm)))
            attach_baseline(name, lambda: numpy_max_baseline_dps(
                _cpu_y(1024, Dm), W_cpu, sigma0, pi0, 6, 3,
                signed=name.startswith("mmca")))
        cell(name, max_family)

    # mixtures at clustering scale matching the patches dims (D=256, K=300)
    for mix_name in ("mog", "mop"):
        def mixture(mix_name=mix_name):
            from prosper_tpu.models.mixtures import MoG, MoP
            cls = MoG if mix_name == "mog" else MoP

            def counts(y):
                return np.abs(np.floor(y * 3)).astype(np.float32)

            tf = counts if mix_name == "mop" else None

            def params_fn(model):
                y0 = np.random.default_rng(5).standard_normal(
                    (1024, D)).astype(np.float32)
                return model.standard_init(
                    {"y": tf(y0) if tf else y0}, seed=6)

            run_family(mix_name, lambda: cls(D=D, K=H, chunk=65536), 524288,
                       iters=ITERS, flops=lambda m: mix_flops_per_dp(D, H),
                       data_tf=tf, params_fn=params_fn)
            attach_baseline(mix_name, lambda: numpy_mix_baseline_dps(
                _cpu_y(16384, D), H, kind=mix_name))
        cell(mix_name, mixture)

    # ---- serving decode (model.inference, device-resident input) ------------
    def decode():
        params = {"W": jnp.asarray(W0), "pi": jnp.float32(pi0),
                  "sigma": jnp.float32(sigma0)}
        y_dev = jnp.asarray(np.random.default_rng(3).standard_normal(
            (N_DEV, D)).astype(np.float32))
        reps = 5
        for label, dense in (("decode", True), ("decode_compact", False)):
            model = BSC(D, H, Hp, GAMMA, chunk=CHUNK)
            out = model.inference(params, {"y": y_dev}, top_L=10,
                                  dense_states=dense)
            float(np.asarray(out["F"][0]))
            best = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = model.inference(params, {"y": y_dev}, top_L=10,
                                          dense_states=dense)
                float(np.asarray(out["F"][0]))
                best = max(best, reps * N_DEV / (time.perf_counter() - t0))
            families[label] = {"dps": round(best, 1), "top_L": 10}
    cell("decode", decode)

    out = {"device": device}
    if "bsc" in families:
        bsc_e = families["bsc"]
        out.update({
            "metric": ("BSC-ET E-step throughput "
                       "(patches config D=256 H=300 Hp=8 gamma=4)"),
            "value": bsc_e["dps_chained"],
            "unit": "datapoints/s/GPU",
            "protocol": f"chained_scan_{CHAIN_ITERS}",
            "value_per_dispatch": bsc_e["dps"],
            "vs_baseline": bsc_e["vs_baseline"],
            "baseline": bsc_e["baseline"],
        })
    out["families"] = families
    if failed:
        out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
