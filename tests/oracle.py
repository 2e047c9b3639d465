"""Float64 NumPy oracle for the linear ET family (BSC/TSC/DSC).

A deliberately naive, obviously-correct implementation of the truncated
E-step and closed-form M-step, structured like the reference's NumPy path
(SURVEY.md §3.1 hot loop): per-datapoint candidate gather, explicit
reconstruction ybar = W_cand @ s per enumerated state, explicit union
{zero} ∪ {singletons x values over ALL H} ∪ {multi states over candidates}.

The production path (prosper_tpu/core/etstep.py) must reproduce these
numbers to float32 tolerance — SURVEY.md §4's "pure-NumPy oracle vs jitted"
test strategy.
"""

from __future__ import annotations

import itertools
from math import comb

import numpy as np
from scipy.special import logsumexp


def enumerate_union(H, Hp, gamma, values, candidates):
    """All full-H state vectors in the truncated union for one datapoint."""
    states = [np.zeros(H)]
    for h in range(H):
        for v in values:
            s = np.zeros(H)
            s[h] = v
            states.append(s)
    for k in range(2, gamma + 1):
        for support in itertools.combinations(range(Hp), k):
            for assign in itertools.product(range(len(values)), repeat=k):
                s = np.zeros(H)
                for slot, vi in zip(support, assign):
                    s[candidates[slot]] = values[vi]
                states.append(s)
    return np.array(states)  # (T, H)


def linear_oracle_estep(y, W, sigma, pi_vec, values, Hp, gamma,
                        beta=1.0, prior_beta=1.0, signed_select=False,
                        weight=None, candidates=None):
    """pi_vec: (K,) non-zero value probabilities (BSC: [pi]; TSC: [pi/2,pi/2]).

    Returns dict with per-datapoint F and summed suff stats, all float64.
    ``candidates``: optional (N, Hp) — bypass selection (used to make tests
    insensitive to float32 near-ties in the affinity scores).
    """
    y = np.asarray(y, np.float64)
    W = np.asarray(W, np.float64)
    N, D = y.shape
    H = W.shape[1]
    values = np.asarray(values, np.float64)
    pi_vec = np.asarray(pi_vec, np.float64)
    p0 = 1.0 - pi_vec.sum()
    log_odds = np.log(pi_vec) - np.log(p0)
    sigma2 = float(sigma) ** 2
    if weight is None:
        weight = np.ones(N)

    # candidate selection — must match core.select.top_hprime_candidates
    if candidates is not None:
        cand_all = np.asarray(candidates)
    else:
        P = y @ W
        wn = np.maximum(np.linalg.norm(W, axis=0), 1e-12)
        score = P / wn
        if signed_select:
            score = np.abs(score)
        cand_all = np.argsort(-score, axis=1, kind="stable")[:, :Hp]

    sums = dict(
        xs=np.zeros((D, H)), ss=np.zeros((H, H)), s=np.zeros(H),
        abs=0.0, vc=np.zeros(len(values)), y2=0.0, n=0.0, F=0.0,
        phi_c=np.zeros(len(values)),
        phi_M=np.zeros((len(values), len(values))),
    )
    gram = W.T @ W
    F_out = np.zeros(N)
    for n in range(N):
        states = enumerate_union(H, Hp, gamma, values, cand_all[n])
        resid = y[n][None, :] - states @ W.T
        lik = -0.5 * np.sum(resid ** 2, axis=1) / sigma2 \
            - 0.5 * D * np.log(2 * np.pi * sigma2)
        nk = (states[:, :, None] == values[None, None, :]) & (states[:, :, None] != 0)
        nk = nk.sum(axis=1).astype(np.float64)      # (T, K)
        prior = nk @ log_odds + H * np.log(p0)
        logits = beta * lik + prior_beta * prior
        Fn = logsumexp(logits)
        q = np.exp(logits - Fn)
        F_out[n] = Fn
        w = weight[n]
        es = q @ states
        ess = states.T @ (states * q[:, None])
        sums["xs"] += w * np.outer(y[n], es)
        sums["ss"] += w * ess
        sums["s"] += w * es
        sums["abs"] += w * float(q @ (states != 0).sum(axis=1))
        sums["vc"] += w * (q @ nk)
        sums["y2"] += w * float(y[n] @ y[n])
        sums["n"] += w
        sums["F"] += w * Fn
        # value-set (Phi) learning stats: b_k = indicator of value k per unit
        bk = ((states[:, :, None] == values[None, None, :])
              & (states[:, :, None] != 0)).astype(np.float64)  # (T, H, K)
        sums["phi_c"] += w * np.einsum("t,thk,h->k", q, bk, W.T @ y[n],
                                       optimize=True)
        sums["phi_M"] += w * np.einsum("t,thk,hg,tgj->kj", q, bk, gram, bk,
                                       optimize=True)
    return F_out, sums


def bsc_oracle_mstep(sums, pi_old, H, gamma, D, learn=("W", "pi", "sigma")):
    """Closed-form M-step with the ET pi correction, float64."""
    out = {}
    n = max(sums["n"], 1.0)
    ss = sums["ss"]
    ridge = 1e-6 * (np.trace(ss) / H + 1.0)
    W = np.linalg.solve(ss + ridge * np.eye(H), sums["xs"].T).T
    out["W"] = W

    ks = np.arange(gamma + 1)
    from scipy.special import gammaln
    log_comb = gammaln(H + 1) - gammaln(ks + 1) - gammaln(H - ks + 1)
    terms = log_comb + ks * np.log(pi_old) + (H - ks) * np.log1p(-pi_old)
    A = np.exp(logsumexp(terms))
    B = np.exp(logsumexp(terms[1:] + np.log(ks[1:])))
    out["pi"] = np.clip(pi_old * (A / B) * (sums["abs"] / n), 1e-6, 1 - 1e-6)

    resid = sums["y2"] - 2 * np.sum(W * sums["xs"]) + np.sum((W.T @ W) * ss)
    out["sigma"] = np.sqrt(max(resid / (n * D), 1e-10))
    return out
