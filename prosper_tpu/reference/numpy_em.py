"""Single-process NumPy float64 EM for BSC-ET, reference-style.

Mirrors the reference call stack (SURVEY.md §3.1): noisify -> select_Hprimes
-> E_step (explicit per-state reconstructions over gathered candidate
dictionaries) -> allreduce-free M_step.  Used by the comparison harness and
the benchmark baseline.
"""

from __future__ import annotations

import itertools
from math import comb
from typing import Dict, List, Optional

import numpy as np
from scipy.special import gammaln, logsumexp


class NumpyBSC:
    """Binary sparse coding with ET, float64 NumPy (reference-equivalent)."""

    def __init__(self, D: int, H: int, Hprime: int, gamma: int,
                 to_learn=("W", "pi", "sigma")):
        self.D, self.H, self.Hprime, self.gamma = D, H, Hprime, gamma
        self.to_learn = to_learn
        states = []
        for k in range(2, gamma + 1):
            for sup in itertools.combinations(range(Hprime), k):
                s = np.zeros(Hprime)
                s[list(sup)] = 1.0
                states.append(s)
        self.SM = np.array(states)              # (S, Hp)
        self.state_abs = self.SM.sum(axis=1)

    # -- E-step ---------------------------------------------------------------

    def select_Hprimes(self, W, y):
        wn = np.maximum(np.linalg.norm(W, axis=0), 1e-12)
        score = (y @ W) / wn
        return np.argsort(-score, axis=1, kind="stable")[:, :self.Hprime]

    def e_step(self, params, y, beta=1.0, prior_beta=1.0,
               weight: Optional[np.ndarray] = None):
        W = params["W"]
        pi = float(params["pi"])
        sigma2 = float(params["sigma"]) ** 2
        N, D = y.shape
        H, Hp = self.H, self.Hprime
        if weight is None:
            weight = np.ones(N)
        lo = np.log(pi) - np.log1p(-pi)
        inv2s2 = 0.5 / sigma2

        cand = self.select_Hprimes(W, y)
        F = np.zeros(N)
        sums = dict(xs=np.zeros((D, H)), ss=np.zeros((H, H)), abs=0.0,
                    y2=0.0, n=0.0, F=0.0)
        # singletons + zero handled analytically; multi-states per datapoint
        P = y @ W
        gd = np.sum(W * W, axis=0)
        y2 = np.sum(y * y, axis=1)
        lik_single = (2.0 * P - gd[None, :]) * inv2s2      # (N, H)

        for n in range(N):
            Wc = W[:, cand[n]]                              # (D, Hp) gather
            ybar = self.SM @ Wc.T                           # (S, D) recon
            # relative to the zero state (whose logit is 0)
            lik_multi = (-np.sum((y[n][None] - ybar) ** 2, axis=1)
                         + y2[n]) * inv2s2
            logits = np.concatenate(
                [[0.0], beta * lik_single[n] + prior_beta * lo,
                 beta * lik_multi + prior_beta * lo * self.state_abs])
            m = logits.max()
            p = np.exp(logits - m)
            Z = p.sum()
            q = p / Z
            F[n] = (m + np.log(Z)
                    - beta * (y2[n] * inv2s2)
                    - beta * 0.5 * D * np.log(2 * np.pi * sigma2)
                    + prior_beta * H * np.log1p(-pi))
            q_single = q[1:1 + H]
            q_multi = q[1 + H:]
            s_full = q_single.copy()
            np.add.at(s_full, cand[n], q_multi @ self.SM)
            ssT = np.zeros((H, H))
            sm_q = self.SM.T @ (self.SM * q_multi[:, None])
            ssT[np.ix_(cand[n], cand[n])] += sm_q
            ssT[np.arange(H), np.arange(H)] += q_single
            w = weight[n]
            sums["xs"] += w * np.outer(y[n], s_full)
            sums["ss"] += w * ssT
            sums["abs"] += w * (q_single.sum() + q_multi @ self.state_abs)
            sums["y2"] += w * y2[n]
            sums["n"] += w
            sums["F"] += w * F[n]
        return F, sums

    # -- M-step ---------------------------------------------------------------

    def m_step(self, params, sums):
        H, D, gamma = self.H, self.D, self.gamma
        pi = float(params["pi"])
        out = dict(params)
        n = max(sums["n"], 1.0)
        if "W" in self.to_learn:
            ss = sums["ss"]
            ridge = 1e-6 * (np.trace(ss) / H + 1.0)
            out["W"] = np.linalg.solve(ss + ridge * np.eye(H), sums["xs"].T).T
        if "pi" in self.to_learn:
            ks = np.arange(gamma + 1)
            log_comb = gammaln(H + 1) - gammaln(ks + 1) - gammaln(H - ks + 1)
            terms = log_comb + ks * np.log(pi) + (H - ks) * np.log1p(-pi)
            A = np.exp(logsumexp(terms))
            B = np.exp(logsumexp(terms[1:] + np.log(ks[1:])))
            out["pi"] = float(np.clip(pi * (A / B) * (sums["abs"] / n),
                                      1e-6, 1 - 1e-6))
        if "sigma" in self.to_learn:
            W = out["W"]
            resid = (sums["y2"] - 2 * np.sum(W * sums["xs"])
                     + np.sum((W.T @ W) * sums["ss"]))
            out["sigma"] = float(np.sqrt(max(resid / (n * D), 1e-10)))
        return out


def numpy_em_run(model: NumpyBSC, y: np.ndarray, anneal, params: Dict,
                 seed: int = 0) -> Dict:
    """Reference-style EM loop: noisify -> E -> M per annealing position.

    Returns {'params', 'F_true_trajectory'} where the trajectory is the
    un-annealed per-datapoint-mean truncated log-likelihood per iteration
    (comparable to the jitted driver's ``Q_mean`` channel).
    """
    rng = np.random.default_rng(seed)
    params = {k: np.array(v, np.float64) for k, v in params.items()}
    traj: List[float] = []
    while not anneal.finished:
        s = anneal.as_scalars()
        p = dict(params)
        if s.get("W_noise", 0.0) > 0:
            p["W"] = p["W"] + s["W_noise"] * rng.standard_normal(p["W"].shape)
        beta = s["beta"]
        prior_beta = beta if s.get("anneal_prior") else 1.0
        _, sums = model.e_step(p, y, beta=beta, prior_beta=prior_beta)
        # un-annealed free energy at the (noisified) pre-update params —
        # matches when the jitted driver logs its Q_mean channel
        F_true, _ = model.e_step(p, y, beta=1.0, prior_beta=1.0)
        traj.append(float(F_true.mean()))
        params = model.m_step(p, sums)
        anneal.next()
    return {"params": params, "F_true_trajectory": traj}
