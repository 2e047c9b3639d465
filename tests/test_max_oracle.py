"""MCA/MMCA E-step vs a float64 brute-force oracle + bars integration."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import logsumexp

from prosper_tpu.core.etstep import state_arrays_from
from prosper_tpu.core.maxstep import max_et_estep
from prosper_tpu.core.states import binary_state_space
from prosper_tpu.models.mca import MCA, MMCA


def max_oracle(y, W, sigma, pi, Hp, gamma, magnitude, candidates,
               beta=1.0, prior_beta=1.0):
    """Brute-force union E-step for max models, float64."""
    y = np.asarray(y, np.float64)
    W = np.asarray(W, np.float64)
    N, D = y.shape
    H = W.shape[1]
    lo = np.log(pi) - np.log(1 - pi)
    sigma2 = sigma ** 2
    inv2s2 = 0.5 / sigma2

    def ybar_of(s_full):
        act = s_full > 0.5
        if not act.any():
            return np.zeros(D), None
        cols = np.where(act)[0]
        sub = W[:, cols]                               # (D, k)
        key = np.abs(sub) if magnitude else sub
        win = np.argmax(key, axis=1)
        return sub[np.arange(D), win], cols[win]

    sums = dict(numer=np.zeros((H, D)), denom=np.zeros((H, D)),
                s=np.zeros(H), abs=0.0, resid=0.0, y2=0.0, n=0.0, F=0.0)
    F_out = np.zeros(N)
    for n in range(N):
        cand = candidates[n]
        states = [np.zeros(H)]
        for h in range(H):
            e = np.zeros(H); e[h] = 1.0
            states.append(e)
        for k in range(2, gamma + 1):
            for sup in itertools.combinations(range(Hp), k):
                e = np.zeros(H)
                e[cand[list(sup)]] = 1.0
                states.append(e)
        logits, ybars, winners = [], [], []
        for s in states:
            yb, win = ybar_of(s)
            lik = -np.sum((y[n] - yb) ** 2) * inv2s2
            prior = s.sum() * lo
            logits.append(beta * lik + prior_beta * prior)
            ybars.append(yb); winners.append(win)
        logits = np.array(logits)
        const = (-beta * 0.5 * D * np.log(2 * np.pi * sigma2)
                 + prior_beta * H * np.log(1 - pi))
        # note oracle folds -beta*y2 into lik already
        Fn = logsumexp(logits) + const
        F_out[n] = Fn
        q = np.exp(logits - logsumexp(logits))
        for qi, s, yb, win in zip(q, states, ybars, winners):
            sums["s"] += qi * s
            sums["abs"] += qi * s.sum()
            sums["resid"] += qi * np.sum((y[n] - yb) ** 2)
            if win is not None:
                for d in range(D):
                    sums["denom"][win[d], d] += qi
                    sums["numer"][win[d], d] += qi * y[n, d]
        sums["y2"] += y[n] @ y[n]
        sums["n"] += 1
        sums["F"] += Fn
    return F_out, sums


@pytest.mark.parametrize("magnitude", [False, True])
def test_max_estep_matches_oracle(magnitude):
    N, D, H, Hp, gamma = 12, 9, 6, 6, 3    # Hp=H: tie-insensitive selection
    rng = np.random.default_rng(4)
    W = np.abs(rng.standard_normal((D, H))).astype(np.float32) + 0.1
    if magnitude:
        W *= rng.choice([-1.0, 1.0], size=W.shape).astype(np.float32)
    y = rng.standard_normal((N, D)).astype(np.float32) * 1.5
    sigma, pi = 0.9, 0.2

    space = binary_state_space(Hp, gamma)
    sa = state_arrays_from(space)
    F, sums = jax.jit(
        lambda y_: max_et_estep(y_, jnp.ones((N,), jnp.float32),
                                jnp.asarray(W), jnp.float32(sigma ** 2),
                                jnp.float32(np.log(pi / (1 - pi))), sa, Hp,
                                magnitude, jnp.float32(1.0), jnp.float32(1.0),
                                chunk=2048)
    )(jnp.asarray(y))

    cand = np.tile(np.arange(H), (N, 1))
    F_o, sums_o = max_oracle(y, W, sigma, pi, Hp, gamma, magnitude, cand)

    np.testing.assert_allclose(np.asarray(F), F_o, rtol=3e-4, atol=3e-4)
    for key in ("numer", "denom", "s", "abs", "resid", "y2", "n", "F"):
        np.testing.assert_allclose(np.asarray(sums[key]), sums_o[key],
                                   rtol=3e-3, atol=3e-3, err_msg=key)


def _anneal(steps=60):
    from prosper_tpu.engine.anneal import LinearAnnealing
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 2.0), (0.7, 1.0)]
    a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    # cut datapoints with more than gamma active causes once W stabilises,
    # so sigma is estimated on explainable data (the ET Ncut mechanism)
    a["Ncut_factor"] = [(0.5, 0.0), (0.8, 1.0)]
    return a


def test_mca_bars_recovery():
    """MCA bars: overlapping bars combine by max (occlusion), all recovered."""
    from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
    from prosper_tpu.engine.em import EM

    R = 4
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 3, 1000
    model = MCA(D, H, Hp, gamma, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, N, seed=21)
    em = EM(model, _anneal(60), {"y": data["y"]}, seed=13)
    params = em.run()
    n_rec = count_recovered_bars(np.asarray(params["W"]),
                                 np.asarray(gt["W"]), threshold=0.8)
    assert n_rec == H, f"recovered {n_rec}/{H} bars (MCA)"
    assert abs(float(params["sigma"]) - 1.0) < 0.3


def test_mmca_bars_recovery():
    """MMCA: alternating-sign bars, winner by |W|."""
    from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
    from prosper_tpu.engine.em import EM

    R = 4
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 3, 1000
    model = MMCA(D, H, Hp, gamma, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0, neg_bars=True)
    data = model.generate_data(gt, N, seed=22)
    em = EM(model, _anneal(60), {"y": data["y"]}, seed=14)
    params = em.run()
    n_rec = count_recovered_bars(np.asarray(params["W"]),
                                 np.asarray(gt["W"]), threshold=0.8,
                                 signed=True)
    assert n_rec >= H - 1, f"recovered {n_rec}/{H} bars (MMCA)"


def test_soft_rho_converges_to_hard():
    """rho -> large recovers the hard-winner responsibilities."""
    import jax.numpy as jnp
    N, D, H, Hp, gamma = 10, 8, 6, 6, 3
    rng = np.random.default_rng(11)
    W = (np.abs(rng.standard_normal((D, H))) + 0.1).astype(np.float32)
    y = rng.standard_normal((N, D)).astype(np.float32) * 1.5
    space = binary_state_space(Hp, gamma)
    sa = state_arrays_from(space)
    lo = jnp.float32(np.log(0.2 / 0.8))

    def run(rho):
        return max_et_estep(jnp.asarray(y), jnp.ones((N,), jnp.float32),
                            jnp.asarray(W), jnp.float32(1.0), lo, sa, Hp,
                            False, jnp.float32(1.0), jnp.float32(1.0),
                            chunk=2048, rho=jnp.float32(rho))

    _, hard = run(0.0)
    _, soft = run(200.0)
    np.testing.assert_allclose(np.asarray(soft["numer"]),
                               np.asarray(hard["numer"]), rtol=2e-2,
                               atol=2e-2)
    # small rho spreads responsibility (denominators grow where overlaps)
    _, soft2 = run(2.0)
    assert not np.allclose(np.asarray(soft2["denom"]),
                           np.asarray(hard["denom"]), atol=1e-3)


def test_mca_bars_with_annealed_rho():
    """Reference-style annealed softened max still recovers all bars."""
    from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
    from prosper_tpu.engine.em import EM

    R = 4
    model = MCA(R * R, 2 * R, 6, 3, chunk=1000)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 1000, seed=21)
    # rho is in units of RELATIVE winner gap (scale-invariant): rho=50 means
    # a cause 10% below the winner gets e^-5 of its responsibility
    a = _anneal(60)
    a["rho"] = [(0.0, 5.0), (0.7, 50.0)]
    em = EM(model, a, {"y": data["y"]}, seed=13)
    p = em.run()
    rec = count_recovered_bars(np.asarray(p["W"]), np.asarray(gt["W"]), 0.8)
    assert rec == model.H, f"recovered {rec}/{model.H} with annealed rho"


def test_dp_winner_tile_matches_loop_formulation():
    """The subset-lattice DP winner tile must reproduce the Hp-pass masked
    max loop exactly (ybar/best/key and hence all statistics), for both
    value-max (MCA) and magnitude-max (MMCA), hard and softened."""
    import jax.numpy as jnp

    from prosper_tpu.core.maxstep import max_et_estep
    from prosper_tpu.core.etstep import state_arrays_from
    from prosper_tpu.core import states as states_mod

    rng = np.random.default_rng(3)
    N, D, H, Hp, gamma = 64, 16, 12, 6, 3
    sa = state_arrays_from(states_mod.binary_state_space(Hp, gamma))
    y = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    w = jnp.ones((N,), jnp.float32)
    W = jnp.asarray(rng.standard_normal((D, H)), jnp.float32)

    for magnitude in (False, True):
        for rho in (0.0, 4.0):
            F1, s1 = max_et_estep(y, w, W, 1.0, -1.5, sa, Hp, magnitude,
                                  1.0, 1.0, chunk=N, rho=rho,
                                  dp_winner=False)
            F2, s2 = max_et_estep(y, w, W, 1.0, -1.5, sa, Hp, magnitude,
                                  1.0, 1.0, chunk=N, rho=rho,
                                  dp_winner=True)
            np.testing.assert_allclose(np.asarray(F1), np.asarray(F2),
                                       rtol=1e-6, atol=1e-6)
            for k in s1:
                np.testing.assert_allclose(
                    np.asarray(s1[k]), np.asarray(s2[k]), rtol=1e-5,
                    atol=1e-5, err_msg=f"{k} magnitude={magnitude} rho={rho}")


def test_mca_beats_linear_on_occlusion_data():
    """The occlusion example's defining claim as a regression test: on
    max-composed scenes MCA recovers the objects, the linear model blends
    the occluders (examples/mca_occlusion.py)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.mca_occlusion import main

    rec_mca, rec_bsc = main(N=2048, iters=50)
    assert rec_mca >= 7
    assert rec_mca > rec_bsc


# ---- case grids on the XLA path: annealed (beta, prior_beta) with H' < H,
# padding rows, zero-weight chunks, the saturated channel, the M-step -----

def _max_problem(D, H, N, seed, magnitude):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    if not magnitude:
        W = np.abs(W)          # MCA is a non-negative-dictionary model
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    return y, W


def _max_candidates(y, W, Hp, magnitude):
    from prosper_tpu.core.select import top_hprime_candidates
    P = jnp.dot(jnp.asarray(y), jnp.asarray(W))
    return np.asarray(top_hprime_candidates(
        P, jnp.linalg.norm(jnp.asarray(W), axis=0), Hp, magnitude))


def _weighted_oracle(y, W, sigma, pi, Hp, gamma, magnitude, cand, w,
                     **kw):
    """max_oracle over the rows with weight 1 (weights here are 0/1)."""
    keep = w > 0
    F_all, _ = max_oracle(y, W, sigma, pi, Hp, gamma, magnitude, cand, **kw)
    _, sums = max_oracle(y[keep], W, sigma, pi, Hp, gamma, magnitude,
                         cand[keep], **kw)
    return F_all, sums


@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("beta,prior_beta", [(1.0, 1.0), (0.5, 1.0),
                                             (0.7, 0.7)])
def test_max_estep_annealed_subset_candidates_matches_oracle(
        magnitude, beta, prior_beta):
    D, H, Hp, gamma, N = 12, 16, 5, 3, 24
    y, W = _max_problem(D, H, N, 3, magnitude)
    w = (np.random.default_rng(4).random(N) < 0.8).astype(np.float32)
    sigma, pi = 1.1, 0.15
    sa = state_arrays_from(binary_state_space(Hp, gamma))
    F, sums = jax.jit(lambda: max_et_estep(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(W),
        jnp.float32(sigma ** 2), jnp.float32(np.log(pi / (1 - pi))), sa, Hp,
        magnitude, jnp.float32(beta), jnp.float32(prior_beta), chunk=N))()
    cand = _max_candidates(y, W, Hp, magnitude)
    F_o, sums_o = _weighted_oracle(y, W, sigma, pi, Hp, gamma, magnitude,
                                   cand, w, beta=beta, prior_beta=prior_beta)
    np.testing.assert_allclose(np.asarray(F), F_o, rtol=3e-4, atol=3e-4)
    for key in ("numer", "denom", "s", "abs", "resid", "y2", "n", "F"):
        np.testing.assert_allclose(np.asarray(sums[key]), sums_o[key],
                                   rtol=3e-3, atol=3e-3, err_msg=key)


@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("masked", ["padding_rows", "zero_weight_chunk"])
def test_max_estep_weight_zero_rows_match_oracle(magnitude, masked):
    """N=20 padded to two chunks of 16 with weight-0 rows, or a whole
    chunk of weight 0: those rows contribute nothing to any sum."""
    D, H, Hp, gamma, chunk = 10, 12, 4, 3, 16
    N = 20 if masked == "padding_rows" else 32
    y, W = _max_problem(D, H, N, 9, magnitude)
    w = np.ones(N, np.float32)
    if masked == "zero_weight_chunk":
        w[16:] = 0.0
    n_pad = -(-N // chunk) * chunk
    y_p = np.pad(y, ((0, n_pad - N), (0, 0)))
    w_p = np.pad(w, (0, n_pad - N))
    sigma, pi = 0.9, 0.2
    sa = state_arrays_from(binary_state_space(Hp, gamma))
    F, sums = jax.jit(lambda: max_et_estep(
        jnp.asarray(y_p), jnp.asarray(w_p), jnp.asarray(W),
        jnp.float32(sigma ** 2), jnp.float32(np.log(pi / (1 - pi))), sa, Hp,
        magnitude, jnp.float32(1.0), jnp.float32(1.0), chunk=chunk))()
    assert F.shape == (n_pad,)
    assert np.all(np.isfinite(np.asarray(F)))
    cand = _max_candidates(y, W, Hp, magnitude)
    F_o, sums_o = _weighted_oracle(y, W, sigma, pi, Hp, gamma, magnitude,
                                   cand, w)
    np.testing.assert_allclose(np.asarray(F)[:N], F_o, rtol=3e-4, atol=3e-4)
    for key in ("numer", "denom", "s", "abs", "resid", "y2", "n", "F"):
        np.testing.assert_allclose(np.asarray(sums[key]), sums_o[key],
                                   rtol=3e-3, atol=3e-3, err_msg=key)


@pytest.mark.parametrize("magnitude", [False, True])
def test_max_estep_saturated_skips_true_channel(magnitude):
    """collect_true=False: F_true equals F exactly (the static drop) and
    every other sum is unchanged."""
    D, H, Hp, gamma, N = 16, 16, 4, 3, 64
    y, W = _max_problem(D, H, N, 19, magnitude)
    sa = state_arrays_from(binary_state_space(Hp, gamma))
    args = (jnp.asarray(y), jnp.ones((N,), jnp.float32), jnp.asarray(W),
            jnp.float32(1.0), jnp.float32(np.log(0.2 / 0.8)), sa, Hp,
            magnitude, jnp.float32(1.0), jnp.float32(1.0))
    F1, s1 = jax.jit(lambda: max_et_estep(*args, chunk=32))()
    F2, s2 = jax.jit(lambda: max_et_estep(*args, chunk=32,
                                          collect_true=False))()
    assert float(s2["F"]) == float(s2["F_true"])
    np.testing.assert_allclose(float(s1["F_true"]), float(s2["F_true"]),
                               rtol=1e-5)
    for k in s1:
        np.testing.assert_allclose(np.asarray(s1[k]), np.asarray(s2[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.asarray(F1), np.asarray(F2))


@pytest.mark.parametrize("cls", [MCA, MMCA])
def test_max_mstep_matches_oracle(cls):
    """finalize_mstep on the oracle's sums: W = numer/denom where a cause
    wins anywhere (else unchanged), the ET-corrected pi, the residual
    sigma."""
    from math import comb
    D, H, Hp, gamma, N = 9, 6, 6, 3, 12
    magnitude = cls is MMCA
    y, W = _max_problem(D, H, N, 21, magnitude)
    sigma, pi = 0.9, 0.2
    cand = np.tile(np.arange(H), (N, 1))
    _, sums_o = max_oracle(y, W, sigma, pi, Hp, gamma, magnitude, cand)
    model = cls(D, H, Hp, gamma)
    params = {"W": jnp.asarray(W), "pi": jnp.float32(pi),
              "sigma": jnp.float32(sigma)}
    sums = {k: jnp.asarray(np.asarray(v), jnp.float32)
            for k, v in sums_o.items()}
    sums["F_true"] = sums["F"]
    new, _ = model.finalize_mstep(params, sums, jnp.float32(N))
    denom = sums_o["denom"]
    W_o = np.where(denom > 1e-6, sums_o["numer"] / np.maximum(denom, 1e-6),
                   W.T).T
    A = sum(comb(H, k) * pi ** k * (1 - pi) ** (H - k)
            for k in range(gamma + 1))
    B = sum(k * comb(H, k) * pi ** k * (1 - pi) ** (H - k)
            for k in range(gamma + 1))
    pi_o = pi * (A / B) * sums_o["abs"] / sums_o["n"]
    sigma_o = np.sqrt(sums_o["resid"] / (sums_o["n"] * D))
    np.testing.assert_allclose(np.asarray(new["W"]), W_o, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(new["pi"]), pi_o, rtol=1e-4)
    np.testing.assert_allclose(float(new["sigma"]), sigma_o, rtol=1e-5)
