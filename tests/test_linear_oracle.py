"""Jitted E/M-step vs float64 NumPy oracle (SURVEY.md §4 item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prosper_tpu.core.etstep import (
    linear_et_estep,
    state_arrays_from,
    truncated_prior_logmass,
)
from prosper_tpu.core.states import discrete_state_space
from prosper_tpu.models.linear import BSC, DSC, TSC

from tests.oracle import bsc_oracle_mstep, linear_oracle_estep


def _random_problem(seed, N, D, H):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H))
    y = rng.standard_normal((N, D)) * 2.0
    return y.astype(np.float32), W.astype(np.float32)


CASES = [
    # (values, pi_vec_fn, signed)
    ("bsc", [1.0], lambda pi: [pi], False),
    ("tsc", [-1.0, 1.0], lambda pi: [pi / 2, pi / 2], True),
    ("dsc", [-1.0, 1.0, 2.0], lambda pi: [pi / 3] * 3, True),
    ("dsc_pos", [0.5, 1.0, 2.0], lambda pi: [pi / 3] * 3, False),
]


@pytest.mark.parametrize("name,values,pi_fn,signed", CASES)
@pytest.mark.parametrize("beta,prior_beta", [(1.0, 1.0), (0.25, 1.0)])
def test_estep_matches_oracle(name, values, pi_fn, signed, beta, prior_beta):
    # Hp == H: every unit is a candidate, so the comparison is insensitive
    # to float32 near-ties in the affinity ranking (selection itself is
    # covered by test_estep_matches_oracle_subset_candidates).
    N, D, H, Hp, gamma = 24, 12, 6, 6, 3
    y, W = _random_problem(0, N, D, H)
    sigma, pi = 1.3, 0.2
    pi_vec = np.asarray(pi_fn(pi))

    space = discrete_state_space(Hp, gamma, values)
    sa = state_arrays_from(space)
    log_odds = jnp.asarray(np.log(pi_vec) - np.log(1 - pi_vec.sum()),
                           jnp.float32)
    weight = jnp.ones((N,), jnp.float32)

    F, sums = jax.jit(
        lambda y_: linear_et_estep(y_, weight, jnp.asarray(W),
                                   jnp.float32(sigma ** 2), log_odds, sa, Hp,
                                   signed, jnp.float32(beta),
                                   jnp.float32(prior_beta), chunk=2048)
    )(jnp.asarray(y))

    # oracle over identity candidates (set equality is what matters)
    cand = np.tile(np.arange(H), (N, 1))
    F_o, sums_o = linear_oracle_estep(y, W, sigma, pi_vec, values, Hp, gamma,
                                      beta=beta, prior_beta=prior_beta,
                                      signed_select=signed, candidates=cand)

    np.testing.assert_allclose(np.asarray(F), F_o, rtol=2e-4, atol=2e-4)
    for key in ("xs", "ss", "s", "abs", "vc", "y2", "n", "F"):
        np.testing.assert_allclose(np.asarray(sums[key]), sums_o[key],
                                   rtol=3e-3, atol=3e-3, err_msg=key)


def test_estep_matches_oracle_subset_candidates():
    """Hp < H: feed the jax-selected candidates into the oracle so both sides
    enumerate the same truncated sets; verifies the gather/scatter paths."""
    from prosper_tpu.core.select import top_hprime_candidates

    N, D, H, Hp, gamma = 16, 10, 8, 4, 3
    y, W = _random_problem(7, N, D, H)
    sigma, pi = 1.2, 0.25
    space = discrete_state_space(Hp, gamma, [1.0])
    sa = state_arrays_from(space)
    log_odds = jnp.asarray([np.log(pi / (1 - pi))], jnp.float32)
    weight = jnp.ones((N,), jnp.float32)

    F, sums = jax.jit(
        lambda y_: linear_et_estep(y_, weight, jnp.asarray(W),
                                   jnp.float32(sigma ** 2), log_odds, sa, Hp,
                                   False, jnp.float32(1.0), jnp.float32(1.0),
                                   chunk=2048)
    )(jnp.asarray(y))

    P = jnp.dot(jnp.asarray(y), jnp.asarray(W))
    wn = jnp.linalg.norm(jnp.asarray(W), axis=0)
    cand = np.asarray(top_hprime_candidates(P, wn, Hp, False))
    F_o, sums_o = linear_oracle_estep(y, W, sigma, [pi], [1.0], Hp, gamma,
                                      candidates=cand)
    np.testing.assert_allclose(np.asarray(F), F_o, rtol=5e-4, atol=5e-4)
    for key in ("xs", "ss", "s", "abs", "y2"):
        np.testing.assert_allclose(np.asarray(sums[key]), sums_o[key],
                                   rtol=3e-3, atol=3e-3, err_msg=key)


def test_chunked_equals_unchunked():
    N, D, H, Hp, gamma = 64, 10, 9, 5, 3
    y, W = _random_problem(1, N, D, H)
    space = discrete_state_space(Hp, gamma, [1.0])
    sa = state_arrays_from(space)
    log_odds = jnp.asarray([np.log(0.15 / 0.85)], jnp.float32)
    weight = jnp.ones((N,), jnp.float32)
    args = (jnp.asarray(y), weight, jnp.asarray(W), jnp.float32(1.0),
            log_odds, sa, Hp, False, jnp.float32(1.0), jnp.float32(1.0))
    F1, s1 = linear_et_estep(*args, chunk=2048)
    F2, s2 = linear_et_estep(*args, chunk=16)
    np.testing.assert_allclose(np.asarray(F1), np.asarray(F2), rtol=1e-5,
                               atol=1e-5)
    for k in s1:
        np.testing.assert_allclose(np.asarray(s1[k]), np.asarray(s2[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_mstep_matches_oracle():
    N, D, H, Hp, gamma = 32, 12, 8, 5, 3
    y, W = _random_problem(2, N, D, H)
    sigma, pi = 1.1, 0.18
    model = BSC(D, H, Hp, gamma)
    _, sums_o = linear_oracle_estep(y, W, sigma, [pi], [1.0], Hp, gamma)
    sums = {k: jnp.asarray(np.asarray(v), jnp.float32)
            for k, v in sums_o.items()}
    logA, logB = truncated_prior_logmass(jnp.log(jnp.float32(pi)), H, gamma)
    params = {"W": jnp.asarray(W), "pi": jnp.float32(pi),
              "sigma": jnp.float32(sigma)}
    new = model.m_step(params, sums, logA, logB)
    oracle = bsc_oracle_mstep(sums_o, pi, H, gamma, D)
    np.testing.assert_allclose(np.asarray(new["W"]), oracle["W"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(float(new["pi"]), oracle["pi"], rtol=1e-3)
    np.testing.assert_allclose(float(new["sigma"]), oracle["sigma"], rtol=1e-3)


def test_truncated_prior_logmass():
    from math import comb
    H, gamma, pi = 20, 4, 0.13
    logA, logB = truncated_prior_logmass(jnp.log(jnp.float32(pi)), H, gamma)
    A = sum(comb(H, k) * pi ** k * (1 - pi) ** (H - k) for k in range(gamma + 1))
    B = sum(k * comb(H, k) * pi ** k * (1 - pi) ** (H - k)
            for k in range(gamma + 1))
    np.testing.assert_allclose(float(jnp.exp(logA)), A, rtol=1e-3)
    np.testing.assert_allclose(float(jnp.exp(logB)), B, rtol=1e-3)


@pytest.mark.parametrize("cls,kwargs", [
    (BSC, {}), (TSC, {}), (DSC, {"phi": (-1.0, 1.0, 2.0)})])
def test_model_step_runs_and_improves_F(cls, kwargs):
    """One full fused step runs under jit and a second step does not crash;
    free energy after an EM step should not decrease (weak smoke check)."""
    D, H, Hp, gamma = 16, 6, 4, 3
    model = cls(D, H, Hp, gamma, **kwargs)
    gt = model.standard_init({"y": np.random.default_rng(3)
                              .standard_normal((50, D))}, seed=0)
    data_np = model.generate_data(gt, 200, seed=1)
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal
    from prosper_tpu.engine.anneal import LinearAnnealing
    data = make_blank_data(data_np["y"])
    params = model.standard_init(data_np, seed=2)
    anneal = LinearAnnealing(5)
    sched = sched_from_anneal(anneal)
    rng = jax.random.PRNGKey(0)
    step = model.jit_step()
    p1, F1, s1 = step(params, data, sched, rng)
    data = dict(data, F_prev=F1)
    p2, F2, s2 = step(p1, data, sched, rng)
    assert np.isfinite(float(s1["F_mean"])) and np.isfinite(float(s2["F_mean"]))
    assert float(s2["F_mean"]) >= float(s1["F_mean"]) - 1e-3


@pytest.mark.parametrize("cls,kw", [("BSC", {}), ("TSC", {}),
                                    ("DSC", {"phi": (-1.0, 1.0, 2.0)})])
def test_sblock_path_matches_standard(cls, kw):
    """The big-S online-logsumexp path (s_block > 0) must reproduce the
    standard (materialised-logits) E-step: per-datapoint F, all summed
    sufficient statistics, and the M-step output.  Covers S % s_block != 0
    padding and the N > chunk scan-of-scan."""
    from prosper_tpu.models.linear import BSC, DSC, TSC

    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal

    factory = {"BSC": BSC, "TSC": TSC, "DSC": DSC}[cls]
    rng = np.random.default_rng(3)
    N = 384
    m_std = factory(16, 12, 6, 4, chunk=128, **kw)
    S = m_std.sa.states.shape[0]
    m_blk = factory(16, 12, 6, 4, chunk=128, s_block=48, **kw)
    assert S % 48 != 0, "test must exercise the state-padding edge"
    y = rng.standard_normal((N, 16)).astype(np.float32)
    params = m_std.standard_init({"y": y}, seed=4)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(10))
    key = jax.random.PRNGKey(0)
    p1, F1, s1 = m_std.jit_step()(params, data, sched, key)
    p2, F2, s2 = m_blk.jit_step()(params, data, sched, key)
    np.testing.assert_allclose(np.asarray(F1), np.asarray(F2),
                               rtol=2e-5, atol=1e-4)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    for k in ("F_mean", "Q_mean", "n_used"):
        np.testing.assert_allclose(float(s1[k]), float(s2[k]), rtol=2e-5)


def test_sblock_rejects_phi_learning_combo():
    """s_block composes with state sharding as of round 3, but not with
    Phi-learning statistics (the DP over slot_onehot is not blocked)."""
    from prosper_tpu.core.etstep import linear_et_estep
    from prosper_tpu.models.linear import BSC

    m = BSC(16, 12, 6, 3)
    y = jnp.zeros((32, 16), jnp.float32)
    w = jnp.ones((32,), jnp.float32)
    with pytest.raises(ValueError, match="s_block"):
        linear_et_estep(y, w, jnp.zeros((16, 12)), jnp.float32(1.0),
                        jnp.zeros((1,)), m.sa, 6, False, 1.0, 1.0,
                        chunk=32, collect_phi=True, s_block=16)


def test_sblock_prior_beta_zero_matches_standard():
    """At prior_beta=0 the big-S path's
    padded states used to enter the softmax with logit 0 (the padding mask
    was encoded as prior=neg, which prior_beta=0 wiped out), corrupting F
    and every sufficient statistic.  The explicit validity mask must make
    the s_block path match the standard path at prior_beta=0 exactly."""
    from prosper_tpu.core.etstep import linear_et_estep
    from prosper_tpu.models.linear import BSC

    m = BSC(16, 12, 6, 4, chunk=128)
    S = m.sa.states.shape[0]
    assert S % 48 != 0, "test must exercise the state-padding edge"
    rng = np.random.default_rng(7)
    y = jnp.asarray(rng.standard_normal((128, 16)).astype(np.float32))
    w = jnp.ones((128,), jnp.float32)
    W = jnp.asarray(rng.standard_normal((16, 12)).astype(np.float32))
    lo = jnp.full((1,), np.log(0.2 / 0.8), jnp.float32)
    args = (y, w, W, jnp.float32(1.0), lo, m.sa, 6, False,
            jnp.float32(1.0), jnp.float32(0.0))
    F1, s1 = jax.jit(lambda: linear_et_estep(*args, chunk=128))()
    F2, s2 = jax.jit(lambda: linear_et_estep(*args, chunk=128,
                                             s_block=48))()
    np.testing.assert_allclose(np.asarray(F1), np.asarray(F2),
                               rtol=2e-5, atol=1e-4)
    for k in s1:
        np.testing.assert_allclose(np.asarray(s1[k]), np.asarray(s2[k]),
                                   rtol=2e-5, atol=1e-4, err_msg=k)


def test_sblock_compute_dtype_runs():
    """Compute_dtype threads through the
    s_block path (previously silently dropped)."""
    from prosper_tpu.models.linear import TSC

    rng = np.random.default_rng(9)
    y = rng.standard_normal((128, 16)).astype(np.float32)
    m = TSC(16, 12, 6, 4, chunk=128, s_block=48, compute_dtype="bfloat16")
    from prosper_tpu.engine.anneal import LinearAnnealing
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal
    params = m.standard_init({"y": y}, seed=4)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(5))
    p, F, s = m.jit_step()(params, data, sched, jax.random.PRNGKey(0))
    assert np.isfinite(float(s["F_mean"]))


# ---- case grids on the XLA path: value sets, padding, zero-weight tiles,
# annealed (beta, prior_beta), the s_block scan under saturation ----------

def _oracle_problem(values, N, seed=0, D=16, H=12, Hp=6, gamma=3,
                    weight=None):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    if weight is None:
        weight = (rng.random(N) > 0.2).astype(np.float32)
    K = len(values)
    pi_vec = np.full(K, 0.2 / K)
    sa = state_arrays_from(discrete_state_space(Hp, gamma, list(values)))
    log_odds = jnp.asarray(np.log(pi_vec) - np.log(1 - pi_vec.sum()),
                           jnp.float32)
    return y, W, np.asarray(weight, np.float32), pi_vec, sa, log_odds


def _device_candidates(y, W, Hp, signed):
    from prosper_tpu.core.select import top_hprime_candidates
    P = jnp.dot(jnp.asarray(y), jnp.asarray(W))
    return np.asarray(top_hprime_candidates(
        P, jnp.linalg.norm(jnp.asarray(W), axis=0), Hp, signed))


def _assert_sums_match(F, sums, F_o, sums_o, keys, rtol=3e-3, atol=3e-3):
    np.testing.assert_allclose(np.asarray(F), F_o, rtol=2e-4, atol=2e-4)
    for k in keys:
        np.testing.assert_allclose(np.asarray(sums[k]), sums_o[k],
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("values,signed", [([1.0], False),
                                           ([-1.0, 1.0], True),
                                           ([0.5, 1.0, 2.0], False)])
@pytest.mark.parametrize("N", [33, 57, 100])
def test_padded_weighted_estep_matches_oracle(values, signed, N):
    """Any N works: the shard pads to the chunk with weight-0 rows, which
    contribute nothing; weighted rows match the oracle's weighted sums."""
    Hp, gamma, chunk = 6, 3, 32
    y, W, w, pi_vec, sa, lo = _oracle_problem(values, N, seed=N)
    n_pad = -(-N // chunk) * chunk
    y_p = np.pad(y, ((0, n_pad - N), (0, 0)))
    w_p = np.pad(w, (0, n_pad - N))
    F, sums = jax.jit(lambda: linear_et_estep(
        jnp.asarray(y_p), jnp.asarray(w_p), jnp.asarray(W),
        jnp.float32(1.3 ** 2), lo, sa, Hp, signed, jnp.float32(0.7),
        jnp.float32(1.0), chunk=chunk))()
    cand = _device_candidates(y, W, Hp, signed)
    F_o, sums_o = linear_oracle_estep(y, W, 1.3, pi_vec, values, Hp, gamma,
                                      beta=0.7, signed_select=signed,
                                      weight=w, candidates=cand)
    assert F.shape == (n_pad,)
    _assert_sums_match(F[:N], sums, F_o, sums_o,
                       ("xs", "ss", "s", "abs", "vc", "y2", "n", "F"))


@pytest.mark.parametrize("values,signed", [([1.0], False),
                                           ([-1.0, 1.0], True)])
@pytest.mark.parametrize("masked", ["second_tile", "everything"])
def test_zero_weight_tiles_contribute_nothing(values, signed, masked):
    """A chunk whose rows all carry weight 0 (Ncut masked it) adds exactly
    nothing; with every weight 0 every sum is zero."""
    N, Hp, gamma = 64, 6, 3
    w = np.ones(N, np.float32)
    if masked == "second_tile":
        w[32:] = 0.0
    else:
        w[:] = 0.0
    y, W, w, pi_vec, sa, lo = _oracle_problem(values, N, seed=5, weight=w)
    F, sums = jax.jit(lambda: linear_et_estep(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(W), jnp.float32(1.69),
        lo, sa, Hp, signed, jnp.float32(1.0), jnp.float32(1.0),
        chunk=32))()
    if masked == "everything":
        for k, v in sums.items():
            np.testing.assert_allclose(np.asarray(v), 0.0, atol=1e-6,
                                       err_msg=k)
        assert np.all(np.isfinite(np.asarray(F)))
        return
    cand = _device_candidates(y, W, Hp, signed)
    F_o, sums_o = linear_oracle_estep(y, W, 1.3, pi_vec, values, Hp, gamma,
                                      signed_select=signed, weight=w,
                                      candidates=cand)
    _assert_sums_match(F, sums, F_o, sums_o,
                       ("xs", "ss", "s", "abs", "vc", "y2", "n", "F"))


@pytest.mark.parametrize("beta,prior_beta", [(1.0, 1.0), (0.6, 1.0),
                                             (0.8, 0.8)])
@pytest.mark.parametrize("values", [(1.0,), (-1.0, 1.0)])
def test_sblock_estep_matches_oracle(beta, prior_beta, values):
    """The big-S s_block scan (state padding: s_block does not divide S)
    reproduces the float64 oracle, annealed schedules included."""
    D, H, Hp, gamma, N = 16, 24, 6, 4, 48
    signed = len(values) > 1
    y, W, w, pi_vec, sa, lo = _oracle_problem(values, N, seed=3, D=D, H=H,
                                              Hp=Hp, gamma=gamma)
    assert sa.states.shape[0] % 16 != 0
    F, sums = jax.jit(lambda: linear_et_estep(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(W), jnp.float32(1.44),
        lo, sa, Hp, signed, jnp.float32(beta), jnp.float32(prior_beta),
        chunk=N, s_block=16))()
    cand = _device_candidates(y, W, Hp, signed)
    F_o, sums_o = linear_oracle_estep(y, W, 1.2, pi_vec, list(values), Hp,
                                      gamma, beta=beta, prior_beta=prior_beta,
                                      signed_select=signed, weight=w,
                                      candidates=cand)
    _assert_sums_match(F, sums, F_o, sums_o,
                       ("xs", "ss", "s", "abs", "vc", "y2", "n", "F"))


@pytest.mark.parametrize("saturated", [False, True])
def test_sblock_model_step_matches_standard_with_padding_rows(saturated):
    """TSC with s_block through jit_step matches the standard step, with
    zero-weight rows, in both step specializations (saturated drops the
    un-annealed channel)."""
    D, H, Hp, gamma, N = 16, 20, 6, 4, 96
    y = np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)
    outs = []
    for s_block in (0, 16):
        m = TSC(D, H, Hp, gamma, chunk=N, s_block=s_block)
        params = m.standard_init({"y": y}, seed=5)
        from prosper_tpu.engine.anneal import LinearAnnealing
        from prosper_tpu.models.base import make_blank_data, sched_from_anneal
        data = make_blank_data(y, valid=np.r_[np.ones(80), np.zeros(16)])
        sched = sched_from_anneal(LinearAnnealing(10))
        p, F, s = m.jit_step(saturated=saturated)(params, data, sched,
                                                  jax.random.PRNGKey(0))
        outs.append((p, np.asarray(F), float(s["F_mean"])))
    for k in outs[0][0]:
        np.testing.assert_allclose(np.asarray(outs[0][0][k]),
                                   np.asarray(outs[1][0][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-5)
