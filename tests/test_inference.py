"""Posterior decode / inference path (reference: CAModel.inference)."""

import numpy as np
import pytest

from prosper_tpu.data.bars import bars_gt_params
from prosper_tpu.models.linear import BSC, TSC


@pytest.fixture(scope="module")
def trained_like_setup():
    """Use the ground-truth params directly: inference should decode the
    generating states for low-noise data."""
    R = 4
    model = BSC(R * R, 2 * R, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=0.5, pi=0.15)
    data = model.generate_data(gt, 200, seed=42)
    return model, gt, data


def test_inference_shapes_and_normalisation(trained_like_setup):
    model, gt, data = trained_like_setup
    out = model.inference(gt, data, top_L=8)
    N, H, D = 200, model.H, model.D
    assert out["top_states"].shape == (N, 8, H)
    assert out["top_probs"].shape == (N, 8)
    assert out["s_mean"].shape == (N, H)
    assert out["recon"].shape == (N, D)
    p = np.asarray(out["top_probs"])
    # sorted descending, valid probabilities
    assert (np.diff(p, axis=1) <= 1e-6).all()
    assert (p >= 0).all() and (p.sum(axis=1) <= 1.0 + 1e-5).all()


def test_inference_decodes_generating_states(trained_like_setup):
    model, gt, data = trained_like_setup
    out = model.inference(gt, data, top_L=5)
    s_true = np.asarray(data["s"])
    # restrict to datapoints whose true state lies in the truncated space
    k = s_true.sum(axis=1)
    ok = k <= model.gamma
    best = np.asarray(out["top_states"][:, 0, :])
    match = (best[ok] == s_true[ok]).all(axis=1).mean()
    assert match > 0.9, f"MAP decode accuracy {match:.2f}"
    # reconstruction error bounded by noise scale
    resid = np.asarray(out["recon"]) - s_true @ np.asarray(gt["W"]).T
    rms = np.sqrt((resid[ok] ** 2).mean())
    assert rms < 1.5  # sigma=0.5 data


def test_inference_tsc_signed():
    R = 4
    model = TSC(R * R, 2 * R, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=0.5, pi=0.15)
    data = model.generate_data(gt, 100, seed=7)
    out = model.inference(gt, data, top_L=3)
    s_true = np.asarray(data["s"])
    k = np.abs(s_true).sum(axis=1)
    ok = k <= model.gamma
    best = np.asarray(out["top_states"][:, 0, :])
    match = (best[ok] == s_true[ok]).all(axis=1).mean()
    assert match > 0.85, f"ternary MAP decode accuracy {match:.2f}"


def test_inference_mca_decodes():
    from prosper_tpu.models.mca import MCA
    R = 4
    model = MCA(R * R, 2 * R, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=0.5, pi=0.15)
    data = model.generate_data(gt, 150, seed=9)
    out = model.inference(gt, data, top_L=5)
    s_true = np.asarray(data["s"])
    ok = s_true.sum(axis=1) <= model.gamma
    best = np.asarray(out["top_states"][:, 0, :])
    match = (best[ok] == s_true[ok]).all(axis=1).mean()
    assert match > 0.85, f"MCA MAP decode accuracy {match:.2f}"
    assert out["recon"].shape == (150, model.D)


def test_inference_gsc_support_recovery():
    from prosper_tpu.models.gsc import GSC
    R = 4
    model = GSC(R * R, 2 * R, 5, 3)
    gt = bars_gt_params(model, intensity=5.0, sigma=0.3, pi=0.15)
    gt["mu"] = np.float32(1.0)
    gt["psi"] = np.float32(0.04)
    data = model.generate_data(gt, 150, seed=10)
    out = model.inference(gt, data, top_L=5)
    s_true = np.asarray(data["s"])
    supp_true = (np.abs(s_true) > 1e-9).astype(np.float32)
    ok = supp_true.sum(axis=1) <= model.gamma
    best = np.asarray(out["top_states"][:, 0, :])
    match = (best[ok] == supp_true[ok]).all(axis=1).mean()
    assert match > 0.8, f"GSC MAP support accuracy {match:.2f}"
    # slab mean recovers the generating amplitudes where active
    sz = np.asarray(out["s_mean"])
    err = np.abs(sz[ok] - s_true[ok]).max(axis=1)
    assert np.median(err) < 0.5


def test_chunked_decode_matches_unchunked():
    """Chunked lax.map decode (incl. non-multiple padding) must equal the
    single-pass result elementwise."""
    import jax.numpy as jnp
    from prosper_tpu.core.etstep import linear_et_posterior, state_arrays_from
    from prosper_tpu.core.states import discrete_state_space

    N, D, H, Hp, gamma = 100, 12, 10, 5, 3     # 100 % 32 != 0 -> padding path
    rng = np.random.default_rng(6)
    y = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    W = jnp.asarray(rng.standard_normal((D, H)), jnp.float32)
    sa = state_arrays_from(discrete_state_space(Hp, gamma, [1.0]))
    lo = jnp.asarray([-1.5], jnp.float32)
    args = (y, W, jnp.float32(1.2), lo, sa, Hp, False, 5)
    full = linear_et_posterior(*args, chunk=4096)
    parts = linear_et_posterior(*args, chunk=32)
    for k in full:
        np.testing.assert_allclose(np.asarray(parts[k]), np.asarray(full[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_inference_dsc_three_values():
    """DSC decode with Phi={1,2,3}: MAP states recover generating values."""
    from prosper_tpu.models.linear import DSC
    R = 4
    model = DSC(R * R, 2 * R, 5, 3, phi=(1.0, 2.0, 3.0))
    gt = bars_gt_params(model, intensity=10.0, sigma=0.4, pi=0.12)
    data = model.generate_data(gt, 150, seed=12)
    out = model.inference(gt, data, top_L=4)
    s_true = np.asarray(data["s"])
    ok = (np.abs(s_true) > 1e-9).sum(axis=1) <= model.gamma
    best = np.asarray(out["top_states"][:, 0, :])
    match = (best[ok] == s_true[ok]).all(axis=1).mean()
    assert match > 0.8, f"DSC MAP decode accuracy {match:.2f}"


def test_infer_cache_is_per_instance_and_reused():
    """The jitted-decoder cache keys on
    (family, top_L, chunk) but lives on the model INSTANCE, so two models
    sharing a family key cannot collide; repeated serves reuse one
    compiled decoder per (top_L, chunk)."""
    R = 4
    m1 = BSC(R * R, 2 * R, 5, 3)
    m2 = BSC(R * R, 4 * R, 5, 3)          # different H, same family key
    gt1 = bars_gt_params(m1, intensity=10.0, sigma=0.5, pi=0.15)
    gt2 = bars_gt_params(m2, intensity=10.0, sigma=0.5, pi=0.15)
    data = m1.generate_data(gt1, 64, seed=1)

    out1 = m1.inference(gt1, data, top_L=5)
    out1b = m1.inference(gt1, data, top_L=5)     # cache hit
    assert len(m1._infer_cache) == 1
    out1c = m1.inference(gt1, data, top_L=3)     # new key
    assert len(m1._infer_cache) == 2

    # same family key on a different instance: independent cache, correct
    # shapes for ITS (different) H
    out2 = m2.inference(gt2, data, top_L=5)
    assert len(m2._infer_cache) == 1
    assert out2["top_states"].shape == (64, 5, m2.H)
    assert out1["top_states"].shape == (64, 5, m1.H)
    np.testing.assert_allclose(np.asarray(out1["top_probs"]),
                               np.asarray(out1b["top_probs"]))


def test_inference_sharded_over_mesh_matches_single_device():
    """Data-parallel serving: model.inference(..., runtime=rt)
    shard_maps the decode over the mesh data axis; outputs must match the
    single-device decode exactly."""
    import jax
    import jax.numpy as jnp

    from prosper_tpu.models.linear import BSC
    from prosper_tpu.parallel.mesh import MeshRuntime

    model = BSC(D=16, H=8, Hprime=5, gamma=3, chunk=32)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 256, seed=6)
    params = model.standard_init(data, seed=7)

    out1 = model.inference(params, {"y": data["y"]}, top_L=4)

    rt = MeshRuntime(devices=jax.devices()[:8])
    y_sh = rt.shard_data({"y": jnp.asarray(data["y"], jnp.float32)})["y"]
    out2 = model.inference(params, {"y": y_sh}, top_L=4, runtime=rt)

    for k in out1:
        np.testing.assert_allclose(np.asarray(out1[k]), np.asarray(out2[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_dense_states_auto_by_output_size():
    """Dense_states=None (the new default)
    auto-selects — dense (N, L, H) output for small batches, compact
    fields once the dense tensor would exceed DENSE_STATES_AUTO_BYTES.
    Explicit True/False still force either layout."""
    model = BSC(16, 8, 5, 3)
    rng = np.random.default_rng(8)
    y = rng.standard_normal((64, model.D)).astype(np.float32)
    params = model.standard_init({"y": y}, seed=3)

    # small batch -> auto resolves dense
    out = model.inference(params, {"y": y}, top_L=4)
    assert "top_states" in out and out["top_states"].shape == (64, 4, 8)

    # at serving scale the dense (N, L, H) tensor crosses the byte budget
    # -> auto resolves compact (checked via the resolver, no giant alloc)
    big_N = model.DENSE_STATES_AUTO_BYTES // (4 * 4 * model.H) + 1
    assert model.resolve_dense_states(big_N, 4, None) is False
    assert model.resolve_dense_states(big_N, 4, True) is True
    assert model.resolve_dense_states(4, 4, False) is False

    # forcing compact on the small batch returns the compact fields
    out_c = model.inference(params, {"y": y}, top_L=4, dense_states=False)
    assert "top_states" not in out_c and "top_cand_states" in out_c


@pytest.mark.parametrize("family", ["bsc", "dsc", "gsc", "mca"])
def test_compact_decode_densifies_to_dense(family):
    """inference(dense_states=False) + densify_top_states must reproduce the
    dense top_states bit-for-bit (the compact path replaces the layout-
    hostile (N, L, H) construction with candidate-space fields —
    tools/ablate_decode.py)."""
    from prosper_tpu.core.etstep import densify_top_states

    rng = np.random.default_rng(7)
    N, L = 64, 6
    if family == "bsc":
        model = BSC(16, 8, 5, 3)
    elif family == "dsc":
        from prosper_tpu.models.linear import DSC
        model = DSC(16, 8, 4, 3, phi=(-1.0, 1.0, 2.0))
    elif family == "gsc":
        from prosper_tpu.models.gsc import GSC
        model = GSC(16, 8, 5, 3)
    else:
        from prosper_tpu.models.mca import MCA
        model = MCA(16, 8, 5, 3)
    y = rng.standard_normal((N, model.D)).astype(np.float32)
    params = model.standard_init({"y": y}, seed=3)
    dense = model.inference(params, {"y": y}, top_L=L)
    compact = model.inference(params, {"y": y}, top_L=L, dense_states=False)

    assert "top_states" not in compact
    assert compact["top_cand_states"].shape == (N, L, model.Hprime)
    assert compact["cand"].shape == (N, model.Hprime)
    np.testing.assert_array_equal(np.asarray(dense["top_probs"]),
                                  np.asarray(compact["top_probs"]))
    for k in ("s_mean", "recon", "F"):
        np.testing.assert_array_equal(np.asarray(dense[k]),
                                      np.asarray(compact[k]))
    ts = densify_top_states(compact, model.H)
    np.testing.assert_allclose(np.asarray(ts),
                               np.asarray(dense["top_states"]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("values,signed", [((1.0,), False),
                                           ((-1.0, 1.0), True)])
@pytest.mark.parametrize("dense", [True, False])
def test_decode_matches_oracle(values, signed, dense):
    """linear_et_posterior (chunked, N not a multiple of the chunk) against
    the float64 oracle per datapoint: F and the posterior mean, in both
    output layouts; compact top states densify to the dense ones."""
    _check_decode_against_oracle(values, signed, dense, beta=1.0,
                                 prior_beta=1.0)


def test_decode_annealed_matches_oracle():
    """beta/prior_beta != 1 flow through the decode's logits."""
    _check_decode_against_oracle((1.0,), False, False, beta=0.5,
                                 prior_beta=0.7)


def _check_decode_against_oracle(values, signed, dense, beta, prior_beta):
    import jax.numpy as jnp
    from prosper_tpu.core.etstep import (densify_top_states,
                                         linear_et_posterior,
                                         state_arrays_from)
    from prosper_tpu.core.select import top_hprime_candidates
    from prosper_tpu.core.states import discrete_state_space
    from tests.oracle import linear_oracle_estep

    N, D, H, Hp, gamma = 37, 12, 11, 5, 3
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, D)).astype(np.float32)
    W = rng.standard_normal((D, H)).astype(np.float32)
    K = len(values)
    pi_vec = np.full(K, 0.4 / (H * K))
    sa = state_arrays_from(discrete_state_space(Hp, gamma, list(values)))
    log_odds = jnp.asarray(np.log(pi_vec) - np.log1p(-pi_vec.sum()),
                           jnp.float32)
    kw = dict(sigma2=jnp.float32(0.8 ** 2), log_odds=log_odds, sa=sa, Hp=Hp,
              signed_select=signed, top_L=7, beta=jnp.float32(beta),
              prior_beta=jnp.float32(prior_beta))
    out = linear_et_posterior(jnp.asarray(y), jnp.asarray(W), chunk=16,
                              dense_states=dense, **kw)
    if not dense:
        ref = linear_et_posterior(jnp.asarray(y), jnp.asarray(W), chunk=16,
                                  dense_states=True, **kw)
        np.testing.assert_array_equal(
            np.asarray(densify_top_states(out, H)),
            np.asarray(ref["top_states"]))
    P = jnp.dot(jnp.asarray(y), jnp.asarray(W))
    cand = np.asarray(top_hprime_candidates(
        P, jnp.linalg.norm(jnp.asarray(W), axis=0), Hp, signed))
    F_o, s_o = [], []
    for n in range(N):
        F_n, sums_n = linear_oracle_estep(
            y[n:n + 1], W, 0.8, pi_vec, list(values), Hp, gamma, beta=beta,
            prior_beta=prior_beta, candidates=cand[n:n + 1])
        F_o.append(F_n[0])
        s_o.append(sums_n["s"])
    np.testing.assert_allclose(np.asarray(out["F"]), F_o, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out["s_mean"]), np.array(s_o),
                               rtol=1e-4, atol=1e-5)
    probs = np.asarray(out["top_probs"])
    assert np.all(np.diff(probs, axis=1) <= 1e-7)
    assert np.all(probs.sum(axis=1) <= 1.0 + 1e-5)
