"""Unit tests for the per-slot candidate/scatter helpers.

These replace the stacked (C,Hp,H) one-hot + batched T/G/T2 einsums across
the XLA E-steps and decoders; the tests pin their algebra against the direct dense formulation
so the end-to-end oracle tests can't silently drift onto a different code
path.
"""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.core.etstep import (per_slot_candidates, slot_scatter_mat,
                                     slot_scatter_vec)
from prosper_tpu.core.select import (top_hprime_candidate_slots,
                                     top_hprime_candidates_dense)

C, D, H, Hp = 64, 16, 23, 5


def _setup(seed=0):
    # standard-normal P has both signs, so signed (|.|) and unsigned scoring
    # genuinely select different candidates in the tests below
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, H)).astype(np.float32)
    y = rng.standard_normal((C, D)).astype(np.float32)
    gram = W.T @ W
    P = jnp.asarray(y @ W)
    w_norm = jnp.sqrt(jnp.asarray(np.diag(gram)))
    return P, w_norm, jnp.asarray(gram)


def test_slots_match_dense_selection():
    for signed in (False, True):
        P, w_norm, gram = _setup()
        cand_d, onehot = top_hprime_candidates_dense(P, w_norm, Hp, signed)
        cand_s, hots = top_hprime_candidate_slots(P, w_norm, Hp, signed)
        np.testing.assert_array_equal(np.asarray(cand_d), np.asarray(cand_s))
        assert len(hots) == Hp
        np.testing.assert_array_equal(
            np.asarray(jnp.stack(hots, axis=1)), np.asarray(onehot))


def test_per_slot_candidates_algebra():
    P, w_norm, gram = _setup(seed=3)
    cand, hots, proj, Gf = per_slot_candidates(P, w_norm, Hp, False, gram)
    cand_np = np.asarray(cand)
    P_np, gram_np = np.asarray(P), np.asarray(gram)
    # proj[n,a] = P[n, cand[n,a]]; Gf[n, a*Hp+b] = gram[cand_a, cand_b]
    rows = np.arange(C)[:, None]
    np.testing.assert_allclose(np.asarray(proj), P_np[rows, cand_np],
                               rtol=1e-6)
    G_ref = gram_np[cand_np[:, :, None], cand_np[:, None, :]]
    np.testing.assert_allclose(np.asarray(Gf).reshape(C, Hp, Hp), G_ref,
                               rtol=1e-5, atol=1e-5)


def test_slot_scatters_match_einsums():
    P, w_norm, gram = _setup(seed=5)
    _, hots, _, _ = per_slot_candidates(P, w_norm, Hp, False, gram)
    onehot = jnp.stack(hots, axis=1)                         # (C,Hp,H)
    rng = np.random.default_rng(7)
    base = jnp.asarray(rng.standard_normal((C, H)).astype(np.float32))
    vals = jnp.asarray(rng.standard_normal((C, Hp)).astype(np.float32))
    ssw = jnp.asarray(
        rng.standard_normal((C, Hp * Hp)).astype(np.float32))
    ref_vec = base + jnp.einsum("na,nah->nh", vals, onehot)
    np.testing.assert_allclose(np.asarray(slot_scatter_vec(base, vals, hots)),
                               np.asarray(ref_vec), rtol=1e-5, atol=1e-5)
    T2 = jnp.einsum("nab,nbh->nah", ssw.reshape(C, Hp, Hp), onehot)
    ref_mat = jnp.einsum("nah,nak->hk", onehot, T2)
    np.testing.assert_allclose(np.asarray(slot_scatter_mat(ssw, hots, H)),
                               np.asarray(ref_mat), rtol=1e-4, atol=1e-4)
