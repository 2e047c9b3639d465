"""Dictionary-recovery diagnostics (data/diagnosis.py)."""

import numpy as np

from prosper_tpu.data.diagnosis import (dictionary_stats, diagnose_recovery,
                                        format_report)


def _planted(D=100, H=12, k=5, seed=0, intensity=10.0):
    """Disjoint-ish sparse atoms (the patches-scale generator, miniature)."""
    rng = np.random.default_rng(seed)
    W = np.zeros((D, H), np.float64)
    for h in range(H):
        W[rng.choice(D, size=k, replace=False), h] = intensity
    return W


def test_dictionary_stats_basic():
    W = _planted()
    st = dictionary_stats(W)
    assert st["norms"].shape == (12,)
    assert np.all(st["support"] == 5)          # exactly k active pixels
    assert st["median_support"] == 5.0
    assert st["coherence"].shape == (12, 12)
    assert np.allclose(np.diag(st["coherence"]), 0.0)


def test_diagnose_classifies_blend_duplicate_dead():
    gt = _planted(seed=1)
    Wl = gt.copy()
    # column 0 becomes a BLEND of atoms 0 and 1; column 1 is freed and
    # DUPLICATES atom 2; column 3 goes DEAD; atom 3 is then pure-missing
    Wl[:, 0] = gt[:, 0] + gt[:, 1]
    Wl[:, 1] = gt[:, 2] + 0.01
    Wl[:, 3] = 1e-4

    rep = diagnose_recovery(Wl, gt, threshold=0.8)
    missed = set(rep["missed"].tolist())
    # atoms 1 and 3 cannot both be covered (0 blended, 3 dead)
    assert 3 in missed
    assert rep["missed_classes"][3] == "missing"
    blend_atoms = {a for v in rep["blends"].values() for a in v[:2]}
    assert {0, 1} <= blend_atoms                 # blend col covers atoms 0+1
    blended_missed = [t for t, c in rep["missed_classes"].items()
                      if c == "blend"]
    assert any(t in (0, 1) for t in blended_missed)
    assert any({i, j} == {1, 2} for i, j, _ in rep["duplicates"])
    assert 3 in rep["dead"]

    txt = format_report(rep)
    assert "blend col 0" in txt and "dead cols" in txt


def test_diagnose_clean_recovery_has_no_findings():
    gt = _planted(seed=2)
    rng = np.random.default_rng(3)
    Wl = gt + 0.05 * rng.standard_normal(gt.shape)
    rep = diagnose_recovery(Wl, gt)
    assert rep["missed"].size == 0
    assert not rep["blends"] and not rep["duplicates"] and not rep["dead"]


def test_diagnose_matches_online_detector_pool():
    """The blend columns diagnose_recovery flags are exactly the ones the
    online split_coact candidate pool (support >= 1.5 x median) ranks
    first — the offline/online calibration contract."""
    gt = _planted(D=144, H=16, seed=4)
    Wl = gt.copy()
    Wl[:, 5] = gt[:, 5] + gt[:, 6]
    Wl[:, 6] = gt[:, 7] * 0.9                    # free the partner column
    rep = diagnose_recovery(Wl, gt)
    st = rep["stats"]
    pool = [h for h in np.argsort(-st["support"])
            if st["support"][h] >= 1.5 * st["median_support"]]
    assert list(rep["blends"]) == pool == [5]


def test_diagnose_real_patches_dictionary():
    """Regression on a real converged patches-scale dictionary (seed 2,
    saved by examples/patches_scale_run.py) — the calibration artifact the
    support-size detector was read off."""
    import os
    import pytest
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "patches_seed2_diag.npz")
    if not os.path.exists(path):
        pytest.skip("calibration npz not present")
    d = np.load(path)
    rep = diagnose_recovery(d["W"], d["gtW"])
    assert rep["recovered"].size == 289
    # every missed atom traces to a blend column
    assert set(rep["missed_classes"].values()) == {"blend"}
    # the six tight blends (cos ~0.75-0.83, support 13-15) are all flagged
    tight = [c for c, (a, b, ca, cb) in rep["blends"].items()
             if min(ca, cb) > 0.7]
    assert len(tight) >= 6


def test_split_blend_sweep_synthetic():
    """The offline sweep splits a planted blend
    into (blend col, donor col) using a junk column as the donor, without
    touching the healthy single-atom columns."""
    from prosper_tpu.data.diagnosis import split_blend_sweep

    rng = np.random.default_rng(0)
    D, H, ap = 144, 16, 6
    gt = _planted(D=D, H=H, seed=4, active_pixels=ap) \
        if "active_pixels" in _planted.__code__.co_varnames else _planted(
            D=D, H=H, seed=4)
    Wl = gt.copy()
    Wl[:, 5] = gt[:, 5] + gt[:, 6]               # blend of atoms 5+6
    # junk donor: wide unstructured column (support >> median)
    Wl[:, 6] = np.abs(rng.standard_normal(D)) * 2.0
    # data from the ground-truth model
    N = 20000
    s = (rng.random((N, H)) < 0.12)
    Y = s @ gt.T + 0.4 * rng.standard_normal((N, D))
    out = split_blend_sweep(Wl, Y)
    assert out["splits"], "no split fired on a planted blend"
    bcol, dcol = out["splits"][0]
    assert bcol == 5 and dcol == 6
    W2 = out["W"]
    gn = gt / (np.linalg.norm(gt, axis=0) + 1e-12)
    for atom in (5, 6):
        best = max(abs(float(gn[:, atom] @ W2[:, c]
                              / (np.linalg.norm(W2[:, c]) + 1e-12)))
                   for c in (bcol, dcol))
        assert best > 0.85, f"atom {atom} not recovered by the split"
    # healthy columns untouched
    for c in range(H):
        if c not in (5, 6):
            np.testing.assert_array_equal(W2[:, c], Wl[:, c])


def test_split_blend_sweep_relaxed_donor():
    """Taxonomy classes "missing-no-donor"/"blend-no-donor":
    with the primary donor pool empty, the weaker member of a RELAXED
    duplicate pair (coherence 0.65-0.85, chosen by wider support — the
    blend-like member) is donated instead of split, and a genuine blend
    with no other donor gets served."""
    from prosper_tpu.data.diagnosis import split_blend_sweep

    rng = np.random.default_rng(7)
    D, H = 144, 16
    gt = _planted(D=D, H=H, seed=4)
    Wl = gt.copy()
    Wl[:, 5] = gt[:, 5] + gt[:, 6]               # blend of atoms 5+6
    # col 6: redundant near-duplicate of col 7's atom (cos ~0.78 — below
    # the 0.85 primary gate, above the 0.65 relaxed gate), wider support
    Wl[:, 6] = gt[:, 7] + 0.8 * gt[:, 8]
    N = 20000
    s = (rng.random((N, H)) < 0.12)
    Y = s @ gt.T + 0.4 * rng.standard_normal((N, D))

    # without the relaxed pool: no donors, nothing can split
    out0 = split_blend_sweep(Wl, Y, relaxed_dup_threshold=0.0)
    assert not out0["splits"]
    out = split_blend_sweep(Wl, Y)
    assert (5, 6) in out["splits"], out["splits"]
    W2 = out["W"]
    gn = gt / (np.linalg.norm(gt, axis=0) + 1e-12)
    for atom in (5, 6):
        best = max(abs(float(gn[:, atom] @ W2[:, c]
                             / (np.linalg.norm(W2[:, c]) + 1e-12)))
                   for c in (5, 6))
        assert best > 0.85, f"atom {atom} not recovered"
    # atoms 7/8 remain covered by their untouched planted columns
    np.testing.assert_array_equal(W2[:, 7], Wl[:, 7])
    np.testing.assert_array_equal(W2[:, 8], Wl[:, 8])


def test_split_blend_sweep_real_seed2():
    """Regression on the real seed-2 dictionary: the sweep must lift
    recovery from 289 to >= 296 BEFORE any polish (round-4 measurement:
    297 with 5 splits on the regenerated data sample)."""
    import os
    import pytest
    from prosper_tpu.data.diagnosis import split_blend_sweep

    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "patches_seed2_diag.npz")
    if not os.path.exists(path):
        pytest.skip("calibration npz not present")
    d = np.load(path)
    rng = np.random.default_rng(3)
    N = 65536
    s = (rng.random((N, 300)) < 2.0 / 300)
    Y = (s @ d["gtW"].T.astype(np.float64)
         + rng.standard_normal((N, 256)))
    out = split_blend_sweep(d["W"], Y)
    rep = diagnose_recovery(out["W"], d["gtW"])
    assert rep["recovered"].size >= 296
