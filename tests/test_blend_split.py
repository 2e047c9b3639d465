"""Co-activation-guided blend splitting.

Diagnosis: the stable patches-scale failures are *blends* — one
learned column fuses two planted atoms (w_b ~= a1 + a2, near-disjoint
supports).  ``coactivation_split`` reads the partition off the data: among
datapoints correlated with w_b, a1's pixels co-vary together and
anti-correlate with a2's pixels, so the top covariance eigenvector's sign
splits the support.
"""

import numpy as np

from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM, coactivation_split
from prosper_tpu.models.linear import BSC


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_coactivation_split_recovers_fused_atoms():
    rng = np.random.default_rng(0)
    D = 64
    a1 = np.zeros(D)
    a1[[0, 3, 7, 11, 20, 33]] = 10.0
    a2 = np.zeros(D)
    a2[[5, 14, 28, 40, 51, 60]] = 10.0
    # mostly single-atom activations (P(both) ~ pi^2 at realistic sparsity)
    rows = []
    for _ in range(2000):
        r = rng.random()
        x = 0.5 * rng.standard_normal(D)
        if r < 0.05:
            x += a1
        elif r < 0.10:
            x += a2
        elif r < 0.105:
            x += a1 + a2
        rows.append(x)
    Y = np.array(rows)

    parts = coactivation_split(a1 + a2, Y)
    assert parts is not None
    w1, w2 = parts
    cs = sorted([max(_cos(w1, a1), _cos(w1, a2)),
                 max(_cos(w2, a1), _cos(w2, a2))])
    assert cs[0] > 0.95, f"split failed: cosines {cs}"
    # the two halves must match DIFFERENT atoms
    assert not (_cos(w1, a1) > 0.9 and _cos(w2, a1) > 0.9)


def test_coactivation_split_rejects_single_atom():
    rng = np.random.default_rng(1)
    D = 64
    a1 = np.zeros(D)
    a1[[2, 9, 17, 25, 44, 58]] = 10.0
    Y = 0.5 * rng.standard_normal((1500, D))
    Y[:100] += a1
    # a clean single atom has no two-group structure: all support pixels
    # co-vary together -> one-sided eigenvector -> rejected
    assert coactivation_split(a1, Y) is None


def test_em_blend_split_end_to_end():
    """A fused-bars init un-blends via revival + co-activation splitting."""
    R = 5
    D, H, Hp, gamma, N = R * R, 2 * R, 6, 3, 1500
    model = BSC(D, H, Hp, gamma)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, N, seed=3)
    gtW = np.asarray(gt["W"])

    # adversarial init: bars 0-7 correct, col 8 = blend of bars 8+9,
    # col 9 duplicates col 0 (the duplicate frees a column; the freed
    # column is then seeded from the split blend)
    W0 = gtW.copy()
    W0[:, 8] = gtW[:, 8] + gtW[:, 9]
    W0[:, 9] = gtW[:, 0]
    params0 = {"W": W0 + 0.01, "pi": np.float32(0.2),
               "sigma": np.float32(1.0)}

    anneal = LinearAnnealing(12)
    anneal["T"] = 1.0
    em = EM(model, anneal, {"y": data["y"]}, params=params0, seed=2,
            revive_duplicates=(3, 0.9, 1.0), split_norm_frac=1.25,
            split_coact=True)
    params = em.run()
    n_rec = count_recovered_bars(np.asarray(params["W"]), gtW,
                                 threshold=0.85)
    assert n_rec == H, f"recovered only {n_rec}/{H} bars after blend split"


def test_split_coact_alone_defaults_pool_threshold():
    """split_coact=True without split_norm_frac must not be a silent no-op
   : the calibrated support-factor default kicks in."""
    model = BSC(16, 8, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 200, seed=1)
    em = EM(model, LinearAnnealing(2), {"y": data["y"]}, seed=0,
            revive_duplicates=(1, 0.9), split_coact=True)
    assert em.split_norm_frac == 1.5
    # explicit value is respected
    em2 = EM(model, LinearAnnealing(2), {"y": data["y"]}, seed=0,
             revive_duplicates=(1, 0.9), split_coact=True,
             split_norm_frac=2.0)
    assert em2.split_norm_frac == 2.0
