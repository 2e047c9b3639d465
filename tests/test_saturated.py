"""Saturated-step specialization.

When the HOST-side schedule says beta == prior_beta == 1 (the post-anneal
steady state — the dominant phase of production runs), the un-annealed
free-energy channel F_true is exactly F, and every E-step core skips its
second full-width softmax.  The
engine selects the specialized step per-iteration from host floats
(EM._sat_now / run_scanned's uniform-segment split), so trajectories are
unchanged: params and F must be BIT-identical, Q equal.

Reference behavior guarded: SURVEY.md §2 "EM engine" (free-energy
monitoring every iteration) — the specialization only removes a duplicate
computation, never the channel itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.base import make_blank_data, sched_from_anneal
from prosper_tpu.models.gsc import GSC
from prosper_tpu.models.linear import BSC, TSC
from prosper_tpu.models.mca import MCA, MMCA
from prosper_tpu.models.mixtures import MoG


def _models():
    return [
        ("bsc", BSC(25, 10, 6, 3, chunk=64)),
        ("tsc_bigs", TSC(25, 10, 6, 3, chunk=64, s_block=64)),
        ("mca", MCA(16, 8, 5, 3, chunk=64)),
        ("mmca", MMCA(16, 8, 5, 3, chunk=64)),
        ("gsc", GSC(16, 8, 5, 3, chunk=64)),
    ]


@pytest.mark.parametrize("name,model", _models(), ids=[n for n, _ in _models()])
def test_saturated_step_bit_identical(name, model):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((128, model.D)).astype(np.float32)
    params = model.standard_init({"y": y}, seed=1)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(10))  # defaults: beta = pb = 1
    key = jax.random.PRNGKey(0)

    p0, F0, s0 = model.jit_step(saturated=False)(params, data, sched, key)
    p1, F1, s1 = model.jit_step(saturated=True)(params, data, sched, key)

    for k in p0:
        np.testing.assert_array_equal(np.asarray(p0[k]), np.asarray(p1[k]),
                                      err_msg=f"{name}: param {k}")
    np.testing.assert_array_equal(np.asarray(F0), np.asarray(F1))
    assert float(s1["Q"]) == pytest.approx(float(s0["Q"]), rel=1e-6)
    # the saturated variant reports Q == F_total (the point of the flag)
    assert float(s1["Q"]) == float(s1["F_total"])


def test_mog_saturated_step():
    m = MoG(8, 4)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((256, 8)).astype(np.float32)
    params = m.standard_init({"y": y}, seed=0)
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(5))
    key = jax.random.PRNGKey(1)
    p0, F0, s0 = m.jit_step(saturated=False)(params, data, sched, key)
    p1, F1, s1 = m.jit_step(saturated=True)(params, data, sched, key)
    for k in p0:
        np.testing.assert_array_equal(np.asarray(p0[k]), np.asarray(p1[k]))
    assert float(s1["Q"]) == pytest.approx(float(s0["Q"]), rel=1e-6)


def _anneal_with_ramp(iters):
    a = LinearAnnealing(iters)
    # T ramp -> beta = 1/T < 1 for the first half, == 1 after
    a["T"] = [(0.0, 2.0), (0.5, 1.0)]
    return a


def _mk_em(scanned, force_unsaturated=False):
    rng = np.random.default_rng(3)
    model = BSC(16, 8, 5, 3, chunk=64)
    y = rng.standard_normal((128, 16)).astype(np.float32)
    em = EM(model, _anneal_with_ramp(8), {"y": y},
            params=model.standard_init({"y": y}, seed=4), seed=5)
    if force_unsaturated:
        em._sat_now = lambda: False                      # python-loop path
        orig = em._get_step
        em._get_step = lambda sat: orig(False)           # scan path
    return em


@pytest.mark.parametrize("scanned", [False, True])
def test_engine_picks_saturated_and_trajectory_unchanged(scanned):
    """Mid-run saturation: the engine switches step variants at the ramp
    end; the trajectory must match a run forced onto the unspecialized
    step for every iteration."""
    em_a = _mk_em(scanned)
    em_b = _mk_em(scanned, force_unsaturated=True)
    if scanned:
        em_a.run_scanned()
        em_b.run_scanned()
    else:
        em_a.run()
        em_b.run()
    np.testing.assert_array_equal(np.asarray(em_a.params["W"]),
                                  np.asarray(em_b.params["W"]))
    qa = [h["Q_mean"] for h in em_a.history]
    qb = [h["Q_mean"] for h in em_b.history]
    np.testing.assert_allclose(qa, qb, rtol=1e-5)
    # both variants actually compiled in the mixed run
    assert set(em_a._steps) == {False, True}
