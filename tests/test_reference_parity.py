"""CPU-reference trajectory comparison harness (the reference-parity goal).

The jitted build must match the reference's free-energy trajectories "within
Monte-Carlo/seed error".  NumPy RandomState and JAX PRNG cannot match
bitwise (SURVEY.md §7 hard parts), so the comparison is distributional:
run the float64 NumPy reference-equivalent (prosper_tpu.reference) over
several seeds, run the jitted build over several seeds, and require the final
free energies to come from overlapping distributions and the trajectories
to track within the seed spread.
"""

import numpy as np
import pytest

from prosper_tpu.data.bars import bars_gt_params, count_recovered_bars
from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM
from prosper_tpu.models.linear import BSC
from prosper_tpu.reference import NumpyBSC, numpy_em_run


def _anneal(steps):
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 2.0), (0.7, 1.0)]
    a["W_noise"] = [(0.0, 1.0), (0.7, 0.0)]
    return a


@pytest.fixture(scope="module")
def problem():
    R = 4
    model = BSC(R * R, 2 * R, 5, 3)
    gt = bars_gt_params(model, intensity=10.0, sigma=1.0)
    data = model.generate_data(gt, 400, seed=55)
    return model, gt, data


def test_single_estep_mstep_parity(problem):
    """One EM step from identical params: NumPy f64 vs jitted f32 paths must
    agree to float32 tolerance (not just distributionally)."""
    import jax
    from prosper_tpu.models.base import make_blank_data, sched_from_anneal

    model, gt, data = problem
    params = model.standard_init(data, seed=1)
    ref = NumpyBSC(model.D, model.H, model.Hprime, model.gamma)
    p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    _, sums = ref.e_step(p64, np.asarray(data["y"], np.float64))
    p_ref = ref.m_step(p64, sums)

    sched = sched_from_anneal(LinearAnnealing(10))
    p_jax, _, _ = model.jit_step()(params, make_blank_data(data["y"]), sched,
                                   jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(p_jax["W"]), p_ref["W"],
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(p_jax["pi"]), p_ref["pi"], rtol=1e-3)
    np.testing.assert_allclose(float(p_jax["sigma"]), p_ref["sigma"],
                               rtol=1e-3)


def test_trajectory_within_seed_spread(problem):
    """Full runs: jitted trajectories fall inside the reference's seed spread."""
    model, gt, data = problem
    y = data["y"]
    steps = 25
    seeds = [0, 1, 2]

    ref_final, ref_trajs = [], []
    for s in seeds:
        ref = NumpyBSC(model.D, model.H, model.Hprime, model.gamma)
        out = numpy_em_run(ref, np.asarray(y, np.float64), _anneal(steps),
                           model.standard_init(data, seed=s), seed=s)
        ref_trajs.append(out["F_true_trajectory"])
        ref_final.append(out["F_true_trajectory"][-1])

    jax_final = []
    for s in seeds:
        em = EM(model, _anneal(steps), {"y": y},
                params=model.standard_init(data, seed=s), seed=s)
        em.run()
        jax_final.append(em.history[-1]["Q_mean"])

    ref_mean = np.mean(ref_final)
    spread = max(np.std(ref_final), 0.5)
    for f in jax_final:
        assert abs(f - ref_mean) < 5 * spread, (
            f"jitted final F {f:.3f} outside reference {ref_mean:.3f}±{spread:.3f}")
    # and both recover the dictionary
    assert count_recovered_bars(np.asarray(em.params["W"]),
                                np.asarray(gt["W"]), 0.8) == model.H
