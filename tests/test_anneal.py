"""LinearAnnealing unit tests (SURVEY.md §4: schedule interpolation)."""

import pytest

from prosper_tpu.engine.anneal import LinearAnnealing


def test_constant_and_defaults():
    a = LinearAnnealing(10)
    assert a["T"] == 1.0
    assert a["Ncut_factor"] == 0.0
    assert a["partial"] == 1.0
    assert a["anneal_prior"] is False


def test_piecewise_linear_fractional():
    a = LinearAnnealing(101)
    a["T"] = [(0.0, 4.0), (0.5, 1.0)]
    assert a.value_at("T", 0) == 4.0
    assert a.value_at("T", 50) == pytest.approx(1.0)
    assert a.value_at("T", 25) == pytest.approx(2.5)
    assert a.value_at("T", 100) == 1.0


def test_absolute_positions():
    a = LinearAnnealing(100)
    a["W_noise"] = [(10, 2.0), (20, 0.0)]
    assert a.value_at("W_noise", 0) == 2.0
    assert a.value_at("W_noise", 15) == pytest.approx(1.0)
    assert a.value_at("W_noise", 99) == 0.0


def test_mixed_fractional_and_absolute_positions():
    """Mixing fraction and absolute breakpoints must
    interpolate over ITERATION-space order, not raw-spec order."""
    a = LinearAnnealing(100)
    # raw-spec order [(0.9, 5.0), (5, 1.0)] but iteration order is
    # [(5, 1.0), (89.1, 5.0)]
    a["T"] = [(0.9, 5.0), (5, 1.0)]
    assert a.value_at("T", 0) == 1.0          # clamped to earliest breakpoint
    assert a.value_at("T", 5) == 1.0
    assert a.value_at("T", 99) == 5.0
    mid = a.value_at("T", 47)                 # ~halfway 5 -> 89.1
    assert 2.5 < mid < 3.5
    # monotone non-decreasing across the whole schedule
    vals = [a.value_at("T", i) for i in range(100)]
    assert all(b >= a_ for a_, b in zip(vals, vals[1:]))


def test_iteration_and_finished():
    a = LinearAnnealing(3)
    seen = 0
    while not a.finished:
        a.next()
        seen += 1
    assert seen == 3
    with pytest.raises(StopIteration):
        a.next()


def test_reset_and_scalars():
    a = LinearAnnealing(10)
    a["T"] = [(0.0, 2.0), (1.0, 1.0)]
    a.next(); a.next()
    a.reset(0)
    s = a.as_scalars()
    assert s["beta"] == pytest.approx(0.5)
    assert s["step"] == 0.0
