"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The phase functions take their sizes as arguments, so each one runs here
exactly as it runs on the card, only smaller; the device check lives in
``main()`` and must refuse the CPU.  ``test_oracle_phase_on_gpu`` needs the
card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs it there.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


@pytest.fixture()
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_phase()


def test_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_train_phase_tiny(capsys):
    out = chip_smoke.train_phase("cpu", N=2048, D=25, H=10, Hp=6, gamma=3,
                                 iters=3, chunk=512)
    assert out["Q_last"] > out["Q_first"]
    printed = capsys.readouterr().out
    assert "temp_bytes=" in printed and "ms_per_iter=" in printed


def test_cli_phase_recovers_bars(tmp_path):
    assert chip_smoke.cli_phase(str(tmp_path)) == 10


def test_oracle_phase_tiny():
    errs = chip_smoke.oracle_phase(N=64, D=25, H=10, Hp=6, gamma=3)
    assert errs["F"] < 1e-4 and errs["W"] < 1e-4


def test_oracle_phase_fails_beyond_tolerance():
    """A phase whose error exceeds its tolerance raises (no caught
    failures)."""
    with pytest.raises(AssertionError, match="oracle"):
        chip_smoke.oracle_phase(N=64, D=25, H=10, Hp=6, gamma=3,
                                tol={"F": 0.0})


def test_families_phase_tiny():
    times = chip_smoke.families_phase("cpu", full=False, reps=1)
    assert set(times) == {"tsc", "dsc", "gsc", "mca", "mmca", "tsc_bigs",
                          "mog", "mop", "decode_dense", "decode_compact"}
    assert all(t > 0 for t in times.values())


def test_streaming_phase_tiny():
    out = chip_smoke.streaming_phase("cpu", N=1024, seg_size=256, D=25,
                                     H=10, Hp=6, gamma=3, chunk=128,
                                     iters=2)
    assert out["streamed_ms"] > 0


def test_mesh_phase_on_four_devices():
    errs = chip_smoke.mesh_phase("cpu", n_devices=4, full=False)
    assert set(errs) == {"bsc_data", "tsc_bigs_state_1x4",
                         "tsc_bigs_state_2x2"}
    assert max(errs.values()) <= chip_smoke.MESH_TOL


@pytest.mark.gpu
def test_oracle_phase_on_gpu(gpu):
    errs = chip_smoke.oracle_phase()
    assert np.isfinite(list(errs.values())).all()
