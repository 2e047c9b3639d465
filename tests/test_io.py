"""AutoTable / DataLog / checkpoint round-trips (SURVEY.md §4 unit tests)."""

import numpy as np
import pytest

from prosper_tpu.io.autotable import AutoTable
from prosper_tpu.io.datalog import DataLog, StoreToH5, StoreToJSONL, TextPrinter


def test_autotable_roundtrip(tmp_path):
    p = str(tmp_path / "t.h5")
    with AutoTable(p) as t:
        for i in range(5):
            t.append("W", np.full((3, 2), i, np.float32))
            t.append("Q", np.float64(i * 1.5))
        assert t["W"].shape == (5, 3, 2)
        np.testing.assert_allclose(t["Q"], [0.0, 1.5, 3.0, 4.5, 6.0])
    with AutoTable(p, "r") as t:
        assert set(t.keys()) == {"W", "Q"}
        assert t["W"][4, 0, 0] == 4


def test_autotable_shape_mismatch(tmp_path):
    with AutoTable(str(tmp_path / "t.h5")) as t:
        t.append("x", np.zeros(3))
        with pytest.raises(ValueError):
            t.append("x", np.zeros(4))


def test_datalog_dispatch(tmp_path, capsys):
    log = DataLog()
    h5 = log.set_handler(("Q", "pi"), StoreToH5, str(tmp_path / "r.h5"))
    log.set_handler("Q", TextPrinter)
    log.append_all({"Q": 1.0, "pi": 0.1, "ignored": 9.9})
    log.append_all({"Q": 2.0, "pi": 0.2})
    assert "Q = 1.0" in capsys.readouterr().out
    assert log.ignored("nope") and not log.ignored("Q")
    np.testing.assert_allclose(h5.table["Q"], [1.0, 2.0])
    np.testing.assert_allclose(h5.table["pi"], [0.1, 0.2])
    assert "ignored" not in h5.table.keys()
    log.close()


def test_datalog_jsonl(tmp_path):
    import json
    path = str(tmp_path / "m.jsonl")
    log = DataLog()
    log.set_handler(None, StoreToJSONL, path)
    log.append_all({"Q": 1.0, "W": np.zeros((2, 2))})  # arrays skipped
    log.append_all({"Q": 2.0})
    log.close()
    rows = [json.loads(l) for l in open(path)]
    assert rows == [{"Q": 1.0}, {"Q": 2.0}]


def test_checkpoint_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp
    from prosper_tpu.io import checkpoint

    params = {"W": jnp.ones((4, 3)), "pi": jnp.float32(0.2),
              "sigma": jnp.float32(1.0)}
    p = str(tmp_path / "ckpt.h5")
    checkpoint.save(p, params, step=7, rng=jax.random.PRNGKey(0))
    params2, step, rng = checkpoint.restore(p)
    assert step == 7
    np.testing.assert_allclose(np.asarray(params2["W"]), np.ones((4, 3)))
    assert rng is not None


def test_resume_from_h5(tmp_path):
    from prosper_tpu.io import checkpoint

    p = str(tmp_path / "result.h5")
    with AutoTable(p) as t:
        for i in range(4):
            t.append("W", np.full((3, 2), i, np.float32))
            t.append("pi", np.float32(0.1 * (i + 1)))
            t.append("sigma", np.float32(1.0))
    params, step = checkpoint.resume_from_h5(p)
    assert step == 3
    assert float(params["pi"]) == pytest.approx(0.4)
