"""Entry-point rules that need a fresh interpreter: the compile-cache
directory, and running without the optional h5py."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra=None, env_drop=(), cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    for k in env_drop:
        env.pop(k, None)
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path):
    """Set: programs land in JAX_COMPILATION_CACHE_DIR and the code sets no
    other directory.  Unset: the cache is <checkout>/.jax_cache."""
    code = (
        "import json, jax, jax.numpy as jnp\n"
        "from prosper_tpu.utils import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "print(json.dumps({'returned': d, 'config': "
        "jax.config.jax_compilation_cache_dir}))\n")
    if env_set:
        cache = str(tmp_path / "cache")
        code += (
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.ones(7)).block_until_"
            "ready()\n")
        out = _python(code, {"JAX_COMPILATION_CACHE_DIR": cache})
        got = json.loads(out.stdout.splitlines()[0])
        assert got["returned"] == cache and got["config"] == cache
        assert os.listdir(cache), "no compiled program in the cache dir"
    else:
        out = _python(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
        got = json.loads(out.stdout.splitlines()[0])
        assert got["returned"] == os.path.join(ROOT, ".jax_cache")
        assert got["config"] == got["returned"]


#: makes ``import h5py`` fail in the child, as on a machine without it
NO_H5PY = ("import sys\n"
           "class _Block:\n"
           "    def find_spec(self, name, path=None, target=None):\n"
           "        if name == 'h5py' or name.startswith('h5py.'):\n"
           "            raise ImportError('h5py blocked')\n"
           "sys.meta_path.insert(0, _Block())\n"
           "sys.modules.pop('h5py', None)\n")


def test_import_and_train_without_h5py(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from prosper_tpu.engine.anneal import LinearAnnealing\n"
        "from prosper_tpu.models import BSC\n"
        "from prosper_tpu.data.bars import bars_gt_params\n"
        "model = BSC(D=16, H=8, Hprime=5, gamma=3)\n"
        "gt_params = bars_gt_params(model, intensity=10.0, sigma=1.0)\n"
        "N = 200\nseed = 3\n"
        "anneal = LinearAnnealing(6)\n")
    out_dir = tmp_path / "run"
    code = NO_H5PY + (
        "import prosper_tpu\n"
        "from prosper_tpu import cli\n"
        "from prosper_tpu.io import h5py_available\n"
        "assert not h5py_available()\n"
        f"assert cli.main(['train', {str(cfg)!r}, '-o', {str(out_dir)!r},"
        " '-q']) == 0\n"
        "try:\n"
        "    from prosper_tpu.io import checkpoint\n"
        f"    checkpoint.restore({str(out_dir / 'checkpoint.h5')!r})\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e)\n"
        "else:\n"
        "    raise SystemExit('checkpoint read without h5py')\n")
    out = _python(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")})
    assert "h5py is not installed" in out.stderr
    files = set(os.listdir(out_dir))
    assert {"metrics.jsonl", "params.npz"} <= files
    assert not files & {"result.h5", "checkpoint.h5"}
    rows = (out_dir / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 6


def test_bench_refuses_a_cpu_platform():
    """bench.py measures only on a GPU: no CPU fallback."""
    import jax
    if jax.devices()[0].platform == "gpu":
        pytest.skip("runs where JAX's default backend is not a GPU")
    sys.path.insert(0, ROOT)
    import bench
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


def test_bench_mfu_only_for_known_devices():
    sys.path.insert(0, ROOT)
    import bench
    known = bench._family_entry(1e6, (1e6, 5e5), chained=2e8,
                                kind="NVIDIA H100 80GB HBM3")
    assert known["mfu_useful_pct"] == pytest.approx(
        100 * 2e8 * 5e5 / 1e12 / 495.0, abs=0.01)
    unknown = bench._family_entry(1e6, (1e6, 5e5), chained=2e6,
                                  kind="some other card")
    assert "mfu_useful_pct" not in unknown and "tflops_raw" in unknown
