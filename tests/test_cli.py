"""CLI end-to-end: train/generate/infer on tiny configs (SURVEY.md §2 L7)."""

import json
import os

import numpy as np
import pytest

from prosper_tpu import cli


@pytest.fixture()
def tiny_config(tmp_path):
    p = tmp_path / "cfg.py"
    p.write_text(
        "from prosper_tpu.engine.anneal import LinearAnnealing\n"
        "from prosper_tpu.models import BSC\n"
        "from prosper_tpu.data.bars import bars_gt_params\n"
        "model = BSC(D=16, H=8, Hprime=5, gamma=3)\n"
        "gt_params = bars_gt_params(model, intensity=10.0, sigma=1.0)\n"
        "N = 300\nseed = 3\n"
        "anneal = LinearAnnealing(15)\n"
        "anneal['T'] = [(0.0, 2.0), (0.7, 1.0)]\n"
        "anneal['W_noise'] = [(0.0, 1.0), (0.7, 0.0)]\n")
    return str(p)


def test_cli_train_py_config(tiny_config, tmp_path):
    out = str(tmp_path / "run")
    rc = cli.main(["train", tiny_config, "-o", out, "-q"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "result.h5"))
    assert os.path.exists(os.path.join(out, "checkpoint.h5"))
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 15
    assert rows[-1]["Q_mean"] > rows[0]["Q_mean"]


def test_cli_generate_then_infer(tiny_config, tmp_path):
    out = str(tmp_path / "run")
    gen = str(tmp_path / "gen.h5")
    rc = cli.main(["generate", tiny_config, "-N", "200", "-o", gen])
    assert rc == 0
    rc = cli.main(["train", tiny_config, "-o", out, "-q"])
    assert rc == 0
    inf = str(tmp_path / "inf.h5")
    rc = cli.main(["infer", tiny_config,
                   "-c", os.path.join(out, "checkpoint.h5"),
                   "--data", gen, "-o", inf, "--top", "4"])
    assert rc == 0
    import h5py
    with h5py.File(inf) as f:
        assert f["top_states"].shape == (200, 4, 8)
        assert f["recon"].shape == (200, 16)


def test_cli_train_toml(tmp_path):
    cfg = tmp_path / "c.toml"
    cfg.write_text(
        '[model]\ntype = "mog"\nD = 4\nK = 2\n\n'
        "[anneal]\nsteps = 10\n")
    # mog needs data: make a tiny h5
    from prosper_tpu.data.patches import write_h5_dataset
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.standard_normal((100, 4)) + 3,
                        rng.standard_normal((100, 4)) - 3])
    d = str(tmp_path / "d.h5")
    write_h5_dataset(d, y.astype(np.float32))
    out = str(tmp_path / "run")
    rc = cli.main(["train", str(cfg), "--data", d, "-o", out, "-q"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "result.h5"))


def test_cli_train_toml_revive(tmp_path):
    """revive_duplicates is configurable from declarative configs."""
    cfg = tmp_path / "c.toml"
    cfg.write_text(
        "revive_duplicates = [2, 0.95]\n\n"
        '[model]\ntype = "bsc"\nD = 9\nH = 4\nHprime = 3\ngamma = 2\n\n'
        "[anneal]\nsteps = 6\n")
    from prosper_tpu.data.patches import write_h5_dataset
    d = str(tmp_path / "d.h5")
    write_h5_dataset(d, np.random.default_rng(0)
                     .standard_normal((64, 9)).astype(np.float32))
    out = str(tmp_path / "run")
    rc = cli.main(["train", str(cfg), "--data", d, "-o", out, "-q"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "result.h5"))


def test_cli_train_mesh(tiny_config, tmp_path):
    out = str(tmp_path / "runm")
    rc = cli.main(["train", tiny_config, "-o", out, "-q", "--mesh", "data=4"])
    assert rc == 0


def test_cli_bad_config(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("x: 1")
    with pytest.raises(ValueError):
        cli.load_config(str(p))


def test_cli_resume_and_scan(tiny_config, tmp_path):
    out = str(tmp_path / "runr")
    rc = cli.main(["train", tiny_config, "-o", out, "-q", "--scan"])
    assert rc == 0
    # resume: restarts from the checkpoint (schedule already exhausted ->
    # finishes immediately but must not crash and must keep the checkpoint)
    rc = cli.main(["train", tiny_config, "-o", out, "-q", "--resume"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "checkpoint.h5"))


def test_periodic_checkpoint_enables_mid_run_resume(tiny_config, tmp_path):
    """A killed run leaves a usable checkpoint (review finding: the
    failure-recovery path was dead without periodic checkpointing)."""
    from prosper_tpu.engine.em import EM
    from prosper_tpu.io import checkpoint as ckpt
    cfg = cli.load_config(tiny_config)
    model, anneal = cfg["model"], cfg["anneal"]
    data = model.generate_data(cfg["gt_params"], cfg["N"], seed=1)
    path = str(tmp_path / "c.h5")
    em = EM(model, anneal, {"y": data["y"]}, seed=2,
            checkpoint_path=path, checkpoint_every=4)
    for _ in range(6):     # simulate dying mid-run after 6 of 15 iterations
        em.step_once()
    params, step, rng = ckpt.restore(path)
    assert step == 4        # last periodic checkpoint
    assert params["W"].shape == (16, 8)


def test_all_example_configs_load():
    """Every shipped example config must parse and build model+anneal
    (guards against example bitrot)."""
    import glob
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")
    configs = glob.glob(os.path.join(root, "**", "param_*.py"),
                        recursive=True) + glob.glob(
        os.path.join(root, "*.toml"))
    assert len(configs) >= 7
    for path in configs:
        cfg = cli.load_config(path)
        assert "model" in cfg and "anneal" in cfg, path
        assert hasattr(cfg["model"], "step_fn"), path
        assert not cfg["anneal"].finished, path


def test_cli_diagnose(tiny_config, tmp_path, capsys):
    out = str(tmp_path / "run")
    assert cli.main(["train", tiny_config, "-o", out, "-q"]) == 0
    ckpt = os.path.join(out, "checkpoint.h5")
    # health-only report (no ground truth)
    assert cli.main(["diagnose", "-c", ckpt]) == 0
    txt = capsys.readouterr().out
    assert "median support" in txt and "blend suspects" in txt
    # recovery report against the config's gt_params
    assert cli.main(["diagnose", "-c", ckpt, "--gt", tiny_config]) == 0
    txt = capsys.readouterr().out
    assert "/8 atoms" in txt
    # npz round-trip (the patches_scale_run save_params format)
    npz = str(tmp_path / "w.npz")
    from prosper_tpu.io import checkpoint as ck
    params, _, _ = ck.restore(ckpt)
    np.savez(npz, W=np.asarray(params["W"]))
    gtz = str(tmp_path / "gt.npz")
    from prosper_tpu.cli import load_config
    np.savez(gtz, gtW=np.asarray(load_config(tiny_config)["gt_params"]["W"]))
    assert cli.main(["diagnose", "-c", npz, "--gt", gtz]) == 0
    assert "/8 atoms" in capsys.readouterr().out


def test_cli_diagnose_json(tiny_config, tmp_path, capsys):
    out = str(tmp_path / "run")
    assert cli.main(["train", tiny_config, "-o", out, "-q"]) == 0
    ckpt = os.path.join(out, "checkpoint.h5")
    capsys.readouterr()                      # drain train output
    assert cli.main(["diagnose", "-c", ckpt, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert {"columns", "median_support", "dead"} <= rep.keys()
    assert cli.main(["diagnose", "-c", ckpt, "--gt", tiny_config,
                     "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["total"] == 8 and 0 <= rep["recovered"] <= 8


def test_cli_train_stream(tiny_config, tmp_path):
    """--stream SEG routes training through engine/stream.py:
    logs/checkpoint written, Q improves, and --mesh/--resume are rejected."""
    out = str(tmp_path / "runs")
    rc = cli.main(["train", tiny_config, "-o", out, "-q", "--stream", "100"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "checkpoint.h5"))
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 15
    assert rows[-1]["Q_mean"] > rows[0]["Q_mean"]
    with pytest.raises(SystemExit):
        cli.main(["train", tiny_config, "-o", out, "-q", "--stream", "100",
                  "--mesh", "data=4"])
    # --resume restores the streamed checkpoint (round 4: streaming has
    # checkpoint/resume parity with EM); the finished run resumes at the
    # final step and exits cleanly without duplicating log rows
    rc = cli.main(["train", tiny_config, "-o", out, "-q", "--stream", "100",
                   "--resume"])
    assert rc == 0
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 15
