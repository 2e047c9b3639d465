"""Command-line interface: train / infer / generate.

Reference behavior: SURVEY.md §2 "Example scripts" + §5.6 — the reference is
driven as ``mpirun -n P python learn_script.py param_file.py`` where the
param file is an exec'd Python module defining the model, annealing
schedule, data source and output path.  This CLI keeps that "config is a
program" escape hatch (.py configs) and adds declarative TOML/JSON configs:

  python -m prosper_tpu.cli train  examples/barstest/param_bars_bsc.py
  python -m prosper_tpu.cli train  cfg.toml --output out/run1
  python -m prosper_tpu.cli infer  --checkpoint out/run1/result.h5 --data d.h5
  python -m prosper_tpu.cli generate examples/barstest/param_bars_bsc.py -N 1000

Multi-device: ``--mesh data=N`` shards the datapoint axis over the first N
local devices (the mpirun -n analogue; multi-host uses
jax.distributed.initialize via --multihost).

``result.h5`` and ``checkpoint.h5`` need the optional h5py.  Without it,
``train`` still writes ``metrics.jsonl`` and saves the final parameters to
``params.npz`` (which ``diagnose`` reads).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
from typing import Any, Dict

import numpy as np

MODEL_REGISTRY = {}


def _registry():
    global MODEL_REGISTRY
    if not MODEL_REGISTRY:
        from prosper_tpu.models import BSC, TSC, DSC, MCA, MMCA, GSC
        from prosper_tpu.models.mixtures import MoG, MoP
        MODEL_REGISTRY = {c.__name__.lower(): c for c in
                          (BSC, TSC, DSC, MCA, MMCA, GSC, MoG, MoP)}
    return MODEL_REGISTRY


def load_config(path: str) -> Dict[str, Any]:
    """Load a .py (exec'd, reference-style), .toml or .json config."""
    if path.endswith(".py"):
        ns = runpy.run_path(path)
        return {k: v for k, v in ns.items() if not k.startswith("_")}
    if path.endswith(".toml"):
        import tomllib
        with open(path, "rb") as f:
            return _build_from_decl(tomllib.load(f))
    if path.endswith(".json"):
        with open(path) as f:
            return _build_from_decl(json.load(f))
    raise ValueError(f"unknown config format: {path}")


def _build_from_decl(cfg: Dict) -> Dict[str, Any]:
    """Declarative config -> instantiated model/anneal/data sources."""
    from prosper_tpu.engine.anneal import LinearAnnealing

    out: Dict[str, Any] = {}
    m = dict(cfg["model"])
    cls = _registry()[m.pop("type").lower()]
    out["model"] = cls(**m)

    a = dict(cfg.get("anneal", {}))
    steps = int(a.pop("steps", 100))
    anneal = LinearAnnealing(steps)
    for name, spec in a.items():
        anneal[name] = [tuple(p) for p in spec] if isinstance(spec, list) \
            else spec
    out["anneal"] = anneal

    for k in ("data_h5", "data_dataset", "output", "seed", "N",
              "log_params_every", "gt_params", "checkpoint_every",
              "revive_duplicates", "split_norm_frac", "split_coact",
              "reseed_worst_frac"):
        if k in cfg:
            out[k] = cfg[k]
    return out


def _load_data(cfg: Dict, model, args) -> Dict[str, np.ndarray]:
    if getattr(args, "data", None):
        from prosper_tpu.data.patches import load_h5_shard
        y = load_h5_shard(args.data, cfg.get("data_dataset", "patches"))
        return {"y": y}
    if "data" in cfg:
        return cfg["data"]
    if "data_h5" in cfg:
        from prosper_tpu.data.patches import load_h5_shard
        return {"y": load_h5_shard(cfg["data_h5"],
                                   cfg.get("data_dataset", "patches"))}
    if "gt_params" in cfg:
        N = int(cfg.get("N", 1000))
        return model.generate_data(cfg["gt_params"], N,
                                   seed=int(cfg.get("seed", 0)))
    raise SystemExit("config provides no data (need data / data_h5 / "
                     "gt_params) and --data not given")


def _truncate_logs(out_dir: str, step: int, log_params_every: int) -> None:
    """Rewind result.h5 / metrics.jsonl to checkpoint ``step`` iterations.

    Row-count rule mirrors EM.step_once's logging: scalar/vector channels
    get one row per iteration; big (ndim>=2, e.g. W) channels are
    rate-limited to iterations where position % log_params_every == 0.
    """
    h5_path = os.path.join(out_dir, "result.h5")
    if os.path.exists(h5_path):
        from prosper_tpu.io import import_h5py
        k = max(1, int(log_params_every))
        n_big = (step + k - 1) // k       # positions 0, k, 2k, ... < step
        with import_h5py().File(h5_path, "a") as f:
            for name in list(f.keys()):
                ds = f[name]
                target = n_big if (ds.ndim - 1) >= 2 else step
                if ds.shape[0] > target:
                    ds.resize(target, axis=0)
    jl_path = os.path.join(out_dir, "metrics.jsonl")
    if os.path.exists(jl_path):
        with open(jl_path) as f:
            lines = f.readlines()
        if len(lines) > step:
            with open(jl_path, "w") as f:
                f.writelines(lines[:step])


def cmd_train(args) -> int:
    if getattr(args, "stream", 0) and (args.mesh
                                       or getattr(args, "multihost", False)):
        # validate BEFORE any file handles open: the dlog handlers truncate
        # result.h5/metrics.jsonl in "w" mode, so a late rejection would
        # wipe a previous run's logs
        raise SystemExit("--stream is single-device in v1; drop "
                         "--mesh/--multihost")
    if getattr(args, "multihost", False):
        # must run before anything touches a JAX backend
        from prosper_tpu.parallel.mesh import init_multihost
        init_multihost()

    from prosper_tpu.engine.em import EM
    from prosper_tpu.io import h5py_available
    from prosper_tpu.io.datalog import DataLog, StoreToH5, StoreToJSONL
    from prosper_tpu.parallel.mesh import MeshRuntime, pprint

    have_h5 = h5py_available()
    if args.resume and not have_h5:
        raise SystemExit("--resume reads checkpoint.h5, which needs h5py "
                         "(pip install 'prosper-tpu[h5]')")
    cfg = load_config(args.config)
    model = cfg["model"]
    anneal = cfg["anneal"]
    data = _load_data(cfg, model, args)

    out_dir = args.output or cfg.get("output")
    if out_dir is None:
        from prosper_tpu.utils import create_output_path
        out_dir = create_output_path(os.path.basename(args.config))
    os.makedirs(out_dir, exist_ok=True)

    # failure recovery (SURVEY.md §5.3/5.4): deterministic restart from the
    # last checkpoint written in the output dir
    params = None
    ckpt_rng = None
    log_params_every = int(cfg.get("log_params_every", 1))
    ckpt_path = os.path.join(out_dir, "checkpoint.h5") if have_h5 else None
    ckpt_extra = {}
    if args.resume and os.path.exists(ckpt_path):
        from prosper_tpu.io import checkpoint
        params, step, ckpt_rng, ckpt_extra = checkpoint.restore_full(ckpt_path)
        step = min(step, anneal.steps)
        anneal.reset(step)
        # drop log rows for iterations between the checkpoint and the crash:
        # append mode would otherwise duplicate them, breaking
        # resume_from_h5's row-index == iteration assumption.
        # Rank-0 only — the log files are rank-0-owned, and concurrent
        # truncation from every process would corrupt them
        import jax
        if jax.process_index() == 0:
            _truncate_logs(out_dir, step, log_params_every)
        print(f"[train] resuming from {ckpt_path} at step {step}")

    dlog = DataLog()
    mode = "a" if (args.resume and params is not None) else "w"
    if have_h5:
        dlog.set_handler(None, StoreToH5, os.path.join(out_dir, "result.h5"),
                         mode)
    else:
        print("[train] h5py is not installed: result.h5 and checkpoint.h5 "
              "are not written; final params go to params.npz",
              file=sys.stderr)
    dlog.set_handler(None, StoreToJSONL,
                     os.path.join(out_dir, "metrics.jsonl"), mode)

    runtime = None
    if args.mesh:
        import jax
        n = int(args.mesh.split("=")[1])
        runtime = MeshRuntime(devices=jax.devices()[:n])
    elif args.multihost:
        runtime = MeshRuntime()

    if getattr(args, "stream", 0):
        # host->device streaming driver for datasets beyond device memory
        # (engine/stream.py).  v1 limit, enforced loudly: single process /
        # single device.
        if runtime is not None:
            raise SystemExit("--stream is single-device in v1; drop "
                             "--mesh/--multihost")
        from prosper_tpu.engine.stream import StreamingEM
        sem = StreamingEM(model, anneal, np.asarray(data["y"]),
                          seg_size=int(args.stream), params=params,
                          seed=int(cfg.get("seed", 42)), dlog=dlog,
                          log_params_every=log_params_every,
                          checkpoint_path=ckpt_path,
                          checkpoint_every=int(cfg.get("checkpoint_every",
                                                       25)))
        if args.resume and os.path.exists(ckpt_path):
            # the generic resume block above already restored params and
            # the anneal offset (and truncated the logs); sem.resume
            # additionally restores the PRNG chain and the lagged F_prev
            # that drives the Ncut ranking
            sem.resume(ckpt_path)
        params = sem.run(verbose=not args.quiet)
        _save_final(out_dir, ckpt_path, params, anneal.position)
        dlog.close()
        pprint(f"[train] done (streamed, {sem.n_seg} segments) -> {out_dir}")
        return 0

    # static-shape padding on EVERY path (valid=0 rows): the E-step requires
    # the per-shard size to divide the chunk, and the mesh requires N to
    # divide the shard count
    from prosper_tpu.data.patches import pad_for_mesh
    y = np.asarray(data["y"])
    shards = runtime.n_data_shards if runtime is not None else 1
    per_shard = -(-y.shape[0] // shards)
    needs_chunk = getattr(model, "requires_chunk_multiple", False)
    c = model.chunk if (needs_chunk and per_shard > model.chunk) else 1
    padded = pad_for_mesh(y, shards, c)
    if "valid" in data:
        v = np.asarray(data["valid"])
        padded["valid"][:v.shape[0]] = v
    # compare against the PADDED length — the checkpoint stores F_prev at
    # the padded training shape, which exceeds the raw dataset length
    # whenever static-shape padding occurred
    if "F_prev" in ckpt_extra:
        if ckpt_extra["F_prev"].shape[0] <= padded["y"].shape[0]:
            fp = np.zeros((padded["y"].shape[0],), np.float32)
            fp[:ckpt_extra["F_prev"].shape[0]] = ckpt_extra["F_prev"]
            padded["F_prev"] = fp
        else:
            # e.g. resume with a different --mesh shard count: the padded
            # shape changed, so the trajectory-exact contract cannot hold
            print("[train] warning: checkpointed F_prev shape "
                  f"{ckpt_extra['F_prev'].shape[0]} exceeds the padded "
                  f"dataset {padded['y'].shape[0]} (mesh/chunk changed?); "
                  "Ncut ranking restarts from scratch this iteration")
    data = padded

    em = EM(model, anneal, data, params=params,
            seed=int(cfg.get("seed", 42)), runtime=runtime, dlog=dlog,
            log_params_every=log_params_every,
            checkpoint_path=ckpt_path,
            checkpoint_every=int(cfg.get("checkpoint_every", 25)),
            revive_duplicates=(tuple(cfg["revive_duplicates"])
                               if cfg.get("revive_duplicates") else None),
            split_norm_frac=float(cfg.get("split_norm_frac", 0.0)),
            split_coact=bool(cfg.get("split_coact", False)),
            reseed_worst_frac=float(cfg.get("reseed_worst_frac", 0.0)))
    if ckpt_rng is not None:
        # deterministic restart: continue the PRNG chain recorded in the
        # checkpoint rather than replaying the config seed's early-schedule
        # noise values
        em.rng = ckpt_rng
    if "revive_rng" in ckpt_extra:
        # ... and the revival PCG64 chain, so revivals replay identically
        em.restore_revival_rng(ckpt_extra["revive_rng"])
    if "revive_last" in ckpt_extra:
        # ... and the revival cadence (last-fired iteration), so revival
        # TIMING also matches the uninterrupted run when the checkpoint
        # step is not aligned with the revival period
        em._last_revive = int(ckpt_extra["revive_last"])
    if args.scan:
        params = em.run_scanned()
    else:
        params = em.run(verbose=not args.quiet)

    _save_final(out_dir, ckpt_path, params, anneal.position)
    dlog.close()
    pprint(f"[train] done -> {out_dir}")
    return 0


def _save_final(out_dir: str, ckpt_path, params, step: int) -> None:
    """Final parameters: checkpoint.h5, or params.npz without h5py."""
    if ckpt_path is not None:
        from prosper_tpu.io import checkpoint
        checkpoint.save(ckpt_path, params, step=step)
        return
    import jax
    if jax.process_index() == 0:
        np.savez(os.path.join(out_dir, "params.npz"),
                 **{k: np.asarray(v) for k, v in jax.device_get(params).items()})


def cmd_infer(args) -> int:
    from prosper_tpu.io import checkpoint, import_h5py
    from prosper_tpu.data.patches import load_h5_shard

    cfg = load_config(args.config)
    model = cfg["model"]
    try:
        params, step, _ = checkpoint.restore(args.checkpoint)
    except KeyError:
        params, step = checkpoint.resume_from_h5(
            args.checkpoint, param_names=tuple(model.param_names))
    y = load_h5_shard(args.data, cfg.get("data_dataset", "patches"))
    out = model.inference(params, {"y": y}, top_L=args.top)
    dest = args.output or "inference.h5"
    with import_h5py().File(dest, "w") as f:
        for k, v in out.items():
            f.create_dataset(k, data=np.asarray(v))
    print(f"[infer] {y.shape[0]} datapoints -> {dest} (params from step {step})")
    return 0


def cmd_generate(args) -> int:
    from prosper_tpu.data.patches import write_h5_dataset

    cfg = load_config(args.config)
    model = cfg["model"]
    gt = cfg.get("gt_params")
    if gt is None:
        raise SystemExit("config must define gt_params for generate")
    data = model.generate_data(gt, args.N, seed=args.seed)
    dest = args.output or "generated.h5"
    write_h5_dataset(dest, data["y"])
    print(f"[generate] {args.N} datapoints -> {dest}")
    return 0


def cmd_diagnose(args) -> int:
    """Dictionary-health / recovery report on a trained checkpoint."""
    from prosper_tpu.data.diagnosis import (dictionary_stats,
                                            diagnose_recovery, format_report)
    from prosper_tpu.io import checkpoint

    try:
        params, step, _ = checkpoint.restore(args.checkpoint)
    except (KeyError, OSError):
        if args.checkpoint.endswith(".npz"):
            params, step = dict(np.load(args.checkpoint)), -1
        else:
            params, step = checkpoint.resume_from_h5(
                args.checkpoint, param_names=("W",))
    W = np.asarray(params["W"])

    gt_W = None
    if args.gt:
        if args.gt.endswith(".npz"):
            z = np.load(args.gt)
            gt_W = np.asarray(z["gtW"] if "gtW" in z else z["W"])
        else:
            gt = load_config(args.gt).get("gt_params")
            if gt is None:
                raise SystemExit(f"{args.gt} defines no gt_params")
            gt_W = np.asarray(gt["W"])

    if gt_W is None:
        st = dictionary_stats(W, support_frac=args.support_frac)
        dead = np.flatnonzero(st["norms"] < 0.1 * st["median_norm"])
        wide = np.flatnonzero(st["support"] >= 1.5 * st["median_support"])
        if args.json:
            print(json.dumps({
                "step": step, "columns": int(W.shape[1]),
                "median_norm": st["median_norm"],
                "median_support": st["median_support"],
                "max_coherence": st["max_coherence"],
                "dead": dead.tolist(), "wide_support": wide.tolist()}))
            return 0
        print(f"[diagnose] {W.shape[1]} columns (step {step}): "
              f"median norm {st['median_norm']:.3g}, median support "
              f"{st['median_support']:.0f}, max coherence "
              f"{st['max_coherence']:.2f}")
        print(f"  dead (norm<0.1x median): {dead.tolist()}")
        print(f"  wide-support (>=1.5x median, blend suspects): "
              f"{wide.tolist()}")
    else:
        rep = diagnose_recovery(W, gt_W, threshold=args.threshold,
                                signed=args.signed,
                                support_frac=args.support_frac)
        if args.json:
            print(json.dumps({
                "step": step,
                "recovered": int(rep["recovered"].size),
                "total": int(rep["cosines"].size),
                "missed_classes": {str(k): v for k, v
                                   in rep["missed_classes"].items()},
                "blends": {str(c): [int(v[0]), int(v[1]), v[2], v[3]]
                           for c, v in rep["blends"].items()},
                "duplicates": [[int(i), int(j), c]
                               for i, j, c in rep["duplicates"]],
                "dead": rep["dead"]}))
            return 0
        print(f"[diagnose] step {step}")
        print(format_report(rep))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prosper-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="run EM training")
    pt.add_argument("config")
    pt.add_argument("--output", "-o", default=None)
    pt.add_argument("--data", default=None, help="HDF5 dataset overriding config")
    pt.add_argument("--mesh", default=None, help="e.g. data=8")
    pt.add_argument("--quiet", "-q", action="store_true")
    pt.add_argument("--resume", action="store_true",
                    help="restart from <output>/checkpoint.h5 if present")
    pt.add_argument("--scan", action="store_true",
                    help="run all iterations inside one jit (lax.scan)")
    pt.add_argument("--stream", type=int, default=0, metavar="SEG",
                    help="stream the host-resident dataset through the "
                         "device in SEG-datapoint segments (for datasets "
                         "beyond device memory; engine/stream.py)")
    pt.add_argument("--multihost", action="store_true",
                    help="initialise jax.distributed (run one process per "
                         "host) and mesh over all global devices")
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("infer", help="posterior decode with trained params")
    pi.add_argument("config")
    pi.add_argument("--checkpoint", "-c", required=True)
    pi.add_argument("--data", required=True)
    pi.add_argument("--output", "-o", default=None)
    pi.add_argument("--top", type=int, default=10)
    pi.set_defaults(fn=cmd_infer)

    pg = sub.add_parser("generate", help="sample data from the model")
    pg.add_argument("config")
    pg.add_argument("-N", type=int, default=1000)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--output", "-o", default=None)
    pg.set_defaults(fn=cmd_generate)

    pd = sub.add_parser("diagnose",
                        help="dictionary-health / recovery report")
    pd.add_argument("--checkpoint", "-c", required=True,
                    help="checkpoint.h5 / result.h5 / .npz with W")
    pd.add_argument("--gt", default=None,
                    help=".npz with gtW, or a config defining gt_params; "
                         "omitted -> health stats only")
    pd.add_argument("--threshold", type=float, default=0.8)
    pd.add_argument("--signed", action="store_true",
                    help="match columns by |cosine| (TSC/MMCA-style)")
    pd.add_argument("--support-frac", type=float, default=0.25)
    pd.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    pd.set_defaults(fn=cmd_diagnose)

    args = p.parse_args(argv)
    from prosper_tpu.utils import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
