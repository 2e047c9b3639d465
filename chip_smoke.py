"""Smoke run of the main path on one GPU; ``--chips 4``: the mesh path on four.

    python chip_smoke.py              # one GPU, every phase below
    python chip_smoke.py --chips 4    # four GPUs, the mesh phase only

Phases, in one process (a second JAX process could not reserve the card):

  device     JAX must report a GPU (there is no CPU fallback); prints its
             kind and count and each card's name and power limit.
  train      BSC at the patches width (BASELINE.json configs[4]: D=256,
             H=300, H'=8, gamma=4) on N=2^20 datapoints from a seeded
             planted dictionary, through ``EM.run_scanned``; every parameter
             and F finite, Q_mean rising.
  cli        ``prosper_tpu.cli.main(["train", <bars config>])`` in this
             process; 10/10 bars recovered.
  oracle     one BSC E+M step at the patches width on 4096 datapoints
             against the float64 NumPy reference, at the default matmul
             precision, with the share of datapoints whose top-H' candidate
             set differs from the reference's.
  families   one E+M step of every other family at the widths ``bench.py``
             uses, timed, and each family's E-step checked against its
             float64 oracle on a small slice.
  streaming  ``StreamingEM`` over host-resident segments (the rolling
             two-buffer tier) against the in-memory EM.
  mesh       (``--chips 4`` only) the patches-width BSC step on a ('data',)
             mesh and the big-S TSC step on ('data', 'state') meshes (1,4)
             and (2,2), each against the same step on one GPU.

Every phase prints its results on lines of their own; a phase that fails
raises, so the script exits non-zero and prints no result.  The last line
is one JSON object naming the device.  The phase functions take their sizes
as arguments, so tests rehearse them on the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from prosper_tpu.data.patches import planted_dictionary  # noqa: E402
from prosper_tpu.engine.anneal import LinearAnnealing  # noqa: E402
from prosper_tpu.models.base import (make_blank_data,  # noqa: E402
                                     sched_from_anneal)

BARS_CONFIG = os.path.join(ROOT, "examples", "barstest", "param_bars_bsc.py")


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _rel(a, b) -> float:
    """max |a - b| / max |b| (normwise relative error)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))),
                                            1e-30))


def _rel_each(a, b) -> float:
    """max over entries of |a - b| / |b| (per-datapoint relative error)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _check(phase: str, what: str, err: float, tol: float) -> None:
    _say(phase, check=what, err=f"{err:.3e}", tol=f"{tol:.0e}",
         ok=err <= tol)
    if not err <= tol:
        raise AssertionError(f"{phase}: {what} error {err:.3e} > {tol:.0e}")


def _finite(tree) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(v))))
               for v in jax.tree_util.tree_leaves(tree))


def _time_step(model, params, y, reps: int):
    """(compile seconds, seconds per jitted E+M step) at the steady state
    (saturated schedule), each timed window ending in block_until_ready."""
    data = make_blank_data(y)
    sched = sched_from_anneal(LinearAnnealing(10))
    key = jax.random.PRNGKey(0)
    step = model.jit_step(saturated=True)
    t0 = time.perf_counter()
    out = step(params, data, sched, key)
    jax.block_until_ready(out)
    t_compile = time.perf_counter() - t0
    p = params
    t0 = time.perf_counter()
    for _ in range(reps):
        p, F, s = step(p, data, sched, key)
    jax.block_until_ready((p, F, s))
    return t_compile, (time.perf_counter() - t0) / reps


# ---- device -----------------------------------------------------------------

def device_phase() -> dict:
    """Refuses anything but a GPU; returns the device description."""
    from prosper_tpu.utils import gpu_device_info
    info = gpu_device_info()
    _say("device", platform=info["platform"], kind=repr(info["kind"]),
         count=info["count"])
    for line in info["cards"]:
        print(line, flush=True)
    return info


# ---- train ------------------------------------------------------------------

def train_phase(card: str, N: int = 1 << 20, D: int = 256, H: int = 300,
                Hp: int = 8, gamma: int = 4, iters: int = 4,
                chunk: int = 8192, seed: int = 0) -> dict:
    """BSC through EM.run_scanned on planted-dictionary data: two scanned
    segments of ``iters`` annealed iterations each (the first compiles,
    the second is timed warm)."""
    from prosper_tpu.engine.em import EM
    from prosper_tpu.models import BSC

    model = BSC(D, H, Hp, gamma, chunk=chunk)
    gt = {"W": planted_dictionary(D, H, seed=seed),
          "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
    t0 = time.perf_counter()
    data = model.generate_data(gt, N, seed=seed + 1)
    _say("train", generated=N, D=D, H=H, Hprime=Hp, gamma=gamma,
         seconds=f"{time.perf_counter() - t0:.1f}")
    # T stays above 1 over the whole schedule, so every iteration is
    # annealed and both segments run the same compiled scan
    anneal = LinearAnnealing(2 * iters)
    anneal["T"] = [(0.0, 2.0), (1.0, 1.25)]
    anneal["W_noise"] = [(0.0, 0.3), (1.0, 0.0)]
    em = EM(model, anneal, {"y": data["y"]}, seed=seed + 2,
            params=model.standard_init(data, seed=seed + 3))
    del data

    sched = sched_from_anneal(anneal)
    t0 = time.perf_counter()
    compiled = model.jit_step(saturated=False).lower(
        em.params, em.data, sched, jax.random.PRNGKey(0)).compile()
    t_step_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    _say("train", step_compile_s=f"{t_step_compile:.2f}",
         temp_bytes=getattr(mem, "temp_size_in_bytes", None),
         argument_bytes=getattr(mem, "argument_size_in_bytes", None),
         output_bytes=getattr(mem, "output_size_in_bytes", None))

    t0 = time.perf_counter()
    em.run_scanned(n_steps=iters)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = em.run_scanned(n_steps=iters)
    t_warm = time.perf_counter() - t0
    per_iter = t_warm / iters
    Q = [h["Q_mean"] for h in em.history]
    _say("train", scan_compile_s=f"{t_first - t_warm:.2f}",
         ms_per_iter=f"{per_iter * 1e3:.2f}",
         dp_per_s=f"{N / per_iter:.4g}", card=repr(card))
    _say("train", Q_mean=" ".join(f"{q:.4f}" for q in Q))
    if not (_finite(params) and _finite(em.data["F_prev"])
            and all(np.isfinite(Q))):
        raise AssertionError("train: non-finite parameters or F")
    if not Q[-1] > Q[0]:
        raise AssertionError(f"train: Q_mean did not rise ({Q[0]} -> {Q[-1]})")
    return {"ms_per_iter": per_iter * 1e3, "Q_first": Q[0], "Q_last": Q[-1]}


# ---- cli --------------------------------------------------------------------

def cli_phase(out_dir: str, config: str = BARS_CONFIG,
              min_bars: int = 10) -> int:
    """``prosper-tpu train`` on the bars config, in this process."""
    from prosper_tpu import cli
    from prosper_tpu.data.bars import count_recovered_bars

    t0 = time.perf_counter()
    rc = cli.main(["train", config, "-o", out_dir, "-q"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli: train returned {rc}")
    ckpt = os.path.join(out_dir, "checkpoint.h5")
    if os.path.exists(ckpt):
        from prosper_tpu.io import checkpoint
        W = np.asarray(checkpoint.restore(ckpt)[0]["W"])
    else:
        W = np.load(os.path.join(out_dir, "params.npz"))["W"]
    gt = cli.load_config(config)["gt_params"]
    bars = count_recovered_bars(W, np.asarray(gt["W"]), 0.85)
    _say("cli", bars=f"{bars}/{W.shape[1]}", wall_s=f"{wall:.1f}")
    if bars < min_bars:
        raise AssertionError(f"cli: {bars} bars recovered, need {min_bars}")
    return bars


# ---- oracle -----------------------------------------------------------------

#: tolerances of the default-precision step against the float64 reference,
#: with their reasons (relative errors as printed by the phase)
ORACLE_TOL = {
    # per-datapoint F = logsumexp of logits of size ~|y|^2/(2 sigma^2); a
    # float32 matmul on this card may run as TF32 (10-bit mantissa), which
    # shifts each projection y.W_h by ~1e-3 of its size
    "F": 2e-3,
    # sums over 4096 datapoints of posterior-weighted moments; a near-tied
    # candidate or state swapped by TF32 rounding moves mass between two
    # almost equally likely explanations
    "xs": 1e-2, "ss": 1e-2, "abs": 1e-2,
    # M-step: W solves ss W^T = xs^T; sigma is a residual that cancels
    # y2 against the reconstruction
    "W": 1e-2, "pi": 1e-2, "sigma": 1e-2,
}


def oracle_phase(N: int = 4096, D: int = 256, H: int = 300, Hp: int = 8,
                 gamma: int = 4, seed: int = 7, tol=None) -> dict:
    """One BSC E+M step against prosper_tpu.reference.numpy_em (float64)."""
    from prosper_tpu.core.etstep import truncated_prior_logmass
    from prosper_tpu.core.select import top_hprime_candidates
    from prosper_tpu.models import BSC
    from prosper_tpu.reference.numpy_em import NumpyBSC

    tol = dict(ORACLE_TOL, **(tol or {}))
    model = BSC(D, H, Hp, gamma, chunk=N)
    rng = np.random.default_rng(seed)
    W_gt = planted_dictionary(D, H, seed=seed)
    gt = {"W": W_gt, "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
    y = model.generate_data(gt, N, seed=seed + 1)["y"]
    # a mid-training state: the planted atoms blurred, noise overestimated
    params = {"W": (W_gt + 0.5 * rng.standard_normal(W_gt.shape)
                    ).astype(np.float32),
              "pi": np.float32(2.0 / H), "sigma": np.float32(2.0)}
    sched = sched_from_anneal(LinearAnnealing(10))
    ones = jnp.ones((N,), jnp.float32)

    @jax.jit
    def step(p, y_):
        F, sums = model.estep_sums(p, y_, ones, sched)
        logA, logB = truncated_prior_logmass(model.log_pi_active(p), H,
                                             gamma)
        P = jnp.dot(y_, p["W"], preferred_element_type=jnp.float32)
        cand = top_hprime_candidates(
            P, jnp.sqrt(jnp.sum(p["W"] ** 2, axis=0)), Hp, False)
        return F, sums, model.m_step(p, sums, logA, logB), cand

    # None: XLA's default, under which a float32 dot on this card may run
    # as TF32
    precision = (jax.config.jax_default_matmul_precision
                 or "default(float32 dots may run as TF32)")
    p_dev = {k: jnp.asarray(v) for k, v in params.items()}
    F, sums, new, cand = jax.device_get(step(p_dev, jnp.asarray(y)))

    ref = NumpyBSC(D, H, Hp, gamma)
    p64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    y64 = np.asarray(y, np.float64)
    cand_o = ref.select_Hprimes(p64["W"], y64)
    differ = float(np.mean(np.any(np.sort(cand, 1) != np.sort(cand_o, 1),
                                  axis=1)))
    t0 = time.perf_counter()
    F_o, sums_o = ref.e_step(p64, y64)
    new_o = ref.m_step(p64, sums_o)
    t_ref = time.perf_counter() - t0
    _say("oracle", N=N, D=D, H=H, Hprime=Hp, gamma=gamma,
         matmul_precision=precision, candidate_sets_differ=f"{differ:.4f}",
         reference_s=f"{t_ref:.1f}")
    errs = {"F": _rel_each(F, F_o)}
    for k in ("xs", "ss", "abs"):
        errs[k] = _rel(sums[k], sums_o[k])
    for k in ("W", "pi", "sigma"):
        errs[k] = _rel(new[k], new_o[k])
    for k, e in errs.items():
        _check("oracle", k, e, tol[k])
    errs["candidate_sets_differ"] = differ
    return errs


# ---- families ---------------------------------------------------------------

def _family_specs(full: bool):
    """(name, builder, timed N, oracle slice) at the widths bench.py uses,
    or tiny widths for a CPU rehearsal."""
    from prosper_tpu.models.gsc import GSC
    from prosper_tpu.models.linear import DSC, TSC
    from prosper_tpu.models.mca import MCA, MMCA
    from prosper_tpu.models.mixtures import MoG, MoP

    if full:
        D, H, N, chunk = 256, 300, 131072, 8192
        big = dict(D=64, H=32, Hp=10, gamma=5, N=524288, chunk=8192,
                   s_block=1024)
        n_check = 16
    else:
        D, H, N, chunk = 12, 10, 256, 64
        big = dict(D=8, H=8, Hp=6, gamma=4, N=256, chunk=64, s_block=16)
        n_check = 6
    return [
        ("tsc", lambda: TSC(D, H, 6, 3, chunk=chunk), N, n_check),
        ("dsc", lambda: DSC(D, H, 5, 3, phi=(-1.0, 1.0, 2.0), chunk=chunk),
         N, n_check),
        ("gsc", lambda: GSC(D, H, 6, 3, chunk=chunk), N, n_check),
        ("mca", lambda: MCA(D, H, 6, 3, chunk=chunk // 2), N, n_check),
        ("mmca", lambda: MMCA(D, H, 6, 3, chunk=chunk // 2), N, n_check),
        ("tsc_bigs", lambda: TSC(big["D"], big["H"], big["Hp"], big["gamma"],
                                 chunk=big["chunk"], s_block=big["s_block"]),
         big["N"], n_check // 2),
        ("mog", lambda: MoG(D=D, K=H, chunk=8 * chunk), 4 * N, 32 * H),
        ("mop", lambda: MoP(D=D, K=H, chunk=8 * chunk), 4 * N, 32 * H),
    ]


#: E-step oracle tolerances under HIGHEST matmul precision: float32
#: arithmetic with sums taken in another order than the oracle's.  GSC adds
#: float32 Cholesky solves of the per-support posterior systems.
FAMILY_TOL = {"F": 1e-4, "sums": 1e-3}
FAMILY_TOL_GSC = {"F": 5e-4, "sums": 5e-3}


def _test_module(name: str):
    """A module of the test suite, loaded by path: ``tests`` is not a
    package, and another installed ``tests`` package would shadow it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_smoke_{name}", os.path.join(ROOT, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _et_oracle(name, model, params, y, beta):
    """The family's float64 oracle E-step over ``y`` with the device's
    candidate sets; returns (F, sums)."""
    from prosper_tpu.core.select import top_hprime_candidates
    linear_oracle_estep = _test_module("oracle").linear_oracle_estep
    gsc_oracle = _test_module("test_gsc_oracle").gsc_oracle
    max_oracle = _test_module("test_max_oracle").max_oracle

    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    signed = name not in ("mca", "bsc")
    P = jnp.dot(jnp.asarray(y), params["W"])
    cand = np.asarray(top_hprime_candidates(
        P, jnp.sqrt(jnp.sum(params["W"] ** 2, axis=0)), model.Hprime,
        signed))
    kw = dict(beta=beta, prior_beta=1.0)
    if name in ("mca", "mmca"):
        return max_oracle(y, p["W"], float(p["sigma"]), float(p["pi"]),
                          model.Hprime, model.gamma, name == "mmca", cand,
                          **kw)
    if name == "gsc":
        return gsc_oracle(y, p["W"], float(p["sigma"]), float(p["pi"]),
                          float(p["mu"]), float(p["psi"]), model.Hprime,
                          model.gamma, cand, **kw)
    values = np.asarray(model.sa.values, np.float64)
    pi_vec = (np.full(len(values), float(p["pi"]) / len(values))
              if np.ndim(p["pi"]) == 0 else p["pi"])
    return linear_oracle_estep(y, p["W"], float(p["sigma"]), pi_vec, values,
                               model.Hprime, model.gamma,
                               signed_select=model.signed_select,
                               candidates=cand, **kw)


def _check_et_family(name, model, params, n_check, seed):
    rng = np.random.default_rng(seed)
    y = (1.5 * rng.standard_normal((n_check, model.D))).astype(np.float32)
    beta = 0.8
    sched = dict(sched_from_anneal(LinearAnnealing(10)),
                 beta=jnp.float32(beta))
    w = jnp.ones((n_check,), jnp.float32)
    with jax.default_matmul_precision("highest"):
        F, sums = jax.device_get(jax.jit(
            lambda y_: model.estep_sums(params, y_, w, sched))(
                jnp.asarray(y)))
        F_o, sums_o = _et_oracle(name, model, params, y, beta)
    tol = FAMILY_TOL_GSC if name == "gsc" else FAMILY_TOL
    _check("families", f"{name}.F", _rel_each(F, F_o), tol["F"])
    keys = [k for k in sums_o if k in sums and not k.startswith("phi")]
    err = max(_rel(sums[k], sums_o[k]) for k in keys)
    _check("families", f"{name}.sums[{','.join(keys)}]", err, tol["sums"])


def _check_mixture(name, model, params, n_check, seed):
    """One step on data sampled from the model's own parameters, so every
    component explains some datapoints; parameters are compared for the
    components holding at least one datapoint of responsibility (an empty
    component's update is 0/0 on both sides)."""
    mixture_oracle_step = _test_module("test_mixtures").mixture_oracle_step
    y = model.generate_data(jax.device_get(params), n_check,
                            seed=seed)["y"]
    sched = sched_from_anneal(LinearAnnealing(10))
    with jax.default_matmul_precision("highest"):
        new, F, _ = jax.device_get(model.jit_step()(
            params, make_blank_data(y), sched, jax.random.PRNGKey(0)))
    F_o, new_o, rk = mixture_oracle_step(name, params, y)
    used = rk >= 1.0
    _check("families", f"{name}.F", _rel_each(F, F_o), FAMILY_TOL["F"])
    err = max(_rel(np.asarray(new[k])[used], np.asarray(v)[used])
              for k, v in new_o.items() if k != "pi")
    err = max(err, _rel(new["pi"], new_o["pi"]))
    _check("families", f"{name}.params[{int(used.sum())} components]", err,
           FAMILY_TOL["sums"])


def _check_decode(model, params, y, out_dense, out_compact):
    """Both decode layouts agree with each other, and F and s_mean agree
    with the float64 oracle run per datapoint."""
    from prosper_tpu.core.etstep import densify_top_states
    linear_oracle_estep = _test_module("oracle").linear_oracle_estep

    dense_from_compact = np.asarray(densify_top_states(
        {k: jnp.asarray(v) for k, v in out_compact.items()}, model.H))
    if not np.array_equal(dense_from_compact, out_dense["top_states"]):
        raise AssertionError("decode: compact layout does not densify to "
                             "the dense layout")
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    F_o, s_o = [], []
    for n in range(y.shape[0]):
        F_n, sums_n = linear_oracle_estep(
            y[n:n + 1], p["W"], float(p["sigma"]), [float(p["pi"])], [1.0],
            model.Hprime, model.gamma,
            candidates=out_compact["cand"][n:n + 1])
        F_o.append(F_n[0])
        s_o.append(sums_n["s"])
    _check("families", "decode.F", _rel_each(out_dense["F"], F_o),
           FAMILY_TOL["F"])
    _check("families", "decode.s_mean", _rel(out_dense["s_mean"], s_o),
           FAMILY_TOL["sums"])


def families_phase(card: str, full: bool = True, reps: int = 5,
                   seed: int = 11) -> dict:
    """Step time of every family at the bench widths, and its oracle check
    on a small slice (HIGHEST precision, so the check sees the algebra of
    the compiled path rather than TF32 rounding)."""
    times = {}
    for name, build, N, n_check in _family_specs(full):
        model = build()
        rng = np.random.default_rng(seed)
        y = rng.standard_normal((N, model.D)).astype(np.float32)
        if name == "mop":
            y = np.abs(np.floor(3 * y)).astype(np.float32)
        params = model.standard_init({"y": y[:1024]}, seed=4)
        t_c, t = _time_step(model, params, y, reps)
        times[name] = t
        _say("families", family=name, N=N, compile_s=f"{t_c:.2f}",
             step_ms=f"{t * 1e3:.3f}", dp_per_s=f"{N / t:.4g}",
             card=repr(card))
        if name in ("mog", "mop"):
            _check_mixture(name, model, params, n_check, seed)
        else:
            _check_et_family(name, model, params, n_check, seed)

    # serving decode (model.inference), both output layouts
    from prosper_tpu.models import BSC
    D, H, N = (256, 300, 131072) if full else (12, 10, 256)
    model = BSC(D, H, 8 if full else 6, 4 if full else 3, chunk=8192)
    rng = np.random.default_rng(seed)
    params = {"W": jnp.asarray(rng.standard_normal((D, H)), jnp.float32),
              "pi": jnp.float32(2.0 / H), "sigma": jnp.float32(1.0)}
    y = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    for label, dense in (("decode_dense", True), ("decode_compact", False)):
        t0 = time.perf_counter()
        jax.block_until_ready(model.inference(params, {"y": y},
                                              dense_states=dense))
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = model.inference(params, {"y": y}, dense_states=dense)
        jax.block_until_ready(out)
        t = (time.perf_counter() - t0) / reps
        times[label] = t
        _say("families", family=label, N=N, compile_s=f"{t_c:.2f}",
             step_ms=f"{t * 1e3:.3f}", dp_per_s=f"{N / t:.4g}",
             card=repr(card))
    n_check = 8
    with jax.default_matmul_precision("highest"):
        y_c = y[:n_check]
        out_d = jax.device_get(model.inference(params, {"y": y_c},
                                               dense_states=True))
        out_c = jax.device_get(model.inference(params, {"y": y_c},
                                               dense_states=False))
    _check_decode(model, params, np.asarray(y_c), out_d, out_c)
    return times


# ---- streaming --------------------------------------------------------------

def streaming_phase(card: str, N: int = 1 << 19, seg_size: int = 1 << 17,
                    D: int = 256, H: int = 300, Hp: int = 8, gamma: int = 4,
                    chunk: int = 8192, iters: int = 4, seed: int = 3) -> dict:
    """StreamingEM with the device cache off (segments roll through the
    two-buffer upload pipeline every iteration) against the in-memory EM
    from the same parameters and seed."""
    from prosper_tpu.engine.em import EM
    from prosper_tpu.engine.stream import StreamingEM
    from prosper_tpu.models import BSC

    model = BSC(D, H, Hp, gamma, chunk=chunk)
    gt = {"W": planted_dictionary(D, H, seed=seed),
          "pi": np.float32(2.0 / H), "sigma": np.float32(1.0)}
    y = model.generate_data(gt, N, seed=seed + 1)["y"]
    params = model.standard_init({"y": y}, seed=seed + 2)

    def anneal():
        # T stays above 1, so no iteration switches to the saturated step
        # (a second compile inside the timed iterations)
        a = LinearAnnealing(iters)
        a["T"] = [(0.0, 1.5), (1.0, 1.2)]
        return a

    sem = StreamingEM(model, anneal(), y, seg_size=seg_size,
                      params=dict(params), seed=seed + 3, cache_bytes=0)
    p_s = sem.run()
    em = EM(model, anneal(), {"y": y}, params=dict(params), seed=seed + 3)
    p_m = em.run()
    Q_s = [h["Q_mean"] for h in sem.history]
    Q_m = [h["Q_mean"] for h in em.history]
    dt_s = float(np.median([h["dt"] for h in sem.history[1:]]))
    dt_m = float(np.median([h["dt"] for h in em.history[1:]]))
    _say("streaming", N=N, segments=sem.n_seg, seg_size=sem.seg_size,
         streamed_ms_per_iter=f"{dt_s * 1e3:.2f}",
         in_memory_ms_per_iter=f"{dt_m * 1e3:.2f}", card=repr(card))
    if not (_finite(p_s) and all(np.isfinite(Q_s))):
        raise AssertionError("streaming: non-finite parameters or Q")
    # same algebra, with the sufficient statistics summed per segment in
    # another order and the GEMMs compiled in another program (XLA may pick
    # another TF32 algorithm); the (H, H) M-step solve amplifies those
    # float32 differences in W (most in its weakly used columns), and they
    # compound over the iterations; W is compared in the Frobenius norm
    W_s = np.asarray(p_s["W"], np.float64)
    W_m = np.asarray(p_m["W"], np.float64)
    _say("streaming", W_max_abs_rel=f"{_rel(W_s, W_m):.3e}")
    _check("streaming", "Q_mean", _rel(Q_s, Q_m), 1e-4)
    _check("streaming", "W (Frobenius)",
           float(np.linalg.norm(W_s - W_m) / np.linalg.norm(W_m)), 1e-2)
    return {"streamed_ms": dt_s * 1e3, "in_memory_ms": dt_m * 1e3}


# ---- mesh (four GPUs) -------------------------------------------------------

#: one step on a mesh against the same step on one device: the per-chunk
#: work is identical, but the psum adds the shards' partial sums in another
#: order, and the M-step's (H, H) solve amplifies that float32 rounding by
#: the condition number of the second-moment matrix
MESH_TOL = 1e-3


def _one_step(model, params, y, runtime=None, reps: int = 5):
    """(outputs, median seconds over ``reps`` warm calls) of one E+M step.
    With ``runtime`` the step runs on that mesh; it donates the replicated
    params, so each call replicates them afresh from host copies (a device
    array could share its buffer with the replica and be donated with
    it)."""
    params = jax.device_get(params)
    sched = sched_from_anneal(LinearAnnealing(10))
    key = jax.random.PRNGKey(1)
    data = make_blank_data(y)
    if runtime is None:
        step = model.jit_step()

        def call():
            return step(params, data, sched, key)
    else:
        step = runtime.shard_step(model.step_fn)
        data = runtime.shard_data(data)

        def call():
            return step(runtime.replicate(params), data, sched, key)
    out = call()
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return jax.device_get(out), float(np.median(times))


def mesh_phase(card: str, n_devices: int = 4, full: bool = True) -> dict:
    """The patches-width BSC step on a ('data',) mesh and the big-S TSC
    step on ('data', 'state') meshes, each against one device."""
    from prosper_tpu.models.linear import BSC, TSC
    from prosper_tpu.parallel.mesh import MeshRuntime

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise RuntimeError(f"mesh: need {n_devices} devices, found "
                           f"{len(jax.devices())}")
    rng = np.random.default_rng(5)
    cases = []
    if full:
        cases.append(("bsc_data", BSC(256, 300, 8, 4, chunk=8192), 1 << 18,
                      (n_devices,), ("data",)))
        big = TSC(64, 32, 10, 5, chunk=8192, s_block=1024)
        N_big = 1 << 15
    else:
        cases.append(("bsc_data", BSC(12, 10, 6, 3, chunk=32), 128,
                      (n_devices,), ("data",)))
        big = TSC(8, 8, 6, 4, chunk=32, s_block=16)
        N_big = 64
    cases.append(("tsc_bigs_state_1x4", big, N_big, (1, n_devices),
                  ("data", "state")))
    cases.append(("tsc_bigs_state_2x2", big, N_big,
                  (2, n_devices // 2), ("data", "state")))
    errs = {}
    for name, model, N, shape, axes in cases:
        y = rng.standard_normal((N, model.D)).astype(np.float32)
        params = model.standard_init({"y": y[:1024]}, seed=6)
        (p1, F1, s1), t1 = _one_step(model, params, y)
        rt = MeshRuntime(devices=devices, mesh_shape=shape, axis_names=axes)
        (pn, Fn, sn), tn = _one_step(model, params, y, rt)
        err = max([_rel(pn[k], p1[k]) for k in p1]
                  + [_rel(Fn, F1), _rel(sn["F_mean"], s1["F_mean"])])
        _say("mesh", case=name, mesh=shape, N=N,
             one_device_median_ms=f"{t1 * 1e3:.3f}",
             mesh_median_ms=f"{tn * 1e3:.3f}", card=repr(card))
        _check("mesh", f"{name} vs one device", err, MESH_TOL)
        errs[name] = err
    return errs


# ---- main -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh phase, over four GPUs")
    args = ap.parse_args(argv)

    from prosper_tpu.io import h5py_available
    from prosper_tpu.utils import enable_compile_cache
    _say("setup", jax=jax.__version__, compile_cache=enable_compile_cache(),
         h5py=h5py_available())
    info = device_phase()
    card = info["cards"][0] if info["cards"] else info["kind"]
    if args.chips == 4:
        if info["count"] < 4:
            raise RuntimeError(f"--chips 4 needs four GPUs, JAX sees "
                               f"{info['count']}")
        mesh_phase(card, n_devices=4)
    else:
        train_phase(card)
        with tempfile.TemporaryDirectory(dir=ROOT,
                                         prefix=".smoke_cli_") as out_dir:
            cli_phase(out_dir)
        oracle_phase()
        families_phase(card)
        streaming_phase(card)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
