"""The EM training driver.

Reference behavior: SURVEY.md §2 "EM engine" — ``prosper/em/__init__.py ::
EM`` (mount unavailable): holds model/anneal/data/lparams, and ``run()``
loops ``model.step`` + ``dlog.append_all`` + ``anneal.next`` until the
schedule is finished.

Design: the outer loop stays in Python (annealing, logging and
checkpointing are host concerns — SURVEY.md §7 "engine/em.py"); the entire
inner iteration (noisify -> masks -> E-step -> psum -> M-step) is ONE jitted
function, optionally shard_map'd over a device mesh by MeshRuntime.  Anneal
values enter as traced scalars, so the whole training run compiles exactly
once.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.models.base import make_blank_data, sched_from_anneal


def coactivation_split(w_b: np.ndarray, Y: np.ndarray,
                       support_frac: float = 0.25,
                       corr_frac: float = 0.35,
                       contrast_threshold: float = 0.3):
    """Split a suspected blend column into its two constituent atoms.

    Diagnosis: at the patches scale the stable failures are
    *blends* — one learned column w_b ~= a1 + a2 with near-disjoint
    supports (norm ~sqrt(2)x median, doubled support).  Among datapoints
    that correlate with w_b, most contain only ONE of the two atoms
    (P(both) ~ pi^2), so a1's pixels co-vary together and anti-correlate
    with a2's pixels: the top eigenvector of the support-restricted,
    centered covariance is ~indicator(a1) - indicator(a2), and its sign
    partitions the support.  Returns (w1, w2) or None when no clean
    two-group structure exists (the caller falls back to re-seeding).
    """
    thr = support_frac * float(np.max(np.abs(w_b)))
    sup = np.flatnonzero(np.abs(w_b) > thr)
    if sup.size < 4:
        return None
    # rows that contain (at least) one of the two atoms: a single-atom row
    # correlates at ~0.5*||w_b||^2, pure-noise rows at ~N(0, sigma*||w_b||)
    # — select by threshold, NOT a fixed top fraction (at realistic
    # sparsity a fixed fraction is mostly noise rows, which dilutes the
    # covariance contrast below the blend gate)
    c = Y @ w_b
    rows = np.flatnonzero(c > corr_frac * float(w_b @ w_b))
    if rows.size < 32:
        return None
    if rows.size > 4096:
        rows = rows[np.argsort(-c[rows])[:4096]]
    Ys = Y[rows][:, sup]
    Ys = Ys - Ys.mean(axis=0)
    C = Ys.T @ Ys
    evals, evecs = np.linalg.eigh(C)
    v = evecs[:, -1]
    m1 = v >= 0.0
    if m1.sum() < 2 or (~m1).sum() < 2:
        return None
    # a true blend's groups co-vary within and anti-correlate across (a
    # selected row contains one atom or the other); a single atom shows a
    # flat correlation structure (mildly negative everywhere from the
    # top-k selection's collider bias).  Demand real within-vs-cross
    # contrast before splitting.
    d = np.sqrt(np.maximum(np.diag(C), 1e-12))
    R = C / np.outer(d, d)
    off = ~np.eye(sup.size, dtype=bool)
    cross = float(R[np.ix_(m1, ~m1)].mean())
    within_mask = (np.outer(m1, m1) | np.outer(~m1, ~m1)) & off
    within = float(R[within_mask].mean())
    # threshold calibrated online at 0.3; the OFFLINE sweep
    # (data/diagnosis.py::split_blend_sweep) passes 0.22 — its support
    # pre-gate already excludes single atoms, and the round-4 seed-2
    # diagnosis measured true blends at contrast 0.26-0.31
    if within - cross < contrast_threshold:
        return None
    w1 = np.zeros_like(w_b)
    w2 = np.zeros_like(w_b)
    w1[sup[m1]] = w_b[sup[m1]]
    w2[sup[~m1]] = w_b[sup[~m1]]
    # reject splits that did not separate energy meaningfully
    n1, n2 = np.linalg.norm(w1), np.linalg.norm(w2)
    if min(n1, n2) < 0.25 * max(n1, n2):
        return None
    return w1, w2


def run_restarts(build_em, n_restarts: int, scanned: bool = True):
    """Run ``n_restarts`` independent EM trainings, keep the best final F.

    EM on these models is multi-modal (stable blend optima at the patches
    scale); restarting from different inits and selecting by final mean
    free energy is the classic remedy (complementary to the online
    revival/splitting escapes).

    For the linear-family dictionary-recovery protocol this is superseded:
    in a head-to-head on one seed, best-of-2 restarts (240 iters) recovered
    298/300 atoms where one protocol run (revival + reseed + sweeps, ~190
    iters) recovered 300/300 in less time; independent inits land in the
    same blend-limited basin (tools/run_restarts_compare.py).  Kept for
    genuinely multi-modal model selection (e.g. MoG/MoP cluster counts)
    where basin diversity is the point.

    ``build_em(i)`` must return a FRESH ``EM`` (model/anneal/data wiring,
    seeded per restart) — annealing schedules are stateful, so they cannot
    be shared across restarts.  Returns ``(best_params, summary)`` with
    ``summary = {"F_means": [...], "best": index}``.
    """
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    best_params, f_means, best_i = None, [], 0
    for i in range(n_restarts):
        em = build_em(i)
        params = em.run_scanned() if scanned else em.run()
        f = float(em.history[-1]["F_mean"])
        f_means.append(f)
        if best_params is None or f > f_means[best_i]:
            best_params, best_i = params, i
    return best_params, {"F_means": f_means, "best": best_i}


class EM:
    """EM training loop.

    Parameters
    ----------
    model : ETModel
    anneal : LinearAnnealing
    data : dict with 'y' (N, D) (and optional 'valid'); will be wrapped and,
        when a runtime is given, sharded over the mesh data axis.
    params : initial parameter pytree; defaults to model.standard_init(data).
    runtime : optional MeshRuntime for multi-device data parallelism.
    dlog : optional DataLog; per-iteration channels are appended to it.
    log_params_every : also log full W snapshots every k iterations
        (the reference logs W every iteration; for big models that is pure
        device->host traffic, so it is rate-limited here; set 1 for
        parity).
    """

    def __init__(self, model, anneal, data: Dict, params: Optional[Dict] = None,
                 runtime=None, dlog=None, seed: int = 42,
                 log_params_every: int = 1,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 revive_duplicates: Optional[tuple] = None,
                 split_norm_frac: float = 0.0,
                 split_coact: bool = False,
                 reseed_worst_frac: float = 0.0):
        self.model = model
        self.anneal = anneal
        self.runtime = runtime
        self.dlog = dlog
        self.log_params_every = log_params_every
        #: periodic failure-recovery checkpoints (SURVEY.md §5.3): every k
        #: iterations the params are written so --resume restarts mid-run
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        #: (every, cosine_threshold[, stop_frac[, dead_norm_frac]]) or None —
        #: addition beyond the reference: near-parallel dictionary
        #: columns fight over the same atom (a local optimum the annealing
        #: cannot escape); periodically re-initialising the weaker duplicate
        #: to a random datapoint direction raised planted-dictionary recovery
        #: at the patches scale from 269/300 to 285/300.  Disabled during the
        #: final stop_frac (default 0.75) of the schedule so convergence is
        #: clean.  dead_norm_frac (default 0 = off) additionally revives
        #: "dead" columns whose norm has decayed below dead_norm_frac times
        #: the median column norm (an unused atom receives ~no sufficient
        #: statistics, so the ridge M-step shrinks it toward zero).
        #: Revival fires BEFORE the checkpoint and the checkpoint carries
        #: the revival PCG64 state (extra["revive_rng"]), so a resumed run
        #: replays the identical trajectory, revivals included
        #: (tests/test_resume.py::test_resume_equivalence_with_revival)
        if revive_duplicates is not None:
            if not 2 <= len(revive_duplicates) <= 4:
                raise ValueError(
                    "revive_duplicates must be (every, cos_threshold"
                    "[, stop_frac[, dead_norm_frac]]), got "
                    f"{revive_duplicates!r}")
            defaults = (None, None, 0.75, 0.0)
            revive_duplicates = (int(revive_duplicates[0]),
                                 *(float(v) for v in revive_duplicates[1:]),
                                 *defaults[len(revive_duplicates):])
        self.revive_duplicates = revive_duplicates
        #: with revive_duplicates: when a column is freed (duplicate/dead),
        #: prefer splitting the highest-norm column above split_norm_frac x
        #: the median norm (a blend of two atoms carries ~sqrt(2)x energy)
        #: into a symmetric +/- perturbation pair instead of a random
        #: re-init; 0 disables
        self.split_norm_frac = float(split_norm_frac)
        #: with split_norm_frac: split suspected blends by co-activation
        #: clustering of their support pixels (coactivation_split) instead of
        #: a symmetric +/- perturbation — the round-1 measured-negative
        #: symmetric split guessed the partition; this one reads it off the
        #: data.  Falls back to re-seeding when no two-group structure exists
        self.split_coact = bool(split_coact)
        if self.split_coact and self.split_norm_frac <= 0.0:
            # split_coact without a pool threshold would be a silent no-op
            # (the pool gate runs first); default to the calibrated
            # support-size factor (blends sit at ~1.6-1.9x the median
            # support, detector threshold 1.5) so `split_coact=True` alone
            # enables the documented behavior
            self.split_norm_frac = 1.5
        self._coact_sample = None
        #: observability: how often each revival action fired this run
        self.revival_stats = {"revived": 0, "coact_split": 0,
                              "coact_rejected": 0, "sym_split": 0,
                              "reseeded": 0}
        #: with revive_duplicates: re-seed freed columns from datapoints in
        #: the worst-explained tail (bottom reseed_worst_frac of the
        #: per-datapoint free energy F_prev) instead of uniformly — missing
        #: dictionary atoms concentrate where the current model explains
        #: the data worst; 0 keeps uniform sampling
        self.reseed_worst_frac = float(reseed_worst_frac)
        self._revive_rng = np.random.default_rng(seed + 1)
        self._revive_valid_rows = None
        # periodic actions fire on boundary crossings (position advanced past
        # last_fired + every), not on exact multiples: run_scanned segments
        # end at multiples of the SMALLEST period, so a modulo test would
        # silently skip the larger-period action
        self._last_ckpt = anneal.position
        self._last_revive = anneal.position
        self.rng = jax.random.PRNGKey(seed)

        # static-shape padding with valid=0 rows: the
        # chunked E-step needs per-shard sizes that divide the chunk and
        # the mesh needs N to divide the shard count; the CLI has always
        # padded (cli.py) — the library path now applies the same rule, so
        # EM(model, anneal, {"y": y}) works at any N.  No-op when N
        # already fits.  Padded rows carry weight 0 everywhere (the E-step
        # multiplies every accumulated statistic by `valid`).
        shards = runtime.n_data_shards if runtime is not None else 1
        N = data["y"].shape[0]
        per_shard = -(-N // shards)
        c = (model.chunk
             if (getattr(model, "requires_chunk_multiple", False)
                 and per_shard > model.chunk) else 1)
        mult = shards * c
        N_pad = -(-N // mult) * mult
        if N_pad != N:
            pad = N_pad - N
            padded = {"y": jnp.pad(jnp.asarray(data["y"], jnp.float32),
                                   ((0, pad), (0, 0)))}
            valid = data.get("valid")
            valid = (jnp.ones((N,), jnp.float32) if valid is None
                     else jnp.asarray(valid, jnp.float32))
            padded["valid"] = jnp.pad(valid, (0, pad))
            if "F_prev" in data:
                padded["F_prev"] = jnp.pad(
                    jnp.asarray(data["F_prev"], jnp.float32), (0, pad))
            data = padded

        if "F_prev" not in data:
            data = make_blank_data(data["y"], data.get("valid"))
        if params is None:
            params = model.standard_init(data)

        if runtime is not None:
            self.data = runtime.shard_data(data)
            self.params = runtime.replicate(params)
        else:
            self.data = data
            self.params = params
        self._steps = {}
        self._scans = {}         # (length, saturated, collect_params) -> jit

        self.history: list = []

    def _get_step(self, saturated: bool):
        """Jitted step for the given static specialization (cached).

        ``saturated=True`` (beta == prior_beta == 1 on the HOST schedule —
        the post-anneal steady state) selects the step variant that skips
        the duplicate un-annealed free-energy channel (F_true == F there);
        see ETModel.step_fn.  Chosen per-iteration from host floats, so
        trajectories are unchanged."""
        if saturated not in self._steps:
            from functools import partial as _p
            if self.runtime is not None:
                self._steps[saturated] = self.runtime.shard_step(
                    _p(self.model.step_fn, saturated=saturated))
            else:
                self._steps[saturated] = self.model.jit_step(
                    saturated=saturated)
        return self._steps[saturated]

    def _get_scan(self, length: int, sat: bool, collect_params: bool):
        """Jitted k-iteration segment scan, cached per (length, saturation,
        collect_params).  y/valid/F_prev/schedules enter as arguments so
        the jit cache hits across segments (see run_scanned)."""
        key = (length, sat, collect_params)
        if key not in self._scans:
            step = self._get_step(sat)

            def seg(carry, y, valid, sched_arr):
                def body(carry, sched_i):
                    params, F_prev, rng = carry
                    rng, sub = jax.random.split(rng)  # same chain as step_once
                    data_i = {"y": y, "valid": valid, "F_prev": F_prev}
                    params, F, scalars = step(params, data_i, sched_i, sub)
                    return ((params, F, rng),
                            (scalars, params if collect_params else None))
                return jax.lax.scan(body, carry, sched_arr)

            self._scans[key] = jax.jit(seg)
        return self._scans[key]

    def _sat_now(self) -> bool:
        from prosper_tpu.models.base import sched_floats
        f = sched_floats(self.anneal)
        return (float(f.get("beta", 1.0)) == 1.0
                and float(f.get("prior_beta", 1.0)) == 1.0)

    def run(self, verbose: bool = False) -> Dict:
        """Run until the annealing schedule is exhausted; returns params."""
        while not self.anneal.finished:
            self.step_once(verbose=verbose)
        return self.params

    def run_scanned(self, n_steps: Optional[int] = None,
                    collect_params: bool = False) -> Dict:
        """Run k EM iterations inside ONE jit via lax.scan.

        The BASELINE.json north star calls for "the EM driver becomes a
        jit-compiled scan": annealing values become per-iteration arrays
        scanned over on device, removing all host dispatch between
        iterations.  Per-iteration scalars are returned stacked and appended
        to history/dlog afterwards.

        ``collect_params=True`` additionally stacks full per-iteration
        parameter snapshots on device and logs them to the dlog with the
        same ``log_params_every`` thinning as the Python loop — reference
        parity (the reference logs W every iteration) at the cost of
        k x params device memory per scan segment.
        """
        from prosper_tpu.models.base import sched_floats

        remaining = self.anneal.steps - self.anneal.position
        k = remaining if n_steps is None else min(n_steps, remaining)
        if k <= 0:
            return self.params

        # periodic host-side work (failure-recovery checkpoints, duplicate
        # revival) splits the scan into segments (at most two distinct scan
        # lengths compile: the segment size and the tail)
        segs = []
        if self.checkpoint_path and self.checkpoint_every:
            segs.append(self.checkpoint_every)
        if self.revive_duplicates is not None:
            segs.append(self.revive_duplicates[0])
        seg_size = min(segs) if segs else 0
        if seg_size and k > seg_size:
            done = 0
            while done < k:
                seg = min(seg_size, k - done)
                self.run_scanned(seg, collect_params=collect_params)
                done += seg
            return self.params

        # per-iteration schedule arrays (pure host floats -> ONE device
        # transfer; building per-step device scalars would cost hundreds of
        # tiny transfers)
        scheds = []
        probe = self.anneal.position
        for j in range(k):
            self.anneal.position = probe + j
            scheds.append(sched_floats(self.anneal))
        self.anneal.position = probe
        # static saturation split: iterations where beta == prior_beta == 1
        # (host-known) run the specialized step that skips the duplicate
        # un-annealed channel.  A mixed window runs as back-to-back uniform
        # sub-scans INSIDE this call (carry threaded through), so the
        # segment-boundary host work (revival, checkpoint cadence) fires
        # exactly once, at the true segment end
        sats = [float(sc.get("beta", 1.0)) == 1.0
                and float(sc.get("prior_beta", 1.0)) == 1.0 for sc in scheds]
        runs, start = [], 0
        for j in range(1, k + 1):
            if j == k or sats[j] != sats[start]:
                runs.append((start, j, sats[start]))
                start = j

        y = self.data["y"]
        valid = self.data["valid"]

        t0 = time.perf_counter()
        carry = (self.params, self.data["F_prev"], self.rng)
        outs = []
        for (lo, hi, sat) in runs:
            sched_arr = {key: jnp.asarray(
                np.array([s[key] for s in scheds[lo:hi]], np.float32))
                for key in scheds[0]}
            # the segment scan is a CACHED jit with y/valid as ARGUMENTS —
            # an eager lax.scan here recompiles on EVERY call (closure
            # constants defeat the primitive compile cache)
            carry, out = self._get_scan(hi - lo, sat, collect_params)(
                carry, y, valid, sched_arr)
            outs.append(out)
        params, F, rng = carry
        jax.block_until_ready(params)
        total_dt = time.perf_counter() - t0
        if len(outs) == 1:
            stacked, phist = outs[0]
        else:
            stacked = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0),
                *[o[0] for o in outs])
            phist = (jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0),
                *[o[1] for o in outs]) if collect_params else None)

        self.rng = rng
        self.params = params
        self.data = dict(self.data, F_prev=F)
        stacked = {kk: np.asarray(jax.device_get(v))
                   for kk, v in stacked.items()}
        if phist is not None:
            phist = {kk: np.asarray(jax.device_get(v))
                     for kk, v in phist.items()}
        for j in range(k):
            rec = {kk: float(v[j]) for kk, v in stacked.items()}
            rec["iteration"] = self.anneal.position
            rec["dt"] = total_dt / k
            self.history.append(rec)
            if self.dlog is not None:
                if phist is not None:
                    big = self.log_params_every and (
                        self.anneal.position % self.log_params_every == 0)
                    rec = dict(rec)
                    for kk, v in phist.items():
                        if v[j].ndim <= 1 or big:
                            rec[kk] = v[j]
                self.dlog.append_all(rec)
            self.anneal.next()
        # revival BEFORE checkpoint: the checkpoint then captures the
        # post-revival params and revival-RNG state, so a resumed run
        # replays the identical trajectory (revival included)
        self._maybe_revive_duplicates()
        self._maybe_checkpoint()
        return self.params

    def step_once(self, verbose: bool = False) -> Dict:
        t0 = time.perf_counter()
        sched = sched_from_anneal(self.anneal)
        self.rng, sub = jax.random.split(self.rng)
        params, F, scalars = self._get_step(self._sat_now())(
            self.params, self.data, sched, sub)
        self.params = params
        self.data = dict(self.data, F_prev=F)

        scalars = {k: float(jax.device_get(v)) for k, v in scalars.items()}
        scalars["iteration"] = self.anneal.position
        scalars["T"] = float(self.anneal["T"])
        scalars["dt"] = time.perf_counter() - t0
        self.history.append(scalars)

        if self.dlog is not None:
            rec = dict(scalars)
            big = self.log_params_every and (
                self.anneal.position % self.log_params_every == 0)
            for k, v in self.params.items():
                arr = np.asarray(jax.device_get(v))
                if arr.ndim <= 1 or big:   # scalars/vectors always; W etc. rate-limited
                    rec[k] = arr
            self.dlog.append_all(rec)

        if verbose:
            from prosper_tpu.parallel.mesh import pprint
            pprint(f"[em] iter {self.anneal.position:4d} "
                   f"F/N={scalars['F_mean']:+.4f} "
                   f"n_used={scalars['n_used']:.0f} "
                   f"T={scalars['T']:.2f} dt={scalars['dt']*1e3:.1f}ms")

        self.anneal.next()
        # revival BEFORE checkpoint: the checkpoint then captures the
        # post-revival params and revival-RNG state, so a resumed run
        # replays the identical trajectory (revival included)
        self._maybe_revive_duplicates()
        self._maybe_checkpoint()
        return scalars

    def _local_np(self, a) -> np.ndarray:
        """This process's rows of a (possibly cross-process-sharded) array.

        Single-process: the whole array.  Multi-process: the concatenation
        of this process's addressable shards in global row order — global
        arrays over non-addressable devices cannot be device_get.
        """
        if jax.process_count() == 1 or not isinstance(a, jax.Array):
            return np.asarray(jax.device_get(a))
        shards = sorted(a.addressable_shards,
                        key=lambda s: (s.index[0].start or 0))
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    def _data_row(self, idx: int) -> np.ndarray:
        """One datapoint row; multi-process ``idx`` indexes LOCAL rows."""
        y = self.data["y"]
        if jax.process_count() == 1:
            return np.asarray(jax.device_get(y[int(idx)]))
        off = 0
        for s in sorted(y.addressable_shards,
                        key=lambda sh: (sh.index[0].start or 0)):
            n = s.data.shape[0]
            if idx < off + n:
                return np.asarray(s.data)[int(idx) - off]
            off += n
        raise IndexError(idx)

    def _maybe_revive_duplicates(self) -> None:
        cfg = self.revive_duplicates
        if cfg is None or "W" not in self.params:
            return
        every, threshold, stop_frac, dead_norm_frac = cfg
        pos = self.anneal.position
        if pos - self._last_revive < every or pos >= stop_frac * self.anneal.steps:
            return
        self._last_revive = pos
        # Multi-host: the gates above are host-deterministic
        # (same anneal position everywhere), so all processes reach this
        # point together; rank 0 computes the revival on ITS local data
        # shard and the result is broadcast, preserving SPMD determinism.
        multihost = jax.process_count() > 1
        if multihost and jax.process_index() != 0:
            self._bcast_revived_W(np.asarray(jax.device_get(
                self.params["W"])), revived=0)
            return
        W = np.array(jax.device_get(self.params["W"]), copy=True)
        norms = np.linalg.norm(W, axis=0) + 1e-9
        C = (W / norms).T @ (W / norms)
        np.fill_diagonal(C, 0.0)
        used: set = set()
        revived = 0
        if self._revive_valid_rows is None:
            valid = self._local_np(self.data["valid"])
            self._revive_valid_rows = np.flatnonzero(valid > 0)
        rows = self._revive_valid_rows
        if self.reseed_worst_frac > 0.0:
            F = self._local_np(self.data["F_prev"])[rows]
            k = max(1, int(self.reseed_worst_frac * rows.size))
            rows = rows[np.argsort(F)[:k]]

        split_norm_frac = self.split_norm_frac
        median_norm = float(np.median(norms))
        if split_norm_frac <= 0.0:
            split_pool = []
        elif self.split_coact:
            # measured on converged patches runs: blend columns
            # sit BELOW the median norm (the M-step rescales them down) but
            # their support is ~2x the planted atom's — support size is the
            # razor-sharp statistic (median 8 / p90 8 / blends 13-15), so
            # the candidate pool uses split_norm_frac x median SUPPORT.
            # The statistic is the diagnosis module's (the offline
            # calibration source for this detector); a norm floor excludes
            # near-dead noise columns, whose relative support is wide but
            # which carry no blend
            from prosper_tpu.data.diagnosis import dictionary_stats
            st = dictionary_stats(W)
            sup_sizes = st["support"]
            med_sup = max(float(st["median_support"]), 1.0)
            norm_floor = 0.3 * st["median_norm"]
            split_pool = [int(h) for h in np.argsort(-sup_sizes)
                          if sup_sizes[h] >= split_norm_frac * med_sup
                          and norms[h] >= norm_floor]
        else:
            # symmetric-split heuristic: norm far above median —
            # a fused pair of atoms carries ~sqrt(2)x the energy
            split_pool = [int(h) for h in np.argsort(norms)[::-1]
                          if norms[h] > split_norm_frac * median_norm]

        def reinit(col: int) -> None:
            # prefer splitting a suspected blend: either read the partition
            # off the data (co-activation clustering) or seed the freed
            # column and the blend with symmetric +/- perturbations so the
            # E-step can break the symmetry
            while split_pool:
                b = split_pool.pop(0)
                if b in used or b == col:
                    # b == col would overwrite the freed column with itself:
                    # the coact split would drop one recovered atom and the
                    # symmetric split would cancel to a no-op
                    continue
                if self.split_coact:
                    parts = coactivation_split(
                        W[:, b].astype(np.float64), self._coact_rows())
                    if parts is None:
                        self.revival_stats["coact_rejected"] += 1
                        continue          # not a clean blend: next candidate
                    W[:, b] = parts[0].astype(np.float32)
                    W[:, col] = parts[1].astype(np.float32)
                    self.revival_stats["coact_split"] += 1
                else:
                    eps = 0.3 * norms[b] / np.sqrt(W.shape[0])
                    noise = (eps * self._revive_rng.standard_normal(
                        W.shape[0])).astype(np.float32)
                    W[:, col] = W[:, b] + noise
                    W[:, b] = W[:, b] - noise
                    self.revival_stats["sym_split"] += 1
                used.add(b)
                return
            idx = int(rows[self._revive_rng.integers(0, rows.size)])
            sample = self._data_row(idx)
            noise = self._revive_rng.standard_normal(W.shape[0])
            W[:, col] = 0.5 * sample + 0.5 * noise.astype(np.float32)
            self.revival_stats["reseeded"] += 1

        for h in range(W.shape[1]):
            j = int(np.argmax(C[h]))
            if C[h, j] > threshold and h not in used and j not in used:
                weaker = j if norms[j] <= norms[h] else h
                reinit(weaker)
                used.update((h, j))
                revived += 1
        if dead_norm_frac > 0.0:
            floor = dead_norm_frac * median_norm
            for h in range(W.shape[1]):
                if h not in used and norms[h] < floor:
                    reinit(h)
                    used.add(h)
                    revived += 1
        if jax.process_count() > 1:
            self.revival_stats["revived"] += revived
            self._bcast_revived_W(W, revived)
            return
        if revived:
            self.revival_stats["revived"] += revived
            new_W = jnp.asarray(W, jnp.float32)
            if self.runtime is not None:
                new_W = self.runtime.replicate(new_W)
            self.params = dict(self.params, W=new_W)

    def _bcast_revived_W(self, W_host: np.ndarray, revived: int) -> None:
        """Multi-host revival commit: broadcast rank 0's (possibly revised)
        W and whether anything fired; every process installs the identical
        result (a collective — ALL processes must call this together)."""
        from jax.experimental import multihost_utils
        flag = np.int32(revived)
        W_g = multihost_utils.broadcast_one_to_all(
            np.ascontiguousarray(W_host, np.float32))
        flag_g = int(multihost_utils.broadcast_one_to_all(flag))
        if flag_g:
            new_W = jnp.asarray(np.asarray(W_g), jnp.float32)
            if self.runtime is not None:
                new_W = self.runtime.replicate(new_W)
            self.params = dict(self.params, W=new_W)

    def revival_rng_state(self) -> np.ndarray:
        """Revival PCG64 state as a (6,) uint64 array (checkpointable)."""
        st = self._revive_rng.bit_generator.state
        s, inc = st["state"]["state"], st["state"]["inc"]
        m = (1 << 64) - 1
        return np.array([s & m, s >> 64, inc & m, inc >> 64,
                         int(st["has_uint32"]), st["uinteger"]], np.uint64)

    def restore_revival_rng(self, arr) -> None:
        """Inverse of revival_rng_state (applied by --resume)."""
        a = [int(v) for v in np.asarray(arr, np.uint64)]
        self._revive_rng.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {"state": a[0] | (a[1] << 64),
                      "inc": a[2] | (a[3] << 64)},
            "has_uint32": a[4], "uinteger": a[5]}

    def _coact_rows(self) -> np.ndarray:
        """Cached host-side subsample of valid datapoints for blend
        splitting (bounded device->host transfer, fetched once per run)."""
        if self._coact_sample is None:
            rows = self._revive_valid_rows
            if rows is None:
                valid = self._local_np(self.data["valid"])
                rows = self._revive_valid_rows = np.flatnonzero(valid > 0)
            # ceil-stride so the subsample spans the WHOLE dataset (a
            # floor stride kept only a prefix for 65k < n < 131k rows,
            # biasing the blend-split covariance — review r2)
            take = rows[:: max(1, -(-rows.size // 65536))][:65536]
            if jax.process_count() == 1:
                self._coact_sample = np.asarray(
                    jax.device_get(self.data["y"][jnp.asarray(take)]),
                    np.float64)
            else:
                # rank 0's local shard (rows/take are local indices)
                self._coact_sample = self._local_np(
                    self.data["y"])[take].astype(np.float64)
        return self._coact_sample

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_path and self.checkpoint_every
                and self.anneal.position - self._last_ckpt
                >= self.checkpoint_every):
            self._last_ckpt = self.anneal.position
            from prosper_tpu.io import checkpoint
            # F_prev rides along so a resumed run's Ncut mask matches the
            # uninterrupted trajectory (it ranks by the previous iteration's
            # free energies — models/base.py design note).  Multi-process
            #: the global F_prev spans non-addressable
            # devices, so it is assembled with process_allgather — every
            # process participates (collective), rank 0 writes.
            extra = {}
            if jax.process_count() == 1:
                extra["F_prev"] = np.asarray(
                    jax.device_get(self.data["F_prev"]))
            else:
                from jax.experimental import multihost_utils
                extra["F_prev"] = np.asarray(multihost_utils.process_allgather(
                    self.data["F_prev"], tiled=True))
            if self.revive_duplicates is not None:
                extra["revive_rng"] = self.revival_rng_state()
                # revival cadence state: without it, resuming from a
                # checkpoint step not aligned with the revival period would
                # shift every later revival vs the uninterrupted run
                extra["revive_last"] = np.int64(self._last_revive)
            checkpoint.save(
                self.checkpoint_path, self.params,
                step=self.anneal.position, rng=self.rng, extra=extra)
