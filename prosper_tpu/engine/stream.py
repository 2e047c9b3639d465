"""Host->device streaming EM for datasets beyond device memory.

Reference behavior: SURVEY.md §0 names natural image patches at N >= 1e6
as the scaling benchmark; the reference streams nothing (every MPI rank
holds its shard in host RAM and NumPy touches it in-place), but on an
accelerator the analogous regime is a dataset larger than device memory.

Design:
  * the dataset stays on HOST (any sliceable (N, D) array: np.ndarray,
    np.memmap, h5py dataset); the device holds at most TWO segments at a
    time — segment k+1 uploads (async ``jax.device_put``) while segment k's
    E-step computes, so the device working set is 2 x seg_size x D floats
    regardless of N.  A device-cache tier (``cache_bytes``, default 8 GiB)
    keeps ALL segments resident when the dataset fits — uploads then happen
    once, and later iterations pay zero host->device traffic;
  * each EM iteration makes one pass over all segments, accumulating the
    family's summed sufficient statistics on device (the segment partial
    sums are tiny: (D,H)+(H,H)+scalars), then runs the closed-form M-step
    once — numerically the SAME algebra as the in-memory step, re-ordered
    sums aside;
  * the models' fused steps are reused, not reimplemented: families expose
    ``estep_sums`` (E-statistics over one device-resident block) and
    ``finalize_mstep`` (mesh reduction + M-step + scalars), and both
    ``ETModel.step_fn`` and this driver are thin orchestrations over them.

Ncut semantics (the subtle part): the engine's default Ncut ranks the data
cut by the PREVIOUS iteration's free energies (the documented one-pass
design, models/base.py).  That lag is exactly what makes streaming work:
the global keep-threshold is computed BEFORE the pass from the host-resident
F_prev array, with the same histogram-bisection arithmetic as the device
path (f32, 128 bins, 3 rounds — core/select.py::global_quantile_threshold),
so trajectories match the in-memory driver bit-for-bit when the partial
channel is off.  Deviations, documented:
  * ``partial`` < 1 draws an exact-count random mask PER SEGMENT (the
    in-memory path draws one global mask) — same distribution for iid data,
    different RNG stream; kept counts are sum_seg ceil(frac*n_seg) vs one
    global ceil(frac*N) (tests/test_streaming.py pins both);
  * when ``partial`` < 1 AND Ncut overlap, the streamed threshold ranks
    ALL valid rows with keep = frac_keep * N and the partial mask then
    intersects it (expected kept fraction = frac_keep of the subset),
    while the in-memory path ranks the partial subset itself with
    keep = frac_keep * |subset| (exact count).  Same kept fraction, a
    different (random) realisation of which rows — the divergence is
    bounded by the masks' MC error
    (tests/test_streaming.py::test_streaming_partial_ncut_deviation_bounded).

Multi-process (the beyond-device-memory x multi-host combination,
SURVEY.md §5.8 x §0's N >= 1e6 regime): with a MeshRuntime
whose mesh spans several processes (``jax.distributed``), each process
streams its OWN ``stride_data`` host shard of the dataset.  Segments
advance in LOCKSTEP across processes — the per-segment ``shard_map``
already psums sufficient statistics over the whole mesh, so every process
must dispatch every segment; processes whose shard is shorter contribute
pure-padding segments (valid = 0 everywhere).  Host-side global
reductions (the Ncut threshold's min/max/histogram, the keep count, the
M-step's N_total) run over ``process_allgather`` with the identical f32
bin arithmetic, so a P-process streamed run matches the single-process
streamed trajectory up to collective reduction order.  Rank 0 owns
checkpoint IO; the checkpoint carries the process_allgather'd global
F_prev in stride order so a resumed run (same process count) replays the
uninterrupted trajectory.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.models.base import sched_floats


def _process_allreduce(x, op: str):
    """Reduce a host value across processes (sum/min/max) via
    ``process_allgather`` — deterministic and identical on every process.
    f32 histogram sums stay exact (integer-valued counts < 2^24/bin)."""
    from jax.experimental import multihost_utils
    g = np.asarray(multihost_utils.process_allgather(np.asarray(x)))
    if op == "sum":
        return g.sum(axis=0)
    if op == "min":
        return g.min(axis=0)
    return g.max(axis=0)


def host_quantile_threshold(values: np.ndarray, valid: np.ndarray,
                            keep_count: float, rounds: int = 3,
                            bins: int = 128, allreduce=None) -> float:
    """Host twin of core/select.py::global_quantile_threshold (f32, same
    bin arithmetic) so streamed Ncut masks match the device path.

    ``allreduce``: optional ``(x, op) -> x`` with op in {"sum","min","max"}
    reducing across processes (multi-process streaming: ``values`` holds
    only this process's rows; the bin counts/extents are combined globally
    with the identical arithmetic).  None = single-process identity.
    """
    red = allreduce if allreduce is not None else (lambda x, _op: x)
    v = values.astype(np.float32, copy=False)
    ok = valid > 0
    big = np.float32(3e38)
    lo = red(np.float32(v[ok].min() if ok.any() else big), "min")
    hi = red(np.float32(v[ok].max() if ok.any() else -big), "max")
    if hi < lo:                         # globally nothing valid
        return float("-inf")
    lo = np.float32(lo)
    hi = np.float32(hi + max(np.float32(1e-6), np.float32(1e-6) * abs(hi)))
    keep = np.float32(keep_count)
    for _ in range(rounds):
        width = np.float32(max((hi - lo) / np.float32(bins),
                               np.float32(1e-30)))
        idx = np.clip(np.floor((v - lo) / width), 0, bins - 1).astype(np.int32)
        hist = np.bincount(idx[ok], minlength=bins).astype(np.float32)[:bins]
        hist = red(hist, "sum")
        tail = np.cumsum(hist[::-1])[::-1]
        ok_bins = tail >= keep
        b_star = int(np.max(np.where(ok_bins, np.arange(bins), 0)))
        lo = np.float32(lo + np.float32(b_star) * width)
        hi = np.float32(lo + width)
    return float(lo)


class StreamingEM:
    """EM over a host-resident dataset, streamed segment-by-segment.

    Parameters
    ----------
    model : an ETModel family exposing ``estep_sums`` / ``finalize_mstep``
        (BSC/TSC/DSC, MCA/MMCA, GSC).
    anneal : LinearAnnealing.
    y : host (N, D) sliceable — np.ndarray / np.memmap / h5py dataset.
    seg_size : datapoints per device segment; rounded up to a multiple of
        ``model.chunk``.  Device working set ~= 2 * seg_size * D * 4 bytes.
    params : initial pytree; defaults to ``model.standard_init`` on the
        FIRST segment (the data mean/std of a large iid segment match the
        full dataset's within sampling error; document when comparing
        trajectories against the in-memory driver — pass explicit params
        for exact equivalence).
    """

    def __init__(self, model, anneal, y, seg_size: int = 1 << 20,
                 params: Optional[Dict] = None, seed: int = 42,
                 dlog=None, log_params_every: int = 1,
                 cache_bytes: Optional[int] = 8 << 30,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 runtime=None):
        if not (hasattr(model, "estep_sums")
                and hasattr(model, "finalize_mstep")):
            raise TypeError(
                f"{type(model).__name__} does not expose the streaming "
                "protocol (estep_sums + finalize_mstep); the ET families "
                "(BSC/TSC/DSC, MCA/MMCA, GSC) do — mixtures fit in device "
                "memory by construction, use EM")
        if getattr(model, "ncut_current", False):
            raise ValueError(
                "ncut_current (reference same-iteration Ncut ranking) needs "
                "a second E-step pass per iteration and is not supported by "
                "the streaming driver; use the default lagged ranking or "
                "the in-memory EM")
        #: optional MeshRuntime: each segment is sharded over the mesh data
        #: axis (shard_map'd E-step, psum'd sufficient statistics — the
        #: beyond-device-memory x multi-device combination); a
        #: ('data','state') mesh
        #: additionally shards the enumerated-state axis for supporting
        #: models, exactly like EM.  Multi-process: ``y`` is this process's
        #: ``stride_data`` host shard; see the module docstring.
        self.runtime = runtime
        self.model = model
        self.anneal = anneal
        self.dlog = dlog
        self.log_params_every = log_params_every
        self.y = y
        self.N = int(y.shape[0])            # LOCAL rows (this process's shard)
        self._mp = runtime is not None and jax.process_count() > 1
        if self._mp:
            from jax.experimental import multihost_utils
            #: per-process shard lengths in process order -> global N and
            #: this process's row offset in the global stride order (the
            #: checkpointed F_prev layout)
            self._n_locals = np.asarray(multihost_utils.process_allgather(
                np.asarray(self.N, np.int64)))
            self.N_global = int(self._n_locals.sum())
            self._row_offset = int(self._n_locals[:jax.process_index()].sum())
        else:
            self._n_locals = np.asarray([self.N], np.int64)
            self.N_global = self.N
            self._row_offset = 0
        c = max(int(model.chunk), 1)
        if runtime is not None:
            if self._mp:
                # each process contributes seg_size LOCAL rows to a global
                # segment of P x seg_size; each device shard then holds
                # seg_size / n_local_shards rows, which must be whole chunks
                n_shards = int(runtime.n_data_shards)
                P_proc = jax.process_count()
                if n_shards % P_proc:
                    raise ValueError(
                        f"data shards ({n_shards}) must divide evenly "
                        f"across processes ({P_proc}) for streaming")
                c *= n_shards // P_proc
            else:
                # every device shard of a segment must be a whole number of
                # chunks, so segments round to chunk x n_data_shards
                c *= int(runtime.n_data_shards)
        # segment geometry must AGREE across processes (segments advance in
        # lockstep): derive it from the longest shard, not the local one
        N_for_seg = int(self._n_locals.max())
        seg = min(int(seg_size), max(N_for_seg, 1))
        self.seg_size = -(-seg // c) * c
        self.n_seg = -(-N_for_seg // self.seg_size)
        #: device-cache tier: when the whole dataset fits ``cache_bytes``
        #: of device memory, segments upload ONCE and are reused every
        #: iteration (the host->device stream then costs nothing after
        #: iteration 0); beyond the budget, segments roll through the
        #: two-buffer pipeline.  None/0 disables caching.
        total = self.n_seg * self.seg_size * int(y.shape[1]) * 4
        self._cache_all = bool(cache_bytes) and total <= int(cache_bytes or 0)
        self._seg_cache: Dict[int, tuple] = {}
        self.rng = jax.random.PRNGKey(seed)
        #: failure recovery (SURVEY.md §5.3/5.4, same contract as EM):
        #: periodic checkpoints carry params, the PRNG chain and F_prev so
        #: a resumed run replays the identical trajectory
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self._last_ckpt = anneal.position
        #: lagged per-datapoint free energies (host-resident, N f32)
        self.F_prev = np.zeros((self.N,), np.float32)
        if params is None:
            probe = np.asarray(y[: min(self.seg_size, self.N)], np.float32)
            params = model.standard_init({"y": probe}, seed=seed)
            if self._mp:
                # every process probed a DIFFERENT local segment; rank 0's
                # init is broadcast so parameters start replicated (the
                # SPMD-determinism invariant, parallel/mesh.py)
                from jax.experimental import multihost_utils
                params = {k: np.asarray(multihost_utils.broadcast_one_to_all(
                    np.ascontiguousarray(jax.device_get(v), np.float32)))
                    for k, v in params.items()}
        self.params = params
        self.history: list = []
        self._jits: Dict = {}

    # -- jitted pieces (cached per static flag) --------------------------------

    def _noisify(self):
        if "noisify" not in self._jits:
            self._jits["noisify"] = jax.jit(self.model.noisify)
        return self._jits["noisify"]

    def _logA(self):
        if "logA" not in self._jits:
            from prosper_tpu.core.etstep import truncated_prior_logmass

            def f(params):
                return truncated_prior_logmass(
                    self.model.log_pi_active(params), self.model.H,
                    self.model.gamma)
            self._jits["logA"] = jax.jit(f)
        return self._jits["logA"]

    def _seg_step(self, saturated: bool, first: bool):
        """(params_n, y_seg, valid_seg, F_prev_seg, sched, rng, thresh,
        ncut_on[, acc]) -> (F_seg, acc') with the weight mask built on
        device.  The running sufficient-statistic accumulator is FOLDED
        into the same dispatch (one dispatch per segment instead of
        two)."""
        key = ("seg", saturated, first)
        if key not in self._jits:
            from prosper_tpu.core.select import exact_count_mask
            from prosper_tpu.parallel.mesh import maybe_psum

            rt = self.runtime
            axis = rt.data_axis if rt is not None else None
            state_kw = {}
            if (rt is not None and "state" in rt.axis_names
                    and rt.mesh.shape["state"] > 1):
                import inspect
                if "state_axis" in inspect.signature(
                        self.model.estep_sums).parameters:
                    state_kw = {"state_axis": "state",
                                "n_state_shards": rt.mesh.shape["state"]}

            def f(params, y_seg, valid_seg, Fp_seg, sched, rng, thresh,
                  ncut_on, acc=None):
                n = valid_seg.shape[0]
                if axis is not None:
                    # per-shard partial mask, same fold as ETModel.partial_mask
                    rng_l = jax.random.fold_in(rng, jax.lax.axis_index(axis))
                else:
                    rng_l = rng
                w = jax.lax.cond(
                    sched["partial"] >= 1.0,
                    lambda: valid_seg,
                    lambda: exact_count_mask(rng_l, n, sched["partial"],
                                             valid=valid_seg))
                w = jax.lax.cond(
                    ncut_on > 0,
                    lambda: w * (Fp_seg >= thresh).astype(jnp.float32),
                    lambda: w)
                F, sums = self.model.estep_sums(params, y_seg, w, sched,
                                                saturated=saturated,
                                                **state_kw)
                # data-axis (and state-axis) reduction INSIDE the mapped fn
                # so the returned sums are replicated and the accumulator /
                # finalize stay mesh-agnostic
                sums = jax.tree_util.tree_map(
                    lambda a: maybe_psum(a, axis), sums)
                if state_kw:
                    sums = jax.tree_util.tree_map(
                        lambda a: jax.lax.psum(a, "state"), sums)
                if acc is not None:
                    sums = jax.tree_util.tree_map(jnp.add, acc, sums)
                return F, sums

            if rt is None:
                self._jits[key] = jax.jit(f)
            else:
                from jax.sharding import PartitionSpec as P
                n_in = 9 if not first else 8
                in_specs = (P(), P(axis), P(axis), P(axis),
                            P(), P(), P(), P()) + ((P(),) if not first
                                                   else ())
                assert len(in_specs) == n_in
                mapped = jax.shard_map(
                    f, mesh=rt.mesh, in_specs=in_specs,
                    out_specs=(P(axis), P()), check_vma=False)
                self._jits[key] = jax.jit(mapped)
        return self._jits[key]

    def _finalize(self):
        if "finalize" not in self._jits:
            def f(params, sums, N_total):
                return self.model.finalize_mstep(params, sums, N_total)
            self._jits["finalize"] = jax.jit(f)
        return self._jits["finalize"]

    # -- segment plumbing -------------------------------------------------------

    def _host_segment(self, k: int):
        """(y_seg (seg_size, D) f32 host, valid (seg_size,), lo, n_real) —
        the tail segment zero-pads to the static shape (valid=0 rows).
        Multi-process: segments past this process's shard are pure padding
        (a shorter shard still dispatches every lockstep segment)."""
        lo = k * self.seg_size
        hi = min(lo + self.seg_size, self.N)
        n_real = max(hi - lo, 0)
        if n_real > 0:
            y_seg = np.asarray(self.y[lo:hi], np.float32)
        else:
            y_seg = np.zeros((0, int(self.y.shape[1])), np.float32)
        if n_real < self.seg_size:
            y_seg = np.pad(y_seg, ((0, self.seg_size - n_real), (0, 0)))
        valid = np.zeros((self.seg_size,), np.float32)
        valid[:n_real] = 1.0
        return y_seg, valid, lo, n_real

    def _dev_put(self, a):
        if self.runtime is not None:
            # multi-process aware placement: local rows assemble into the
            # global data-sharded array (MeshRuntime._put dispatches to
            # make_array_from_process_local_data when P > 1)
            return self.runtime._put(a, self.runtime.data_sharding())
        return jax.device_put(a)

    def _local_rows(self, a) -> np.ndarray:
        """This process's rows of a (possibly cross-process) data-sharded
        array — the local device shards in global row order (the inverse of
        the ``_dev_put`` assembly)."""
        if not self._mp:
            return np.asarray(jax.device_get(a))
        shards = sorted(a.addressable_shards,
                        key=lambda s: (s.index[0].start or 0))
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    def _put(self, k: int, need_fp: bool):
        if k in self._seg_cache:
            (y_dev, v_dev), lo, n_real = self._seg_cache[k]
        else:
            y_seg, valid, lo, n_real = self._host_segment(k)
            y_dev = self._dev_put(y_seg)
            v_dev = self._dev_put(valid)
            if self._cache_all:
                self._seg_cache[k] = ((y_dev, v_dev), lo, n_real)
        # F_prev re-uploads only while the Ncut threshold consumes it —
        # when the cut is off this iteration a reused device zeros buffer
        # stands in (the jit signature stays fixed; 2x fewer host->device
        # transfers per segment in the pre-Ncut phase)
        if need_fp:
            fp = self.F_prev[lo:lo + n_real]
            if n_real != self.seg_size:
                fp = np.pad(fp, (0, self.seg_size - n_real))
            fp_dev = self._dev_put(fp)
        else:
            if "zeros_fp" not in self._jits:
                self._jits["zeros_fp"] = self._dev_put(
                    np.zeros((self.seg_size,), np.float32))
            fp_dev = self._jits["zeros_fp"]
        return (y_dev, v_dev, fp_dev), lo, n_real

    # -- the drivers ------------------------------------------------------------

    def step_once(self, verbose: bool = False) -> Dict:
        t0 = time.perf_counter()
        fl = sched_floats(self.anneal)
        sched = {k: jnp.float32(v) for k, v in fl.items()}
        saturated = (fl.get("beta", 1.0) == 1.0
                     and fl.get("prior_beta", 1.0) == 1.0)

        self.rng, sub = jax.random.split(self.rng)
        rng_noise, rng_partial = jax.random.split(sub)   # mirror step_fn
        params_n = self._noisify()(self.params, sched, rng_noise)

        # global Ncut threshold from the host-resident lagged F (see module
        # docstring); keep_count needs the truncated prior mass A_gamma
        ncut_on = fl["Ncut_factor"] > 0.0
        if ncut_on:
            logA = float(self._logA()(params_n)[0])
            A = np.exp(np.float32(logA))
            frac = 1.0 - (1.0 - A) * np.float32(fl["Ncut_factor"])
            keep = float(np.ceil(np.float32(frac)
                                 * np.float32(self.N_global)))
            thresh = host_quantile_threshold(
                self.F_prev, np.ones((self.N,), np.float32), keep,
                allreduce=_process_allreduce if self._mp else None)
        else:
            thresh = float("-inf")

        # the lagged F only needs maintaining while something consumes it:
        # the NEXT iteration's Ncut threshold (peeked from the schedule)
        pos = self.anneal.position
        try:
            self.anneal.position = min(pos + 1, self.anneal.steps - 1)
            need_F = float(sched_floats(self.anneal)["Ncut_factor"]) > 0.0
        finally:
            self.anneal.position = pos

        acc = None
        F_parts = []
        nxt, nxt_lo, nxt_n = self._put(0, ncut_on)
        for k in range(self.n_seg):
            cur, lo, n_real = nxt, nxt_lo, nxt_n
            if k + 1 < self.n_seg:
                # upload k+1 while k computes (async dispatch order)
                nxt, nxt_lo, nxt_n = self._put(k + 1, ncut_on)
            rk = jax.random.fold_in(rng_partial, k)
            args = (params_n, cur[0], cur[1], cur[2], sched, rk,
                    jnp.float32(thresh), jnp.int32(1 if ncut_on else 0))
            if acc is None:
                F_seg, acc = self._seg_step(saturated, True)(*args)
            else:
                F_seg, acc = self._seg_step(saturated, False)(*args, acc)
            F_parts.append((lo, n_real, F_seg))

        new_params, scalars = self._finalize()(
            params_n, acc, jnp.float32(self.N_global))
        self.params = new_params
        if need_F:
            if self._mp:
                # per-segment local-shard extraction (each process owns only
                # its own rows of the global F; segments past the local
                # shard are pure padding, n_real = 0)
                for lo, n_real, f in F_parts:
                    if n_real > 0:
                        self.F_prev[lo:lo + n_real] = \
                            self._local_rows(f)[:n_real]
            else:
                # ONE host fetch per iteration, not one per segment
                F_all = np.asarray(jax.device_get(jnp.concatenate(
                    [f for _, _, f in F_parts])))
                off = 0
                for lo, n_real, _ in F_parts:
                    self.F_prev[lo:lo + n_real] = F_all[off:off + n_real]
                    off += self.seg_size

        scalars = {k: float(jax.device_get(v)) for k, v in scalars.items()}
        scalars["iteration"] = self.anneal.position
        scalars["dt"] = time.perf_counter() - t0
        self.history.append(scalars)
        if self.dlog is not None:
            rec = dict(scalars)
            big = self.log_params_every and (
                self.anneal.position % self.log_params_every == 0)
            for k, v in self.params.items():
                arr = np.asarray(jax.device_get(v))
                if arr.ndim <= 1 or big:
                    rec[k] = arr
            self.dlog.append_all(rec)
        if verbose:
            from prosper_tpu.parallel.mesh import pprint
            pprint(f"[stream-em] iter {self.anneal.position:4d} "
                  f"F/N={scalars['F_mean']:+.4f} "
                  f"n_used={scalars['n_used']:.0f} "
                  f"segs={self.n_seg} dt={scalars['dt']*1e3:.0f}ms")
        self.anneal.next()
        self._maybe_checkpoint()
        return scalars

    def _global_F_prev(self) -> np.ndarray:
        """The global lagged-F array in stride order (multi-process:
        process_allgather of the per-process host slices — a collective,
        every process must call together)."""
        if not self._mp:
            return self.F_prev
        from jax.experimental import multihost_utils
        maxlen = int(self._n_locals.max())
        buf = np.zeros((maxlen,), np.float32)
        buf[:self.N] = self.F_prev
        g = np.asarray(multihost_utils.process_allgather(buf))   # (P, maxlen)
        return np.concatenate([g[p, :int(n)]
                               for p, n in enumerate(self._n_locals)])

    def _maybe_checkpoint(self) -> None:
        if (self.checkpoint_path and self.checkpoint_every
                and self.anneal.position - self._last_ckpt
                >= self.checkpoint_every):
            self._last_ckpt = self.anneal.position
            from prosper_tpu.io import checkpoint
            # rank 0 writes (checkpoint.save gates); the F_prev payload is
            # the GLOBAL stride-ordered array so any process layout with
            # the same shard bounds can resume
            checkpoint.save(self.checkpoint_path, self.params,
                            step=self.anneal.position, rng=self.rng,
                            extra={"F_prev": self._global_F_prev()})

    def resume(self, path: str) -> int:
        """Restore params/rng/F_prev from a checkpoint and fast-forward the
        anneal; returns the restored step.  The continued run replays the
        uninterrupted trajectory (same PRNG chain, same lagged-Ncut
        ranking input)."""
        from prosper_tpu.io import checkpoint
        params, step, rng, extra = checkpoint.restore_full(path)
        self.params = params
        if rng is not None:
            self.rng = rng
        fp = extra.get("F_prev")
        if fp is not None:
            if self._mp and fp.shape[0] == self.N_global:
                # checkpoint holds the global stride-ordered F; this
                # process's slice starts at its stride offset (resume
                # requires the same process count / shard bounds as save)
                self.F_prev[:] = fp[self._row_offset:
                                    self._row_offset + self.N]
            elif fp.shape[0] == self.N:
                self.F_prev[:] = fp
        step = min(int(step), self.anneal.steps)
        self.anneal.reset(step)
        self._last_ckpt = step
        return step

    def run(self, verbose: bool = False) -> Dict:
        while not self.anneal.finished:
            self.step_once(verbose=verbose)
        return self.params
