"""Device-mesh runtime: the replacement of the reference's MPI layer.

Reference behavior: SURVEY.md §2 "MPI helpers" — ``prosper/utils/parallel.py``
provides ``pprint`` (rank-0 print), ``stride_data`` (per-rank shard bounds)
and allreduce wrappers over ``mpi4py``; each model's M-step allreduces summed
sufficient statistics (SURVEY.md §3.1).

Design: one mesh axis ``'data'`` spans every device (XLA picks the
collective algorithm; on GPUs it hands collectives to NCCL).  The EM step
runs under ``shard_map`` with the data shard partitioned over 'data' and the
parameters replicated; sufficient statistics are ``lax.psum``'d, after which
every device computes the identical closed-form M-step (SPMD determinism, the
same property the reference relies on).

Everything here also works with no mesh at all (axis_name=None): the
``maybe_*`` collectives become identity, so a single-device run pays zero
overhead and model code is written once.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


# ---------------------------------------------------------------------------
# Collective wrappers that degrade to identity outside shard_map
# ---------------------------------------------------------------------------

def maybe_psum(x, axis_name: Optional[str]):
    """Sum over the mesh axis; identity if axis_name is None (single device)."""
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def maybe_pmax(x, axis_name: Optional[str]):
    return x if axis_name is None else jax.lax.pmax(x, axis_name)


def maybe_pmin(x, axis_name: Optional[str]):
    return x if axis_name is None else jax.lax.pmin(x, axis_name)


# ---------------------------------------------------------------------------
# Host-side helpers (reference: pprint / stride_data)
# ---------------------------------------------------------------------------

def pprint(*args, **kwargs) -> None:
    """Print only on process 0 (reference: utils/parallel.py::pprint)."""
    if jax.process_index() == 0:
        print(*args, **kwargs)


def stride_data(N: int, parts: Optional[int] = None, index: Optional[int] = None
                ) -> Tuple[int, int]:
    """(first, last) bounds of this process's contiguous shard of N datapoints.

    Reference: utils/parallel.py::stride_data.  With JAX multi-host, each
    process loads only its own slice of the dataset from disk; the device
    mesh then shards the in-memory slice further across local chips.
    """
    parts = jax.process_count() if parts is None else parts
    index = jax.process_index() if index is None else index
    base, rem = divmod(N, parts)
    first = index * base + min(index, rem)
    last = first + base + (1 if index < rem else 0)
    return first, last


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialise JAX multi-host (the ``mpirun -n P`` analogue).

    Thin wrapper over ``jax.distributed.initialize`` — on managed
    clusters the arguments may be auto-detected; elsewhere pass them
    explicitly.  MUST be called before anything touches a JAX backend
    (importantly: before ``jax.devices()`` / ``jax.process_count()`` /
    any jnp op — initialising a backend first makes distributed setup
    impossible).  Explicitly-requested multi-host setups fail loudly;
    only the auto-detect single-process case degrades silently.
    """
    explicit = coordinator_address is not None or num_processes is not None
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise RuntimeError(
                "multi-host initialisation failed — note that "
                "jax.distributed.initialize must run before any JAX backend "
                f"is touched: {e}") from e
        # auto-detect found no cluster: single-process run


def replication_error(tree, axis_name: str):
    """Max absolute divergence of a pytree across the shards of a mesh axis
    (use inside shard_map).  The reference relies on MPI SPMD determinism
    for parameter replication (SURVEY.md §5.2); this turns the property into
    a measurable invariant: return it from the step in debug runs and assert
    it is tiny host-side.  Note: all-reduce algorithms (ring) may apply a
    different reduction order per participant, so expect float-epsilon-level
    divergence, not exact zero — the same caveat applies to MPI_Allreduce.
    """
    n = jax.lax.psum(1, axis_name)
    errs = []
    for x in jax.tree_util.tree_leaves(tree):
        x = jnp.asarray(x, jnp.float32)
        mean = jax.lax.psum(x, axis_name) / n
        errs.append(jnp.max(jnp.abs(x - mean)))
    return jnp.max(jnp.stack(errs)) if errs else jnp.float32(0.0)


# ---------------------------------------------------------------------------
# Mesh runtime
# ---------------------------------------------------------------------------

class MeshRuntime:
    """Owns the device mesh and wraps an EM step for data-parallel execution.

    ``axis`` is the data-parallel axis.  An optional ``state`` axis (for
    sharding huge enumerated-state spaces, SURVEY.md §5.7) can be added by
    passing ``mesh_shape=(n_data, n_state)``.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 axis_names: Tuple[str, ...] = ("data",)):
        import numpy as np
        devices = list(jax.devices()) if devices is None else list(devices)
        if mesh_shape is None:
            mesh_shape = (len(devices),) + (1,) * (len(axis_names) - 1)
        self.mesh = Mesh(np.array(devices).reshape(mesh_shape), axis_names)
        self.axis_names = axis_names
        self.data_axis = axis_names[0]

    @property
    def n_data_shards(self) -> int:
        return self.mesh.shape[self.data_axis]

    def data_sharding(self) -> NamedSharding:
        """Sharding for arrays whose leading dim is the datapoint axis."""
        return NamedSharding(self.mesh, P(self.data_axis))

    def replicated_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def _put(self, a, sh: NamedSharding):
        """Place ``a`` with sharding ``sh``; multi-process aware.

        With more than one process (SURVEY.md §5.8: the ``mpirun -n P``
        analogue), each process holds only its *local* slice of the global
        array (loaded via ``stride_data`` bounds), so placement goes through
        ``jax.make_array_from_process_local_data``.  Arrays that already
        carry the requested sharding pass through untouched.
        """
        import numpy as np
        if (isinstance(a, jax.Array) and isinstance(a.sharding, NamedSharding)
                and a.sharding.mesh == self.mesh
                and a.sharding.spec == sh.spec):
            return a
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(sh, np.asarray(a))
        return jax.device_put(a, sh)

    def shard_data(self, tree):
        """Place a pytree of datapoint-leading arrays sharded over 'data'.

        Single-process: arrays are global and N must be divisible by the
        number of data shards (pad upstream with the data loader's
        static-shape padding if not).  Multi-process: each process passes
        its process-local rows (``stride_data`` slice) and the global array
        is assembled across processes.
        """
        sh = self.data_sharding()
        return jax.tree_util.tree_map(lambda a: self._put(a, sh), tree)

    def replicate(self, tree):
        """Replicate a pytree onto every device (all processes pass the
        identical value in the multi-process case)."""
        sh = self.replicated_sharding()
        return jax.tree_util.tree_map(lambda a: self._put(a, sh), tree)

    def shard_decode(self, infer_fn):
        """Data-parallel serving: wrap a posterior-decode builder
        ``infer_fn(y, params, beta, prior_beta) -> dict`` in shard_map over
        the data axis and jit it.  Decode is embarrassingly parallel per
        datapoint (SURVEY.md §3.3), so outputs shard like the input rows;
        params/scalars are replicated.  N must divide the data-shard count
        (pad upstream with the loaders' static-shape padding)."""
        mapped = jax.shard_map(
            infer_fn, mesh=self.mesh,
            in_specs=(P(self.data_axis), P(), P(), P()),
            out_specs=P(self.data_axis), check_vma=False)
        return jax.jit(mapped)

    def shard_step(self, step_fn):
        """Wrap ``step_fn(params, data, sched, rng) -> (params, F, scalars)``
        in shard_map over the data axis (plus the state axis when the mesh
        has one) and jit it.

        * params, sched, rng: replicated
        * data (and the returned per-datapoint F): sharded on the leading axis
        * params/scalars outputs: replicated — the M-step inside step_fn
          psums suff stats over ``axis_name`` so all shards compute the
          identical closed-form update (SPMD determinism, mirroring the
          reference's allreduce + replicated M-step).

        With a ('data','state') mesh (axis_names=('data','state') and
        state size > 1), the enumerated-state dimension of supporting models
        is additionally sharded over 'state' — SURVEY.md §5.7's
        sequence-parallel analogue (ring-attention-style online-logsumexp
        combine).
        """
        import inspect
        axis = self.data_axis
        kw = {"axis_name": axis}
        if "state" in self.axis_names and self.mesh.shape["state"] > 1:
            # only models whose step supports state sharding get the kwargs;
            # others run state-replicated (each state-shard redundantly
            # computes the same psum'd result — correct, just not faster)
            sig = inspect.signature(step_fn)
            if "state_axis" in sig.parameters:
                kw["state_axis"] = "state"
                kw["n_state_shards"] = self.mesh.shape["state"]
        fn = partial(step_fn, **kw)
        in_specs = (P(), P(axis), P(), P())
        out_specs = (P(), P(axis), P())
        mapped = jax.shard_map(
            fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(mapped, donate_argnums=(0,))
