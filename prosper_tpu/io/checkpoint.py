"""Explicit checkpoint/resume.

Reference behavior: SURVEY.md §5.4 — the reference has no dedicated
checkpoint API; every EM iteration appends full (W, pi, sigma, Q) rows to
the result HDF5, and "resume" = load the last row and rebuild the anneal at
an offset.  This module provides both:

  * ``save / restore``: an explicit (params, step, rng) checkpoint file
    (h5-based, no orbax dependency needed for these tiny models),
  * ``resume_from_h5``: reconstruct (params, step) from a StoreToH5/AutoTable
    result file, i.e. the reference's implicit mechanism.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from prosper_tpu.io import import_h5py


def save(path: str, params: Dict, step: int, rng=None,
         extra: Optional[Dict] = None) -> None:
    """Write a checkpoint (process 0 only; params are replicated)."""
    if jax.process_index() != 0:
        return
    h5py = import_h5py()
    params = jax.device_get(params)
    with h5py.File(path, "w") as f:
        f.attrs["step"] = int(step)
        g = f.create_group("params")
        for k, v in params.items():
            g.create_dataset(k, data=np.asarray(v))
        if rng is not None:
            f.create_dataset("rng", data=np.asarray(jax.device_get(rng)))
        if extra:
            ge = f.create_group("extra")
            for k, v in extra.items():
                ge.create_dataset(k, data=np.asarray(v))


def restore(path: str) -> Tuple[Dict, int, Optional[jax.Array]]:
    """Load (params, step, rng-or-None) from a checkpoint file."""
    params, step, rng, _ = restore_full(path)
    return params, step, rng


def restore_full(path: str) -> Tuple[Dict, int, Optional[jax.Array], Dict]:
    """Load (params, step, rng-or-None, extra) from a checkpoint file.

    ``extra`` carries auxiliary state needed for trajectory-faithful resume
    (e.g. the previous iteration's per-datapoint free energies F_prev, which
    drive the Ncut mask)."""
    h5py = import_h5py()
    with h5py.File(path, "r") as f:
        step = int(f.attrs["step"])
        params = {k: jnp.asarray(np.asarray(v)) for k, v in f["params"].items()}
        rng = None
        if "rng" in f:
            rng = jnp.asarray(np.asarray(f["rng"]), dtype=jnp.uint32)
        extra = {}
        if "extra" in f:
            extra = {k: np.asarray(v) for k, v in f["extra"].items()}
    return params, step, rng, extra


def resume_from_h5(path: str, param_names=("W", "pi", "sigma"),
                   row: int = -1) -> Tuple[Dict, int]:
    """Reference-style resume: read row ``row`` of a per-iteration result
    table written by StoreToH5 and return (params, step)."""
    h5py = import_h5py()
    with h5py.File(path, "r") as f:
        params = {}
        n_rows = None
        for name in param_names:
            if name not in f:
                raise KeyError(f"{name!r} not found in {path}")
            ds = f[name]
            n_rows = ds.shape[0]
            params[name] = jnp.asarray(np.asarray(ds[row]))
        step = row if row >= 0 else n_rows + row
    return params, step
