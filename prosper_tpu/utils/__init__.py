"""Misc utilities (reference: prosper/utils/__init__.py — SURVEY.md §2)."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, Optional

import jax

#: the checkout (or install prefix) this package was loaded from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    The one rule every entry point applies: when ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it and no other directory is set here.  Otherwise the
    cache lives in ``.jax_cache`` at the root of the checkout (listed in
    ``.gitignore``) — a fixed path, because the path is part of the cache's
    key and a directory that moves never hits.  Call before the first
    compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_device_info() -> Dict:
    """The GPU this process measures on: JAX's ``platform``, ``kind`` and
    ``count``, and each card's name and power limit as ``nvidia-smi``
    reports them (``cards``).  Raises RuntimeError when JAX's default
    backend is not a GPU — a measurement never falls back to the CPU."""
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {dev[0].platform!r}; this "
            "measurement runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev),
            "cards": [ln.strip() for ln in smi.stdout.splitlines()
                      if ln.strip()]}


def create_output_path(basename: Optional[str] = None,
                       root: str = "output") -> str:
    """Create a timestamped results directory (process 0 creates, all agree).

    Reference: utils.create_output_path — timestamped results dirs
    (SURVEY.md §2 "Misc utils").
    """
    if basename is None:
        basename = os.path.splitext(os.path.basename(sys.argv[0]))[0] or "run"
    stamp = time.strftime("%Y-%m-%d+%H:%M")
    path = os.path.join(root, f"{basename}.{stamp}")
    # Only process 0 walks the collision-suffix sequence and creates the
    # directory; the return value is authoritative ONLY on process 0 (a
    # shared-FS existence walk on other ranks races with the mkdir).  File
    # writers are rank-0-only throughout (DataLog handlers, checkpoints),
    # matching the reference's rank-0 file ownership; rank>0 callers that
    # need the real path must receive it via their own coordination.
    if jax.process_index() != 0:
        return path
    suffix = 0
    final = path
    while os.path.exists(final):
        suffix += 1
        final = f"{path}.{suffix:03d}"
    os.makedirs(final, exist_ok=True)
    return final
