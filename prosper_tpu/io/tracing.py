"""Lightweight tracepoints + jax.profiler integration.

Reference behavior: SURVEY.md §2 "Tracing" — ``prosper/utils/tracing.py``
(mount unavailable): manual named tracepoints with timestamps per rank
written to a trace file; enabled from scripts.

Additions: ``profile_trace`` wraps ``jax.profiler.trace`` so a
TensorBoard/Perfetto device trace can be captured around any region
(SURVEY.md §5.1), and tracepoints are annotated into the device timeline via
``jax.profiler.TraceAnnotation`` when a profile is active.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

_tracefile = None
_t0 = None


def set_tracefile(path: Optional[str]) -> None:
    """Enable (path) or disable (None) host-side tracepoint logging.

    The %d in the path, if present, is replaced by the process index
    (the reference writes one trace file per MPI rank).
    """
    global _tracefile, _t0
    if _tracefile is not None:
        _tracefile.close()
        _tracefile = None
    if path is not None:
        if "%d" in path:
            path = path % jax.process_index()
        _tracefile = open(path, "a")
        _t0 = time.perf_counter()


def tracepoint(name: str) -> None:
    """Record a named timestamped event (no-op unless set_tracefile called)."""
    if _tracefile is not None:
        dt = time.perf_counter() - _t0
        _tracefile.write(f"{dt:12.6f} p{jax.process_index()} {name}\n")
        _tracefile.flush()


@contextlib.contextmanager
def traced_region(name: str):
    """Tracepoint pair + device-timeline annotation around a region."""
    tracepoint(f"{name} begin")
    with jax.profiler.TraceAnnotation(name):
        yield
    tracepoint(f"{name} end")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard `Profile` / Perfetto)."""
    with jax.profiler.trace(logdir):
        yield
