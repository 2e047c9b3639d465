"""Host-side enumeration of truncated latent-state spaces.

Expectation Truncation (Lücke & Eggert, JMLR 2010) replaces the sum over all
latent configurations by a sum over a *truncated* set per datapoint:

    T_n = { 0 }  ∪  { singletons over ALL H units }
              ∪  { states over the H' candidate units with 2 <= |support| <= gamma }

The third part is a *static* enumeration over candidate slots that is shared
by every datapoint (only the candidate -> global-unit mapping differs).  We
precompute it once on the host as small numpy arrays which are then closed
over by the jitted E-step (static shapes — essential for XLA).

Reference behavior: SURVEY.md §2 "ET base (CAModel)" — the reference builds
`state_matrix` / `state_abs` in `prosper/em/camodels/__init__.py` (mount
unavailable; behavior-level parity).

All models with pointwise-linear or max superposition share these:
  * binary   states: values in {0,1}        (BSC, GSC supports, MCA, MMCA)
  * ternary  states: values in {-1,0,+1}    (TSC)
  * discrete states: values in {0} ∪ Phi    (DSC, generalises both)

If the C++ accelerator extension (native/enumerate.cpp) is built it is used
for very large spaces; the numpy path is the reference implementation.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from math import comb

import numpy as np


@dataclass(frozen=True)
class StateSpace:
    """Static enumeration of multi-active states over H' candidate slots.

    Attributes
    ----------
    states : (S, Hp) float32 — latent values per state and candidate slot.
    abs_states : (S,) float32 — number of active (non-zero) units per state.
    value_counts : (S, K) float32 — per-state count of each non-zero value
        ``values[k]`` (used for discrete priors; for binary this is just
        ``abs_states[:, None]``).
    values : (K,) float32 — the non-zero latent values.
    outer : (S, Hp*Hp) float32 — flattened per-state outer products s s^T,
        precomputed so that <s s^T> accumulation is a plain GEMM.
    """

    states: np.ndarray
    abs_states: np.ndarray
    value_counts: np.ndarray
    values: np.ndarray
    outer: np.ndarray

    @property
    def S(self) -> int:
        return int(self.states.shape[0])

    @property
    def Hp(self) -> int:
        return int(self.states.shape[1])

    @property
    def K(self) -> int:
        return int(self.values.shape[0])


def n_multi_states(Hp: int, gamma: int, n_values: int = 1, min_active: int = 2) -> int:
    """Exact size of the enumerated multi-active space: sum_k C(Hp,k) * K^k."""
    return sum(comb(Hp, k) * (n_values ** k) for k in range(min_active, gamma + 1))


def _load_native():
    """ctypes binding to native/libprosper_enum.so (optional accelerator)."""
    import ctypes
    import os
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libprosper_enum.so"),
                 os.path.join(os.path.dirname(here), "native",
                              "libprosper_enum.so")):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                return None
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.prosper_enum_count.restype = ctypes.c_int64
            lib.prosper_enum_count.argtypes = [ctypes.c_int32] * 4
            lib.prosper_enum_fill.restype = ctypes.c_int64
            lib.prosper_enum_fill.argtypes = (
                [ctypes.c_int32] * 4 + [f32p] * 5)
            return lib
    return None


_NATIVE = None
_NATIVE_CHECKED = False


def _native_lib():
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE = _load_native()
        _NATIVE_CHECKED = True
    return _NATIVE


def discrete_state_space(
    Hp: int,
    gamma: int,
    values,
    min_active: int = 2,
    dtype=np.float32,
    use_native: bool = True,
    native_min_states: int = 4096,
) -> StateSpace:
    """Enumerate all states over Hp slots with min_active..gamma active units,
    each active unit taking one of the given non-zero ``values``.

    Ordering is deterministic: by support size, then lexicographic support,
    then lexicographic value assignment — so trajectories are reproducible.

    When native/libprosper_enum.so is built (native/build.sh) and the space
    is large, enumeration runs in C++ (same ordering contract); the numpy
    path below is the reference implementation and always available.
    """
    values = np.asarray(values, dtype=dtype)
    if values.ndim != 1 or values.size == 0:
        raise ValueError("values must be a non-empty 1-D array of non-zero latent values")
    if np.any(values == 0):
        raise ValueError("values must be the NON-zero latent values (0 is implicit)")
    if not (0 <= min_active <= gamma <= Hp):
        raise ValueError(f"need 0 <= min_active <= gamma <= Hp, got {min_active=} {gamma=} {Hp=}")

    K = values.size
    S = n_multi_states(Hp, gamma, K, min_active)

    lib = _native_lib() if (use_native and dtype == np.float32) else None
    if lib is not None and S >= native_min_states:
        import ctypes
        states = np.zeros((S, Hp), np.float32)
        value_counts = np.zeros((S, K), np.float32)
        abs_states = np.zeros((S,), np.float32)
        outer = np.zeros((S, Hp * Hp), np.float32)
        vals32 = np.ascontiguousarray(values, np.float32)
        p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lib.prosper_enum_fill(Hp, gamma, K, min_active, p(vals32),
                                  p(states), p(value_counts), p(abs_states),
                                  p(outer))
        if n == S:
            return StateSpace(states=states, abs_states=abs_states,
                              value_counts=value_counts, values=values,
                              outer=outer)
        # fall through to the numpy reference path on any mismatch

    states = np.zeros((S, Hp), dtype=dtype)
    value_counts = np.zeros((S, K), dtype=dtype)
    i = 0
    for k in range(min_active, gamma + 1):
        for support in itertools.combinations(range(Hp), k):
            for assignment in itertools.product(range(K), repeat=k):
                for slot, vidx in zip(support, assignment):
                    states[i, slot] = values[vidx]
                    value_counts[i, vidx] += 1
                i += 1
    assert i == S, (i, S)

    abs_states = (states != 0).sum(axis=1).astype(dtype)
    outer = np.einsum("sh,sk->shk", states, states).reshape(S, Hp * Hp).astype(dtype)
    return StateSpace(states=states, abs_states=abs_states, value_counts=value_counts,
                      values=values, outer=outer)


def slot_value_onehot(space: StateSpace) -> np.ndarray:
    """(S, Hp, K) indicator: slot ``a`` of state ``s`` carries ``values[k]``.

    This factors the value-ASSIGNMENT structure (static combinatorics) out of
    the value MAGNITUDES, so a learned value set Phi (DSC ``to_learn``
    containing "phi") can rebuild ``states = onehot @ phi`` as a traced
    function of the parameter vector (SURVEY.md §2 "DSC-ET": Phi "optionally
    learned").
    """
    vals = space.values
    if np.unique(vals).size != vals.size:
        raise ValueError("values must be distinct to recover slot indicators")
    return ((space.states[:, :, None] == vals[None, None, :])
            & (space.states[:, :, None] != 0)).astype(np.float32)


def binary_state_space(Hp: int, gamma: int, min_active: int = 2) -> StateSpace:
    """Binary {0,1} states (BSC / GSC supports / MCA / MMCA)."""
    return discrete_state_space(Hp, gamma, values=[1.0], min_active=min_active)


def ternary_state_space(Hp: int, gamma: int, min_active: int = 2) -> StateSpace:
    """Ternary {-1,0,+1} states (TSC)."""
    return discrete_state_space(Hp, gamma, values=[-1.0, 1.0], min_active=min_active)
