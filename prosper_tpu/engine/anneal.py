"""Annealing schedules for EM training.

Behavior-parity target: SURVEY.md §2 "Annealing" — the reference's
``prosper/em/annealing.py :: LinearAnnealing`` (mount unavailable): a
piecewise-linear schedule container indexed like a dict, with named channels

    anneal['T']            temperature on the log-pseudo-joint (beta = 1/T)
    anneal['Ncut_factor']  ramp for best-explained data sub-selection
    anneal['partial']      random data sub-sampling fraction
    anneal['W_noise'], anneal['pi_noise'], anneal['sigma_noise']
                           parameter jitter std-devs
    anneal['anneal_prior'] whether the prior term is temperature-scaled

Schedule spec: a plain scalar (constant) or a list of (position, value)
breakpoints, where position is either a fraction in [0,1] of the total steps
or an absolute iteration index (ints > 1).  Values are linearly interpolated
between breakpoints and clamped outside.

Every channel is returned as a *scalar* and passed into the jitted
EM step as a traced argument, so changing annealing values never triggers a
recompile (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

Spec = Union[float, int, bool, List[Tuple[float, float]]]

_DEFAULTS: Dict[str, Spec] = {
    "T": 1.0,
    "Ncut_factor": 0.0,
    "partial": 1.0,
    "W_noise": 0.0,
    "pi_noise": 0.0,
    "sigma_noise": 0.0,
    "mu_noise": 0.0,
    "anneal_prior": False,
}


class LinearAnnealing:
    """Piecewise-linear annealing over a fixed number of EM iterations."""

    def __init__(self, steps: int):
        if steps < 1:
            raise ValueError("steps must be >= 1")
        self.steps = int(steps)
        self.position = 0
        self._specs: Dict[str, Spec] = dict(_DEFAULTS)

    # -- schedule definition -------------------------------------------------

    def __setitem__(self, name: str, spec: Spec) -> None:
        if isinstance(spec, (list, tuple)):
            pts = [(float(p), float(v)) for p, v in spec]
            if not pts:
                raise ValueError(f"empty schedule for {name!r}")
            pts.sort(key=lambda pv: pv[0])
            self._specs[name] = pts
        else:
            self._specs[name] = spec

    # -- evaluation ----------------------------------------------------------

    def _abs_pos(self, p: float) -> float:
        """Breakpoint position: fraction of total steps if in [0,1], else an
        absolute iteration index."""
        return p * (self.steps - 1) if 0.0 <= p <= 1.0 else p

    def value_at(self, name: str, step: int):
        spec = self._specs.get(name)
        if spec is None:
            raise KeyError(name)
        if isinstance(spec, bool):
            return spec
        if not isinstance(spec, list):
            return float(spec)
        # map to absolute positions FIRST, then sort: a spec mixing
        # fractional and absolute breakpoints (e.g. [(0.9, 5.0), (5, 1.0)])
        # is ordered differently in raw-spec space than in iteration space,
        # and interpolating over a non-monotone point list silently drops
        # breakpoints
        pts = sorted(((self._abs_pos(p), v) for p, v in spec),
                     key=lambda pv: pv[0])
        x = float(step)
        if x <= pts[0][0]:
            return pts[0][1]
        if x >= pts[-1][0]:
            return pts[-1][1]
        for (x0, v0), (x1, v1) in zip(pts[:-1], pts[1:]):
            if x0 <= x <= x1:
                if x1 == x0:
                    return v1
                t = (x - x0) / (x1 - x0)
                return v0 + t * (v1 - v0)
        return pts[-1][1]  # unreachable

    def __getitem__(self, name: str):
        return self.value_at(name, self.position)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    # -- iteration -----------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.position >= self.steps

    def next(self) -> None:
        if self.finished:
            raise StopIteration("annealing schedule exhausted")
        self.position += 1

    def reset(self, position: int = 0) -> None:
        """Rewind / fast-forward (checkpoint resume support)."""
        if not 0 <= position <= self.steps:
            raise ValueError(f"position {position} outside [0, {self.steps}]")
        self.position = position

    def as_scalars(self) -> Dict[str, float]:
        """Snapshot of every channel at the current position, as plain floats
        suitable for passing into a jitted step without recompilation."""
        out = {}
        for name in self._specs:
            out[name] = float(self[name])
        out["beta"] = 1.0 / max(out.get("T", 1.0), 1e-6)
        out["step"] = float(self.position)
        out["max_step"] = float(self.steps)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"LinearAnnealing(steps={self.steps}, position={self.position})"
