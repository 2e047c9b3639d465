"""Reference-equivalent NumPy implementations (the parity/benchmark oracle).

The upstream ProSper library is pure NumPy/BLAS + mpi4py (SURVEY.md §0).
This subpackage hosts a faithful single-process NumPy float64 EM for the
linear ET family, used for:

  * trajectory comparisons against the jitted path (free-energy
    trajectories must match "within Monte-Carlo/seed error"),
  * the float64 oracle of chip_smoke.py's patches-width step,
  * the bench.py speed baseline (same algorithm on the host CPU),
  * debugging numerical drift (float64 ground truth).

It is intentionally written in the reference's style (materialised
candidate gathers, explicit reconstructions) — NOT the jitted formulation —
so it is an independent check, not a transcription of the production path.
"""

from prosper_tpu.reference.numpy_em import NumpyBSC, numpy_em_run

__all__ = ["NumpyBSC", "numpy_em_run"]
