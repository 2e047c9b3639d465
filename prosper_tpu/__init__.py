"""prosper-tpu: a framework for Expectation-Truncation variational EM in JAX.

A ground-up JAX / jit / shard_map re-design of the capabilities of
the reference library ``ml-uol/prosper`` (ProSper): sparse-coding latent
variable models (BSC, ternary SC, discrete SC, spike-and-slab/Gaussian SC,
maximal-causes MCA/MMCA, and mixture models) trained with variational EM where
the posterior is approximated by Expectation Truncation (ET):

* per-datapoint candidate-latent preselection (top-H' affinity),
* exhaustive enumeration of truncated latent-state combinations,
* temperature-annealed log-pseudo-joint evaluation with stabilised
  logsumexp posteriors,
* sufficient-statistic accumulation and closed-form M-steps,
* data parallelism over a ``jax.sharding.Mesh`` with ``psum`` of sufficient
  statistics (the analogue of the reference's mpi4py allreduce).

It runs on NVIDIA GPUs and on the CPU.  The code was first written for a
TPU; the package name is historical.

Reference parity pointers (reference mount unavailable this round — see
SURVEY.md provenance warning; citations are to SURVEY.md section/row):
  - EM engine            -> SURVEY.md §2 "EM engine"   (prosper/em/__init__.py)
  - Annealing            -> SURVEY.md §2 "Annealing"   (prosper/em/annealing.py)
  - ET base (CAModel)    -> SURVEY.md §2 "ET base"     (prosper/em/camodels/__init__.py)
  - Model zoo            -> SURVEY.md §2 BSC/TSC/DSC/GSC/MCA/MMCA rows
  - MPI helpers          -> SURVEY.md §2 "MPI helpers" (prosper/utils/parallel.py)
  - DataLog/AutoTable    -> SURVEY.md §2 datalog/autotable rows
"""

__version__ = "0.4.0"

from prosper_tpu.engine.anneal import LinearAnnealing
from prosper_tpu.engine.em import EM, run_restarts
from prosper_tpu.engine.stream import StreamingEM
from prosper_tpu.parallel.mesh import MeshRuntime

__all__ = ["LinearAnnealing", "EM", "run_restarts", "StreamingEM",
           "MeshRuntime", "__version__"]
