"""bsls_tpu_torch — block-simplex-constrained least squares on PyTorch/CUDA.

The port of ``bsls_tpu`` (JAX, the reference, which stays in the repository)
to PyTorch with hand-written CUDA kernels for an NVIDIA H100.  This package
imports ``torch``, never ``jax``, and nothing of ``bsls_tpu``.

Ported so far: the batched solve with all six solver families (pgd with the
exact, bb, bbm, fixed and pava line searches, apgd, lbfgs in x- and z-space,
eg, frank_wolfe, afw) on the gather and the banded layout, ``certify=K``,
``refine=K`` and ``refine_tol=``, and the opt-in fused chunk
(``BSLS_MEGA=1``), and the equality-constrained path (``solve`` of a
``Problem`` with ``C``: the augmented-Lagrangian loop on the stacked operator
[A; sqrt(rho) C], its float64 host layer and ``oracle_solve_eq``), serving
(``Endpoint``, ``BatchQueue``), checkpoint/resume, the ``.mat`` loader and the
CLI, all on one device, with CUDA kernels (``csrc/``) for the block-simplex
projection, the bounded isotonic regression, the two per-page band
contractions and the fused chunk of PGD iterations.  Only the mesh
(distribution) is not ported.  Entry points take ``device=`` and default to
``"cuda"``; they run on the CPU only when asked to.

Precision: fp32 on the device with float64 anchors on the host.  Dense and
batched contractions stay at full fp32 — reduced-precision matrix passes cap
the accuracy of A x near 2e-3 relative, which stalls 1e-6 convergence — so
importing the package switches TF32 off for matrix products.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .models import (  # noqa: E402
    BlockPartition,
    DenseMatrix,
    EllMatrix,
    OracleResult,
    Problem,
    oracle_solve,
    oracle_solve_eq,
    synthetic,
)
from .ops.layout import DeviceProblem, prepare  # noqa: E402
from .ops.cudalib import launch_counts, reset_launch_counts  # noqa: E402
from .solvers import SolveResult, solve, solve_equality_constrained  # noqa: E402
from .serving import BatchQueue, Endpoint  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "BlockPartition",
    "DenseMatrix",
    "EllMatrix",
    "OracleResult",
    "Problem",
    "oracle_solve",
    "oracle_solve_eq",
    "synthetic",
    "DeviceProblem",
    "prepare",
    "SolveResult",
    "solve",
    "solve_equality_constrained",
    "Endpoint",
    "BatchQueue",
    "launch_counts",
    "reset_launch_counts",
]
