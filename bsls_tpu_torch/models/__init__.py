from .partition import BlockPartition, Bucket
from .problem import DenseMatrix, EllMatrix, Problem, ScaledMatrix, VStackMatrix
from .oracle import OracleResult, fw_gap_np, oracle_solve, oracle_solve_eq
from . import reorder, synthetic, traffic

__all__ = [
    "BlockPartition",
    "Bucket",
    "DenseMatrix",
    "EllMatrix",
    "Problem",
    "ScaledMatrix",
    "VStackMatrix",
    "OracleResult",
    "fw_gap_np",
    "oracle_solve",
    "oracle_solve_eq",
    "reorder",
    "synthetic",
    "traffic",
]
