from .partition import BlockPartition, Bucket
from .problem import DenseMatrix, EllMatrix, Problem
from .oracle import OracleResult, fw_gap_np, oracle_solve
from . import reorder, synthetic

__all__ = [
    "BlockPartition",
    "Bucket",
    "DenseMatrix",
    "EllMatrix",
    "Problem",
    "OracleResult",
    "fw_gap_np",
    "oracle_solve",
    "reorder",
    "synthetic",
]
