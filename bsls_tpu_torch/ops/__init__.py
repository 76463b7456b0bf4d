from . import (
    banded, chunkkernel, cudalib, isotonic, layout, pagekernels, projection, quadratic,
    rowkernels, simplex, ztransform,
)
from .banded import DeviceBanded
from .chunkkernel import pgd_chunk
from .cudalib import launch_counts, reset_launch_counts
from .isotonic import pava_blocks, pava_bounded, pava_padded
from .layout import (
    DeviceBucket,
    DeviceDense,
    DeviceEll,
    DeviceProblem,
    DeviceVStack,
    block_scales,
    extract_user_flat,
    feasible_init,
    flat_to_padded,
    inject_user_flat,
    matvec,
    padded_to_flat,
    prepare,
    rdot,
    rmatvec,
    xdot,
)
from .projection import proj_blocks, proj_simplex_padded
from .pagekernels import band_grmv, band_zmv
from .rowkernels import pava_rows, proj_simplex_rows
from .simplex import block_min

__all__ = [
    "banded",
    "chunkkernel",
    "cudalib",
    "pagekernels",
    "DeviceBanded",
    "band_grmv",
    "band_zmv",
    "pgd_chunk",
    "isotonic",
    "layout",
    "projection",
    "quadratic",
    "rowkernels",
    "simplex",
    "ztransform",
    "pava_blocks",
    "pava_bounded",
    "pava_padded",
    "DeviceBucket",
    "DeviceDense",
    "DeviceEll",
    "DeviceProblem",
    "DeviceVStack",
    "block_scales",
    "extract_user_flat",
    "feasible_init",
    "flat_to_padded",
    "inject_user_flat",
    "matvec",
    "padded_to_flat",
    "prepare",
    "rdot",
    "rmatvec",
    "xdot",
    "proj_blocks",
    "proj_simplex_padded",
    "launch_counts",
    "pava_rows",
    "proj_simplex_rows",
    "reset_launch_counts",
    "block_min",
]
