from . import checkpoint, config, hostops, metrics, profiling, refimpl
from .config import PRESETS, RunConfig, load_config
from .metrics import MetricsWriter

__all__ = [
    "checkpoint",
    "config",
    "hostops",
    "metrics",
    "profiling",
    "refimpl",
    "PRESETS",
    "RunConfig",
    "load_config",
    "MetricsWriter",
]
