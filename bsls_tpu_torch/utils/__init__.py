from . import config, hostops, metrics, refimpl
from .config import PRESETS, RunConfig, load_config
from .metrics import MetricsWriter

__all__ = [
    "config",
    "hostops",
    "metrics",
    "refimpl",
    "PRESETS",
    "RunConfig",
    "load_config",
    "MetricsWriter",
]
