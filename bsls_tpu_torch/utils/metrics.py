"""Structured metrics: JSONL emitter for per-chunk solver telemetry.

A copy of ``bsls_tpu/utils/metrics.py`` (json only).
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

__all__ = ["MetricsWriter"]


class MetricsWriter:
    """Append-only JSONL writer; every record gets a wall timestamp."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, kind: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"ts": time.time(), "kind": kind, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
