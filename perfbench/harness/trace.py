"""The traced run's reading of ``torch.profiler``: the device's busy time as
the union of its kernel intervals, the traced window, kernels by name, and
the idle gaps labelled by what the host was doing.

The union arithmetic is that of the program's ``utils/profiling.py::_profile``
(intervals sorted by start, merged while they overlap), kept here so that a
change to the program cannot move it.  The window is the host clock from the
profiler's start to its stop, after a device synchronise, so idle time at
either end counts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Tracer", "union", "summarise"]


def union(spans: list) -> float:
    """Total length covered by (start, end) intervals."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def _gaps(spans: list) -> list:
    """The idle (start, end) gaps between merged device intervals."""
    spans = sorted(spans)
    out, cur_e = [], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            out.append((cur_e, s))
        cur_e = max(cur_e, e)
    return out


def _labeller(host_events):
    """label(gap): the most specific host activity at the gap's midpoint, the
    shortest host event (the benchmark's spans included) that covers it."""
    names = [n for n, _, _ in host_events]
    s = np.array([a for _, a, _ in host_events], dtype=np.float64)
    e = np.array([b for _, _, b in host_events], dtype=np.float64)
    length = e - s

    def label(gap) -> str:
        mid = 0.5 * (gap[0] + gap[1])
        cover = np.flatnonzero((s <= mid) & (e >= mid))
        if not cover.size:
            return "host"
        return names[cover[np.argmin(length[cover])]]

    return label


def summarise(events, window_s: float, top: int = 10) -> dict:
    """Device busy seconds, kernels by name [launches, seconds], and the
    breakdown's two lists from a profiler's events (times in us)."""
    spans, kernels, host = [], {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue  # a span's shadow on the device's timeline, not a kernel
            spans.append((s, t))
            rec = kernels.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += (t - s) * 1e-6
        else:
            host.append((e.name, s, t))
    if not spans:
        return {"busy_s": 0.0, "window_s": window_s, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    gaps = _gaps(spans)
    # label the 200 longest gaps one by one, the rest together
    gaps.sort(key=lambda g: g[0] - g[1])
    by_label: dict = {}
    label = _labeller(host)
    for g in gaps[:200]:
        lab = label(g)
        by_label[lab] = by_label.get(lab, 0.0) + (g[1] - g[0]) * 1e-6
    if len(gaps) > 200:
        by_label["(each shorter gap)"] = sum(b - a for a, b in gaps[200:]) * 1e-6
    return {
        "busy_s": union(spans) * 1e-6,
        "window_s": window_s,
        "kernels": kernels,
        "device_ops": sorted(([k[:120], v[1]] for k, v in kernels.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k[:120], v] for k, v in by_label.items()),
                            key=lambda kv: -kv[1])[:top],
    }


class Tracer:
    """Start and stop ``torch.profiler`` around part of the window (on a CPU
    device, for the tests, the host's activity alone).  ``prime`` runs the
    profiler once in set-up, so that its first start (CUPTI's set-up, seconds)
    falls outside the window; the trace is read in ``finish``, after the
    window."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = None
        self.window_s = None
        self.summary = None
        self._done = None

    def _acts(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def prime(self):
        with torch.profiler.profile(activities=self._acts()):
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum().item()

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._acts())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self._done, self.prof = self.prof, None

    def finish(self):
        """The summary of the traced part (None if nothing was traced)."""
        if self._done is not None and self.summary is None:
            self.summary = summarise(self._done.events(), self.window_s)
            self._done = None
        return self.summary
