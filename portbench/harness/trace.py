"""The traced window: ``torch.profiler`` over part of the measured window,
and what the metric readers take from it.

The profiler records host operations and device activity (kernels, copies,
fills) for a short span that the driver chooses, ending at a synchronize on
both sides. From it: the busy seconds (the union of the device's intervals),
the device time of each kernel by name, the device time under each host
operation by name, and the idle gaps between device intervals, each named
after the innermost host operation that was running when the gap opened.
"""

from __future__ import annotations

import re
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


class Window:
    """Start and stop the profiler once; ``data`` afterwards, read from the
    trace when first asked for (after the measured window)."""

    def __init__(self):
        self.prof = None
        self.t0 = self.window_s = None
        self._data = None

    @property
    def started(self) -> bool:
        return self.prof is not None

    @property
    def running(self) -> bool:
        return self.started and self.window_s is None

    @property
    def data(self):
        if self._data is None and self.window_s is not None:
            self._data = TraceData.from_profiler(self.prof, self.window_s)
        return self._data

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        initializes the tracer and takes seconds."""
        w = Window()
        w.start()
        w.stop()

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.running:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    return name.split("(")[0].strip()[:120]


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]          # (name, start µs, end µs)
    op_device_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "TraceData":
        dev, cpu = [], []
        for e in prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a host annotation mirrored on the device's timeline is no work
                if not getattr(e, "is_user_annotation", False):
                    dev.append((e.name, *span))
            else:
                cpu.append((span[0], span[1], e.name))
        op_device_s: Dict[str, float] = {}
        for a in prof.key_averages():
            t = getattr(a, "device_time_total", None)
            if t is None:
                t = a.cuda_time_total
            if t:
                op_device_s[a.key] = t * 1e-6
        intervals = sorted((s, e) for _, s, e in dev)
        merged: List[List[float]] = []
        for s, e in intervals:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) * 1e-6
        cpu.sort()
        starts = [c[0] for c in cpu]
        gaps = []
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            gaps.append((s1 - e0, e0))
        gaps.sort(reverse=True)
        named = [(cls._host_at(cpu, starts, t), g * 1e-6) for g, t in gaps[:10]]
        return cls(window_s, min(busy, window_s), dev, op_device_s, named)

    @staticmethod
    def _host_at(cpu, starts, t: float) -> str:
        """The innermost host operation running at time t (the latest-started
        one that has not ended), or "host" where none was recorded."""
        i = bisect_right(starts, t)
        best = None
        for s, e, name in reversed(cpu[max(0, i - 4000):i]):
            if e >= t:
                best = name
                break
        return best or "host"

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [(e - s) for name, s, e in self.kernels if rx.search(name)]
        return sum(hits) * 1e-6, len(hits)

    def breakdown(self) -> Dict:
        totals: Dict[str, float] = {}
        for name, s, e in self.kernels:
            totals[_short(name)] = totals.get(_short(name), 0.0) + (e - s) * 1e-6
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps]}
