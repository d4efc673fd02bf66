"""Reading the profiler's trace of the window: the kernels' intervals, the
device's busy time (their union), device time by kernel name, the host's
waits for the card, and the breakdown of the result line."""

from __future__ import annotations

import collections
from functools import cached_property
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# the host's calls that wait for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "aten::_local_scalar_dense")


def start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


class Trace:
    """The traced window of ``window_s`` seconds."""

    def __init__(self, prof, window_s: float):
        self.prof, self.window_s = prof, window_s

    @cached_property
    def _events(self):
        """(name, device type, start us, end us) of every recorded event,
        from the profiler's raw results (building its event tree takes
        minutes for a window of hundreds of steps)."""
        return [(e.name(), e.device_type(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in self.prof.profiler.kineto_results.events()]

    @cached_property
    def kernels(self) -> List[Tuple[str, float, float]]:
        """(name, start us, end us) of every operation that ran on the
        device, by start."""
        cuda = torch.autograd.DeviceType.CUDA
        return sorted(((n, s, e) for n, d, s, e in self._events if d == cuda),
                      key=lambda k: k[1])

    @cached_property
    def host(self) -> List[Tuple[str, float, float]]:
        cpu = torch.autograd.DeviceType.CPU
        return [(n, s, e) for n, d, s, e in self._events if d == cpu]

    def _busy_and_gaps(self) -> Tuple[float, List[Tuple[float, float]]]:
        busy, gaps = 0.0, []
        end = None
        for _, s, e in self.kernels:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e6, gaps

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return self._busy_and_gaps()[0]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_seconds(self, match) -> Tuple[float, int]:
        """Total seconds and count of the kernels whose name ``match``
        accepts."""
        total, n = 0.0, 0
        for name, s, e in self.kernels:
            if match(name):
                total += e - s
                n += 1
        return total / 1e6, n

    def host_calls(self, names: Sequence[str] = HOST_WAITS) -> Dict[str, int]:
        counts = collections.Counter(n for n, _, _ in self.host if n in names)
        return {n: counts.get(n, 0) for n in names}

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps grouped by the innermost host operation running at their
        midpoint."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name[:120]] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        _, gaps = self._busy_and_gaps()
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:500]
        idle: Dict[str, float] = collections.defaultdict(float)
        if gaps and self.host:
            starts = np.array([h[1] for h in self.host])
            ends = np.array([h[2] for h in self.host])
            length = ends - starts
            for s, e in gaps:
                mid = (s + e) / 2
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                name = (self.host[inside[np.argmin(length[inside])]][0][:120]
                        if len(inside) else "no host operation")
                idle[name] += (e - s) / 1e6
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def cuda_time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
