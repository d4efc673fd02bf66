"""The program's spans in the traced window (``runtime/profiling.py::span``
of the port): each device operation put down to the span of the program
whose code caused it, and each idle gap of the device placed inside or
outside the program's root spans (a training step, a served batch), on
the clock of the profiler's trace.

A device operation (kernel, copy, fill) goes to a span in three steps:

1. its launch: the host's runtime call (``cudaLaunchKernel``,
   ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) with the same
   ``correlation_id``;
2. where the launch lies inside a backward node on its thread (an
   operation that carries the ``sequence_nr`` and ``fwd_thread_id`` of
   the forward operation whose gradient it computes: ``autograd::engine::
   evaluate_function: ...``), the innermost such node is replaced by that
   forward operation;
3. the innermost span around that forward operation, or else around the
   launch, on its thread; where that thread holds no span there (the
   autograd engine's threads, ``AccumulateGrad``), the innermost span
   open at that time on any thread.

An operation whose launch is not in the trace goes to no span.  Idle time
is the traced window (first to last event) less the union of the device
operations' intervals.  The trace is read once a run, in O(n log n) over
its events, and kept on the run's context; where the program records no
span (a commit before the spans), every reader finds nothing.
"""

from __future__ import annotations

import collections
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from pipnet_tpu_torch.runtime import profiling as _profiling

# empty at a commit before the spans
SPANS: Tuple[str, ...] = tuple(getattr(_profiling, "SPANS", ()))
ROOTS: Tuple[str, ...] = tuple(getattr(_profiling, "ROOTS", ()))


def _nest(intervals: Sequence[Tuple[int, int]]) -> List[int]:
    """The index of each interval's innermost enclosing interval (-1: none),
    for intervals of one thread sorted by (start, -end), which nest."""
    parent, stack = [], []
    for s, e in intervals:
        while stack and intervals[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def _innermost(intervals: Sequence[Tuple[int, int]], times: Sequence[int]) -> List[int]:
    """The index of the innermost interval around each time (-1: none), for
    nesting intervals of one thread sorted by (start, -end)."""
    out = [-1] * len(times)
    stack, k = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while k < len(intervals) and intervals[k][0] <= t:
            while stack and intervals[stack[-1]][1] <= intervals[k][0]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and intervals[stack[-1]][1] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def _measure(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """The window's device time by span path and its idle time, from the
    profiler ``prof`` of a run that stepped ``steps`` steps (or batches)."""

    def __init__(self, prof, steps: int):
        self.steps = steps
        cuda = torch.autograd.DeviceType.CUDA
        names = set(SPANS)
        device: List[Tuple[int, int, int]] = []          # (start, end, correlation)
        launches: Dict[int, Tuple[int, int]] = {}         # correlation -> (time, thread)
        spans = collections.defaultdict(list)             # thread -> (start, end, name)
        nodes = collections.defaultdict(list)             # thread -> (start, end, seq, fwd thread)
        forward: Dict[Tuple[int, int], int] = {}          # (thread, seq) -> start of the op
        t0, t1 = None, None
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            t0 = s if t0 is None or s < t0 else t0
            t1 = end if t1 is None or end > t1 else t1
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append((s, end, e.correlation_id()))
                continue
            name = e.name()
            thread = e.start_thread_id()
            if name in names:
                spans[thread].append((s, end, name))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = (s, thread)
            elif e.sequence_nr() >= 0:
                if e.fwd_thread_id():
                    nodes[thread].append((s, end, e.sequence_nr(), e.fwd_thread_id()))
                elif forward.get((thread, e.sequence_nr()), -1) < s:
                    # the last operation to take a sequence number made the node
                    forward[(thread, e.sequence_nr())] = s
        self.window_ns = (t1 - t0) if t0 is not None else 0
        self.found = bool(device) and any(spans.values())

        # every span's path from its root, by thread
        self.paths: Dict[int, List[Tuple[str, ...]]] = {}
        self.spans: Dict[int, List[Tuple[int, int]]] = {}
        self.host_ns: Dict[str, int] = collections.defaultdict(int)
        for thread, found in spans.items():
            found.sort(key=lambda x: (x[0], -x[1]))
            ivs = [(s, e) for s, e, _ in found]
            paths = []
            for (s, e, name), p in zip(found, _nest(ivs)):
                paths.append((paths[p] if p >= 0 else ()) + (name,))
                self.host_ns[name] += e - s
            self.spans[thread], self.paths[thread] = ivs, paths

        # steps 1 and 2: each operation's launch, moved to its forward op
        where: List[Optional[Tuple[int, int]]] = []
        for s, e, corr in device:
            where.append(launches.get(corr))
        by_thread = collections.defaultdict(list)
        for i, w in enumerate(where):
            if w is not None:
                by_thread[w[1]].append(i)
        for thread, idx in by_thread.items():
            ns = sorted(nodes.get(thread, ()), key=lambda x: (x[0], -x[1]))
            if not ns:
                continue
            inner = _innermost([(s, e) for s, e, _, _ in ns], [where[i][0] for i in idx])
            for i, n in zip(idx, inner):
                if n >= 0:
                    _, _, seq, fwd_thread = ns[n]
                    t = forward.get((fwd_thread, seq))
                    if t is not None:
                        where[i] = (t, fwd_thread)

        # step 3: the innermost span on the thread, else on any thread
        self.device_ns: Dict[Tuple[str, ...], int] = collections.defaultdict(int)
        pending = collections.defaultdict(list)
        for i, w in enumerate(where):
            if w is not None:
                pending[w[1]].append(i)
        fallback = []
        for thread, idx in pending.items():
            if thread not in self.spans:
                fallback += idx
                continue
            inner = _innermost(self.spans[thread], [where[i][0] for i in idx])
            for i, k in zip(idx, inner):
                if k >= 0:
                    self.device_ns[self.paths[thread][k]] += device[i][1] - device[i][0]
                else:
                    fallback.append(i)
        unplaced = [i for i, w in enumerate(where) if w is None]
        for i, path in zip(fallback, self._at([where[i][0] for i in fallback])):
            self.device_ns[path] += device[i][1] - device[i][0]
        for i in unplaced:
            self.device_ns[()] += device[i][1] - device[i][0]

        # idle: the window less the union of the device's operations
        device.sort()
        gaps, end = [], t0
        for s, e, _ in device:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if t1 is not None and t1 > end:
            gaps.append((end, t1))
        self.idle_ns = sum(e - s for s, e in gaps)
        self.idle_in_ns = {}
        for root in ROOTS:
            ivs = sorted((s, e) for t in self.spans for (s, e), p in
                         zip(self.spans[t], self.paths[t]) if p[-1] == root)
            self.idle_in_ns[root] = _measure(gaps, ivs)
        self.idle_by_span: Dict[str, int] = collections.defaultdict(int)
        for (s, e), path in zip(gaps, self._at([(s + e) // 2 for s, e in gaps])):
            self.idle_by_span[path[-1] if path else "outside every span"] += e - s

    def _at(self, times: Sequence[int]) -> List[Tuple[str, ...]]:
        """The path of the innermost span open at each time on any thread
        (of those open on several threads, the latest to start); () where
        none is."""
        best: List[Tuple[int, Tuple[str, ...]]] = [(-1, ())] * len(times)
        for thread, ivs in self.spans.items():
            for q, k in enumerate(_innermost(ivs, times)):
                if k >= 0 and ivs[k][0] > best[q][0]:
                    best[q] = (ivs[k][0], self.paths[thread][k])
        return [p for _, p in best]

    # -- the readings ---------------------------------------------------------
    def busy_ms(self, names: Sequence[str], under: Optional[str] = None) -> float:
        """Device time a step of the operations put down to a span named in
        ``names`` or inside one (and inside a span ``under``)."""
        ns = sum(v for path, v in self.device_ns.items()
                 if set(path) & set(names) and (under is None or under in path))
        return ns / 1e6 / self.steps

    def host_ms(self, name: str) -> float:
        """Host time a step inside the spans named ``name``."""
        return self.host_ns.get(name, 0) / 1e6 / self.steps

    def idle_share_in(self, root: str) -> Optional[float]:
        """The share (%) of the window's idle time that falls inside the root
        spans named ``root``."""
        if not self.idle_ns:
            return None
        return 100.0 * self.idle_in_ns[root] / self.idle_ns

    def report(self, out=None) -> None:
        """The window's device time by span (ms a step: all under the span,
        and its own), the share of device time under no span, the host's
        time in each span, and the idle time by the span open at each
        gap's middle, on ``out`` (standard error)."""
        out = out or sys.stderr
        total = sum(self.device_ns.values())
        print(f"spans: device time by span, ms a step over {self.steps} steps "
              f"({total / 1e9:.3f} s in all; "
              f"{100.0 * self.device_ns.get((), 0) / max(total, 1):.3f}% under no span)",
              file=out)
        for path in sorted({p[:k] for p in self.device_ns for k in range(1, len(p) + 1)}):
            under = sum(v for p, v in self.device_ns.items() if p[:len(path)] == path)
            print(f"  {'/'.join(path)}: {under / 1e6 / self.steps:.3f} "
                  f"(own {self.device_ns.get(path, 0) / 1e6 / self.steps:.3f})", file=out)
        host = ", ".join(f"{n} {v / 1e6 / self.steps:.3f}" for n, v in self.host_ns.items())
        idle = ", ".join(f"{name} {v / 1e9:.4f}" for name, v in
                         sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10])
        inside = ", ".join(f"{r} {v / 1e9:.4f}" for r, v in self.idle_in_ns.items())
        print(f"spans: host ms a step in each span: {host}", file=out)
        print(f"spans: idle {self.idle_ns / 1e9:.4f} s of {self.window_ns / 1e9:.4f} s; "
              f"inside {inside}; by the span open at the gap: {idle}", file=out, flush=True)


def of(ctx) -> Optional[Spans]:
    """The traced run's spans, read once and kept on ``ctx``; None where
    the window recorded no span of the program, no device operation or no
    step."""
    if not hasattr(ctx, "program_spans"):
        found = None
        if SPANS and ctx.window.get("steps"):
            found = Spans(ctx.prof, int(ctx.window["steps"]))
            if found.found:
                found.report()
            else:
                found = None
        ctx.program_spans = found
    return ctx.program_spans
