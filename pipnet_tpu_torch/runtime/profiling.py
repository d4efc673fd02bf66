"""Profiling and throughput counters (the port's counterpart of the JAX
package's ``runtime/profiling.py``; the reference has no tracing,
``main.py:59-64``).

* ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, on a card,
  CUDA activity, written to ``logdir`` as a Chrome / Perfetto trace;
* ``annotate(name)``: a named region in such a trace
  (``torch.profiler.record_function``);
* ``StepTimer``: images/s and images/s per card with warm-up steps excluded.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/trace'): run_steps()`` writes
    ``<logdir>/trace.json``.  On a card the device work queued inside the
    block is waited for before the trace stops."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region for traces: ``with annotate('train_step'): ...``."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput counters: images/s per card with warm-up steps excluded.
    The host clock times what was issued; a caller timing device work
    synchronizes before reading ``stats``."""

    def __init__(self, warmup_steps: int = 2, num_chips: Optional[int] = None):
        self.warmup_steps = warmup_steps
        self.num_chips = num_chips or torch.cuda.device_count() or 1
        self.reset()

    def reset(self):
        self._steps = 0
        self._images = 0
        self._t0 = None

    def step(self, batch_images: int):
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._images = 0
        elif self._steps > self.warmup_steps:
            self._images += batch_images

    def stats(self) -> Dict[str, float]:
        if self._t0 is None or self._steps <= self.warmup_steps:
            return {"steps": self._steps, "images_per_sec": 0.0,
                    "images_per_sec_per_chip": 0.0}
        dt = time.perf_counter() - self._t0
        ips = self._images / max(dt, 1e-9)
        return {"steps": self._steps, "images_per_sec": ips,
                "images_per_sec_per_chip": ips / self.num_chips,
                "steps_per_sec": (self._steps - self.warmup_steps) / max(dt, 1e-9)}
