"""Profiling (the port's counterpart of the JAX package's
``runtime/profiling.py``; the reference has no tracing,
``main.py:59-64``).

* ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, on a card,
  CUDA activity, written to ``logdir`` as a Chrome / Perfetto trace;
* ``span(name)``: a named region of the program in such a trace, on the
  clock of the kernels' timestamps; a no-op unless a profiler records.
  ``SPANS`` holds every name the program gives a span.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# Every span of the program.  A span's parent is the span that encloses it
# on its thread; ``ROOTS`` are the outermost: one training step, one served
# batch.
#   fetch: a batch of the device data cache (the rows' copy, the gather)
#   to_device: a small host array sent from pinned memory (the cache's
#       rows, the labels, the augmentation's tables)
#   step: the whole train step (train/step.py::make_train_step), in it
#     augment: the draws and both views of a uint8 batch, in it
#       augment.wait: the host blocked on the views' op counts (card only)
#     backbone: PIPNet.features (the backbone forward and the reducer)
#     head: the prototype head's forward (K1, K2, or the composed head)
#     losses: compute_total_loss's forward
#     backward: loss.backward(); kernels of the backward belong to the
#       span of the forward operation whose gradient they compute
#     clip: gradient clipping
#     adamw: the AdamW update (and BYOL's EMA)
#     metrics: the step's on-device metrics
#   serve: one served batch (serve.py::Predictor.forward), in it
#     backbone, head (as above) and decode: the joint leaf decode
SPANS = ("fetch", "to_device", "step", "augment", "augment.wait", "backbone", "head",
         "losses", "backward", "clip", "adamw", "metrics", "serve", "decode")
ROOTS = ("step", "serve")

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span('backbone'): ...``: a region named ``name`` (one of
    ``SPANS``) while a ``torch.profiler`` records in the process, else a
    shared no-op (one check, no allocation).  The region is a
    function-scope record: a ``record_function`` region (user scope) would
    also put a copy of itself among the device's events."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


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
