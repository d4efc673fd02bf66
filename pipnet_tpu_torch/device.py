"""Device selection for the port's entry points.

Every entry point (``build_pipnet``, ``load_run``, ``Predictor``) runs on the
card unless its caller asks for the CPU.  Nothing falls back to the CPU on its
own: a missing card is an error, not a slower run.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .runtime.profiling import span


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no card
    is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    return dev


def host_to_device(a: Union[np.ndarray, list], device: Union[str, torch.device]) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the device.  A
    blocking copy to a card synchronizes its stream, which drains the queue
    the host has run ahead with; this one goes from pinned memory,
    asynchronously."""
    with span("to_device"):
        t = torch.as_tensor(a)
        if torch.device(device).type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)
