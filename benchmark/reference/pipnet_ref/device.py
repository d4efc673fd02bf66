"""Host-to-device copies of small host arrays."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def host_to_device(a: Union[np.ndarray, list], device: Union[str, torch.device]) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the device.  A
    blocking copy to a card synchronizes its stream, which drains the queue
    the host has run ahead with; this one goes from pinned memory,
    asynchronously."""
    t = torch.as_tensor(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
