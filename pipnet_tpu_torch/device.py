"""Device selection for the port's entry points.

Every entry point (``build_pipnet``, ``load_run``, ``Predictor``) runs on the
card unless its caller asks for the CPU.  Nothing falls back to the CPU on its
own: a missing card is an error, not a slower run.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no card
    is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    return dev
