"""Device-resident dataset cache: one dataset's resized uint8 base images
live on the card as a single tensor, and a step's host-to-device transfer
shrinks to a (B,) index vector.

For small and medium datasets (CUB-scale: 5994 train images at 232^2 uint8
take 0.97 GB of the card's 80 GB) the input pipeline becomes one gather on
the card followed by the device augmentation (``ops/device_geometric``,
``ops/device_augment``), so no host decode or augmentation runs per step.

The gathered bytes are bit-identical to the streamed path's ``Batch.xs1``
(the SAME ``base_view`` / eval-resize uint8 arrays, stacked once instead of
per batch).  For the eval kind the ImageNet normalization runs on the card
in f32 and matches ``to_normalized_array`` to float rounding.

The reference streams every batch through DataLoader workers each step
(``util/data.py:652-700``); this cache has no counterpart there.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..runtime.profiling import span
from .augment import IMAGENET_MEAN, IMAGENET_STD
from .loader import EvalDataset, Loader, TwoViewDataset


class DeviceDataCache:
    """One dataset's base images as a single uint8 tensor on ``device``.

    ``kind``:
      - ``"u8base"`` — a TwoViewDataset in device_geometric mode; a fetch
        returns the uint8 base batch the train step's device transform1
        consumes;
      - ``"eval"`` — an EvalDataset; a fetch returns the normalized f32
        batch (gather, then ImageNet normalize, on the device).
    """

    def __init__(self, array_host: np.ndarray, kind: str,
                 device: Union[str, torch.device] = "cuda"):
        if kind not in ("u8base", "eval"):
            raise ValueError(f"unknown cache kind {kind!r}")
        self.kind = kind
        self.device = resolve_device(device)
        self.nbytes = int(array_host.nbytes)
        self.array = torch.from_numpy(np.ascontiguousarray(array_host, np.uint8)).to(self.device)
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(self.device)

    def fetch(self, rows: np.ndarray) -> torch.Tensor:
        """The batch of dataset rows ``rows`` (host indices: a tiny
        host-to-device copy, then one gather on the device).  To a card the
        indices go from pinned memory without waiting for the card."""
        with span("fetch"):
            return self.gather(host_to_device(np.ascontiguousarray(rows, np.int64), self.device))

    def gather(self, rows_device: torch.Tensor) -> torch.Tensor:
        """The batch of an index vector already on the device."""
        x = self.array.index_select(0, rows_device)
        if self.kind == "u8base":
            return x
        return (x.float() / 255.0 - self._mean) / self._std

    def delete(self) -> None:
        """Return the device memory (e.g. the pretrain cache after the
        pretrain phase)."""
        self.array = None


def estimate_bytes(dataset) -> Optional[int]:
    """Device bytes the cache for ``dataset`` would take; None if the dataset
    kind is not cacheable."""
    n = len(dataset)
    if isinstance(dataset, TwoViewDataset):
        if not dataset.device_geometric:
            return None
        s = dataset.transform.resize_to
        return n * s * s * 3
    if isinstance(dataset, EvalDataset):
        s = dataset.transform.image_size
        return n * s * s * 3
    return None


def build_device_cache(loader: Loader, device: Union[str, torch.device] = "cuda"
                       ) -> Optional[DeviceDataCache]:
    """Materialize the device cache for ``loader``'s dataset on ``device``
    (the card unless the caller asks for the CPU), or None when the dataset
    kind does not support it.  Budget gating is the caller's job."""
    ds = loader.dataset
    if isinstance(ds, TwoViewDataset) and ds.device_geometric:
        base = np.stack([ds._base(i) for i in range(len(ds))])
        return DeviceDataCache(base, "u8base", device)
    if isinstance(ds, EvalDataset):
        base = np.stack([ds.transform.base_view(ds.folder.load(i)[0])
                         for i in range(len(ds))])
        return DeviceDataCache(base, "eval", device)
    return None
