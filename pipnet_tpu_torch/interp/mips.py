"""Maximum inner-product search (MIPS) over latent patches.

Counterpart of the JAX package's ``interp/mips.py`` (the reference's MIPS
notebooks, ``MIPS.ipynb``, ``MIPS-Stage1.ipynb``): build an index of
backbone patch embeddings over a loader and retrieve, for arbitrary query
vectors (e.g. prototype kernels), the top-k (image, patch location) pairs by
inner product or cosine similarity.  The scoring is one matrix product and a
``torch.topk`` on the chosen device (the JAX package computes its product
outside Pallas too)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import host_to_device, resolve_device
from ..models.pipnet import PIPNet


@dataclasses.dataclass
class PatchIndex:
    features: np.ndarray      # (n_patches, D) float32
    image_idx: np.ndarray     # (n_patches,) int32
    h_idx: np.ndarray         # (n_patches,)
    w_idx: np.ndarray         # (n_patches,)
    latent_hw: Tuple[int, int]

    def __len__(self):
        return len(self.features)


def build_patch_index(model: PIPNet, loader, *, max_images: Optional[int] = None,
                      batch_size: int = 16) -> PatchIndex:
    """Sweep a loader collecting every image's patch embeddings (the
    backbone's features, on the model's device in batches of
    ``batch_size``); they come to the host, as float32 numpy, in one copy
    after the sweep."""
    dev = next(model.parameters()).device
    feats, buf = [], []
    count = 0

    def flush():
        nonlocal count
        if not buf:
            return
        with torch.no_grad():
            feats.append(model.features(host_to_device(np.stack(buf), dev)))
        count += len(buf)
        buf.clear()

    for batch in loader.epoch(0):
        for i in range(len(batch.ys)):
            if max_images is not None and count + len(buf) >= max_images:
                break
            buf.append(batch.xs1[i])
            if len(buf) == batch_size:
                flush()
        else:
            continue
        break
    flush()
    f = torch.cat(feats).cpu().float().numpy()                      # (n, H, W, D)
    n, H, W, D = f.shape
    hh, ww = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return PatchIndex(features=f.reshape(-1, D),
                      image_idx=np.repeat(np.arange(n, dtype=np.int32), H * W),
                      h_idx=np.tile(hh.ravel(), n), w_idx=np.tile(ww.ravel(), n),
                      latent_hw=(H, W))


def mips_query(index: PatchIndex, queries: np.ndarray, k: int = 10,
               cosine: bool = False, device: Union[str, torch.device] = "cuda"
               ) -> List[List[Tuple[int, int, int, float]]]:
    """Top-k patches per query row on ``device`` (the card unless the caller
    asks for the CPU); returns per query a list of (image_idx, h, w,
    score)."""
    dev = resolve_device(device)
    f = torch.from_numpy(np.ascontiguousarray(index.features, np.float32)).to(dev)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    if cosine:
        f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-12)
        q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-12)
    vals, idx = torch.topk(q @ f.T, k, dim=1)                        # (Q, k)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    out = []
    for qi in range(len(queries)):
        out.append([(int(index.image_idx[i]), int(index.h_idx[i]),
                     int(index.w_idx[i]), float(v))
                    for i, v in zip(idx[qi], vals[qi])])
    return out
