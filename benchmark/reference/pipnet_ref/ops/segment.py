"""Segment ops over the stacked prototype axis.

The reference loops over tree nodes applying ``softmax(dim=1)`` per node's
prototype bank (``pipnet/pipnet.py:124-148``).  Here all banks live on one
stacked axis ``P`` (see ``tree/compile.py``) and nodes are grouped into
*buckets* of equal padded width.  All functions take ``x[..., P]`` with the
prototype axis minor-most.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tree.compile import TreeArrays


def tree_tensor(tree: TreeArrays, name: str, array: np.ndarray,
                device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``array`` (a static table derived from ``tree``) as a tensor on
    ``device``, cached on the tree instance so the host-to-device copy
    happens once per (table, device, dtype)."""
    cache = tree.__dict__.setdefault("_torch_tensor_cache", {})
    key = (name, str(device), dtype)
    if key not in cache:
        # a normal tensor even when first asked for under inference_mode,
        # so later autograd-recording callers can use the cached copy
        with torch.inference_mode(False):
            cache[key] = torch.as_tensor(np.ascontiguousarray(array),
                                         dtype=dtype, device=device)
    return cache[key]


def _node_onehot(tree: TreeArrays) -> np.ndarray:
    """(P, N) float32 prototype -> node one-hot; padded slots are all-zero rows."""
    cached = tree.__dict__.get("_node_onehot_cache")
    if cached is None:
        onehot = np.zeros((tree.num_protos_padded, tree.num_nodes), np.float32)
        pn = np.clip(tree.proto_node, 0, tree.num_nodes - 1)
        onehot[np.arange(tree.num_protos_padded), pn] = (
            tree.proto_node >= 0).astype(np.float32)
        tree.__dict__["_node_onehot_cache"] = onehot
        cached = onehot
    return cached


def _bucket_views(x: torch.Tensor, tree: TreeArrays):
    """Yield (bucket, view) where view is x's bucket slice reshaped to
    (..., num_nodes, width)."""
    for b in tree.buckets:
        size = b.num_nodes * b.width
        view = x[..., b.proto_offset: b.proto_offset + size]
        yield b, view.reshape(*x.shape[:-1], b.num_nodes, b.width)


def _valid_mask(tree: TreeArrays, bucket) -> np.ndarray:
    """(num_nodes, width) bool validity mask for one bucket."""
    size = bucket.num_nodes * bucket.width
    return tree.proto_valid[bucket.proto_offset: bucket.proto_offset + size].reshape(
        bucket.num_nodes, bucket.width)


def segment_max_to_nodes(x: torch.Tensor, tree: TreeArrays,
                         fill: float = float("-inf")) -> torch.Tensor:
    """Max of ``x[..., P]`` within each node's segment -> ``(..., N)``,
    with padded slots replaced by ``fill``."""
    parts = []
    for b, view in _bucket_views(x, tree):
        valid = tree_tensor(tree, f"valid_bucket{b.proto_offset}",
                            _valid_mask(tree, b), x.device, torch.bool)
        parts.append(torch.where(valid, view, torch.full_like(view, fill))
                     .amax(dim=-1))
    return torch.cat(parts, dim=-1)


def segment_softmax(x: torch.Tensor, tree: TreeArrays, tau: float = 1.0) -> torch.Tensor:
    """Per-node softmax over the prototype axis, per patch, computed in f32
    and returned in ``x``'s dtype.

    Matches ``softmax(proto_features / tau, dim=1)`` applied per node
    (ref pipnet/pipnet.py:146-148) and the JAX package's matmul method: shift
    by the true per-node max, exp clipped to [-80, 60], per-node sums and
    their broadcast back as matmuls against the (P, N) one-hot, denominator
    floor 1e-18.  Padded prototype slots come out exactly 0.
    """
    onehot = tree_tensor(tree, "node_onehot", _node_onehot(tree), x.device,
                         torch.float32)
    valid = tree_tensor(tree, "proto_valid_f32",
                        tree.proto_valid.astype(np.float32), x.device,
                        torch.float32)
    z = x.to(torch.float32) / tau
    m = segment_max_to_nodes(z, tree)                                 # (..., N)
    c = m @ onehot.T
    # clip both sides: valid slots sit in (-inf, 0] after the shift; the
    # padded tail has c=0 and raw z, whose exp must stay finite before the
    # validity mask zeroes it (inf * 0 = nan)
    e = torch.exp(torch.clamp(z - c, -80.0, 60.0)) * valid
    denom = (e @ onehot) @ onehot.T
    p = e / torch.clamp(denom, min=1e-18)
    return p.to(x.dtype)


def gumbel_noise(shape, generator: Optional[torch.Generator], device=None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A Gumbel sample ``-log(-log(u))``, ``u`` uniform from ``generator``
    (on ``device``)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def soft_gumbel(logits2: torch.Tensor, generator: Optional[torch.Generator],
                tau: float = 0.5, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft Gumbel-softmax over the last axis (ref pipnet/train.py:978).

    The Gumbel sample draws from ``generator`` (on ``logits2``'s device), or
    is ``noise`` when given: ``torch.Generator`` and ``jax.random`` give
    different streams, so a test hands both packages the same sample."""
    if noise is None:
        noise = gumbel_noise(logits2.shape, generator, logits2.device, logits2.dtype)
    return torch.softmax((logits2 + noise) / tau, dim=-1)
