"""Segment ops over the stacked prototype axis.

The reference loops over tree nodes applying ``softmax(dim=1)`` per node's
prototype bank (``pipnet/pipnet.py:124-148``).  Here all banks live on one
stacked axis ``P`` (see ``tree/compile.py``) and nodes are grouped into
*buckets* of equal padded width.  All functions take ``x[..., P]`` with the
prototype axis minor-most.

On the model axis of a mesh (``runtime/mesh.py``) a rank holds the columns
[lo, hi) of P (``ProtoColumns``) and ``segment_softmax`` takes them: a node
wholly inside the range needs no collective; a node that a boundary cuts
takes its per-patch max and sum through an all-reduce over the model ranks
of those nodes' statistics alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..runtime.mesh import Mesh
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


def segment_softmax(x: torch.Tensor, tree: TreeArrays, tau: float = 1.0,
                    noise: Optional[torch.Tensor] = None, gumbel_tau: float = 1.0,
                    columns: Optional["ProtoColumns"] = None) -> torch.Tensor:
    """Per-node softmax over the prototype axis, per patch, computed in f32
    and returned in ``x``'s dtype.

    Matches ``softmax(proto_features / tau, dim=1)`` applied per node
    (ref pipnet/pipnet.py:146-148) and the JAX package's matmul method: shift
    by the true per-node max, exp clipped to [-80, 60], per-node sums and
    their broadcast back as matmuls against the (P, N) one-hot, denominator
    floor 1e-18.  Padded prototype slots come out exactly 0.

    With ``noise`` (a Gumbel sample of ``x``'s shape) the softmax is the
    soft ``F.gumbel_softmax``, ``softmax((x + noise) / gumbel_tau)`` per
    node, and ``tau`` is not read (ref pipnet/pipnet.py:43-51,150-152; the
    JAX package draws the sample from a key, the port takes it as a tensor,
    as ``soft_gumbel`` does).

    With ``columns`` (a model rank's ``ProtoColumns``) ``x`` and ``noise``
    hold only those columns of P, and so does the result.
    """
    if noise is not None:
        x = (x + noise) / gumbel_tau
        tau = 1.0
    if columns is not None:
        return columns.softmax(x, tau)
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


@dataclass(frozen=True, eq=False)
class ProtoColumns:
    """A model rank's columns [lo, hi) of the stacked prototype axis of
    ``tree`` (``Mesh.proto_columns``), with the tables of its per-node
    reductions: the nodes with a prototype in the range (``nodes``, in
    compiled order), and the nodes whose prototypes lie on more than one
    rank (cut by a boundary), each owned by the rank of its first
    prototype."""
    mesh: Mesh
    tree: TreeArrays
    lo: int
    hi: int

    @cached_property
    def _tables(self) -> dict:
        width = self.hi - self.lo
        pn = self.tree.proto_node
        local = pn[self.lo:self.hi]
        nodes = np.unique(local[local >= 0])
        slot_node = np.where(local >= 0, np.searchsorted(nodes, local), len(nodes))
        onehot = np.eye(len(nodes) + 1, len(nodes), dtype=np.float32)[slot_node]
        # a node's local slots are consecutive: one (nodes, slots) table of
        # local columns for each count of slots
        start = np.searchsorted(slot_node, np.arange(len(nodes)))
        count = np.bincount(slot_node, minlength=len(nodes) + 1)[:-1]
        max_tables = [(np.flatnonzero(count == w), start[count == w, None] + np.arange(w))
                      for w in np.unique(count)]
        # the nodes whose prototypes lie on more than one rank, and the rank
        # of each node's first prototype
        rank_of = np.arange(len(pn)) // width
        first_rank = {n: rank_of[np.argmax(pn == n)] for n in range(self.tree.num_nodes)}
        cut = [n for n in range(self.tree.num_nodes) if (rank_of[pn == n] != first_rank[n]).any()]
        here = [j for j, n in enumerate(cut) if n in nodes]
        return dict(nodes=nodes, slot_node=slot_node, onehot=onehot,
                    valid=(local >= 0).astype(np.float32), max_tables=max_tables,
                    n_cut=len(cut), cut_idx=np.asarray(here, np.int64),
                    cut_pos=np.searchsorted(nodes, [cut[j] for j in here]).astype(np.int64),
                    owner=np.asarray([first_rank[n] == self.mesh.model_rank for n in nodes], bool))

    def _t(self, name: str, device, dtype) -> torch.Tensor:
        return tree_tensor(self.tree, f"columns{self.lo}:{self.hi}/{name}", self._tables[name],
                           device, dtype)

    @property
    def nodes(self) -> np.ndarray:
        return self._tables["nodes"]

    def node_ids(self, device) -> torch.Tensor:
        """(N_local,) the local nodes' indices in the tree."""
        return self._t("nodes", device, torch.long)

    def owner(self, device) -> torch.Tensor:
        """(N_local,) bool: this rank owns the node."""
        return self._t("owner", device, torch.bool)

    def onehot(self, device) -> torch.Tensor:
        """(hi - lo, N_local) f32 one-hot of each local slot's node."""
        return self._t("onehot", device, torch.float32)

    def _cut(self, v: torch.Tensor, op: str) -> torch.Tensor:
        """``v`` (..., N_local) with the cut nodes' entries reduced over the
        model ranks (every rank takes part, with its identity where it holds
        none of a cut node)."""
        t = self._tables
        if t["n_cut"] == 0:
            return v
        pos = self._t("cut_pos", v.device, torch.long)
        idx = self._t("cut_idx", v.device, torch.long)
        fill = float("-inf") if op == "max" else 0.0
        buf = v.new_full((*v.shape[:-1], t["n_cut"]), fill)
        buf = buf.index_copy(-1, idx, v.index_select(-1, pos))
        buf = self.mesh.model_all_reduce(buf, op)
        return v.index_copy(-1, pos, buf.index_select(-1, idx))

    def node_max(self, z: torch.Tensor) -> torch.Tensor:
        """Max of each local node's slots of ``z`` (..., hi - lo) -> (...,
        N_local), over the ranks for a cut node; no gradient."""
        z = z.detach()
        zp = torch.cat([z, z.new_full((*z.shape[:-1], 1), float("-inf"))], dim=-1)
        m = z.new_empty((*z.shape[:-1], len(self.nodes)))
        for j, (ids, cols) in enumerate(self._tables["max_tables"]):
            key = f"columns{self.lo}:{self.hi}/max{j}"
            cols = tree_tensor(self.tree, key + "cols", cols, z.device, torch.long)
            m[..., tree_tensor(self.tree, key + "ids", ids, z.device, torch.long)] = \
                zp[..., cols].amax(dim=-1)
        return self._cut(m, "max")

    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of each local node's slots of ``x`` (..., hi - lo) -> (...,
        N_local) in f32, over the ranks for a cut node (differentiable)."""
        return self._cut(x.to(torch.float32) @ self.onehot(x.device), "sum")

    def softmax(self, x: torch.Tensor, tau: float) -> torch.Tensor:
        """``segment_softmax`` of this rank's columns ``x``."""
        dev = x.device
        slot_node = self._t("slot_node", dev, torch.long)
        valid = self._t("valid", dev, torch.float32)
        z = x.to(torch.float32) / tau
        m = self.node_max(z)
        c = torch.cat([m, m.new_zeros((*m.shape[:-1], 1))], dim=-1)[..., slot_node]
        e = torch.exp(torch.clamp(z - c, -80.0, 60.0)) * valid
        s = self.node_sum(e)
        denom = torch.cat([s, s.new_zeros((*s.shape[:-1], 1))], dim=-1)[..., slot_node]
        return (e / torch.clamp(denom, min=1e-18)).to(x.dtype)


def spatial_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the spatial axes of ``(B, H, W, P)`` per prototype: the
    ``softmax_over_channel='y'`` variant (ref pipnet/pipnet.py:138-144,
    which reshapes (B,C,H,W)->(B,C,HW) and softmaxes over the last axis)."""
    B, H, W, P = x.shape
    return torch.softmax(x.reshape(B, H * W, P), dim=1).reshape(B, H, W, P)


def segment_sum_to_nodes(x: torch.Tensor, tree: TreeArrays) -> torch.Tensor:
    """Sum ``x[..., P]`` within each node's segment -> ``(..., N)``, in
    compiled node order (the buckets hold consecutive nodes)."""
    return torch.cat([view.sum(dim=-1) for _, view in _bucket_views(x, tree)], dim=-1)


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


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float64 holds the product of
    two float32s exactly), the same on every device."""
    return (a.double() * b + c).float()


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor as the JAX package's CPU backend computes it
    (XLA's Cephes polynomial with fused multiply-adds, results below the
    smallest normal flushed to 0), bit for bit on any device; within 2 ulps
    of ``torch.exp``."""
    x = x.clamp(-87.80000305175781, 88.80000305175781)
    n = torch.floor(_fma(x, 1.4426950216293335, 0.5)).clamp(-127.0, 127.0)
    r = _fma(-n, 0.693359375, x)
    r = _fma(-n, -0.00021219444170128554, r)
    y = _fma(r, 0.00019875691214110702, 0.001398199936375022)
    for c in (0.008333452045917511, 0.04166579619050026, 0.1666666567325592, 0.5):
        y = _fma(y, r.double(), c)
    y = _fma(y, (r * r).double(), r.double()) + 1.0
    out = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < torch.finfo(torch.float32).tiny, torch.zeros_like(out), out)


def segment_hard_gumbel(logits2: torch.Tensor, generator: Optional[torch.Generator],
                        tau: float = 0.5, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard (straight-through) Gumbel-softmax over the last axis of (..., 2)
    presence logits in float32: one-hot values with the soft sample's
    gradients (ref ``F.gumbel_softmax(..., tau=0.5, hard=True)`` at
    pipnet/pipnet.py:165).  ``noise`` as in ``soft_gumbel``.

    The value is ``hard + y - y`` in float32, which can come out one ulp
    below 1, exactly as the JAX package computes it; its softmax uses the
    JAX package's CPU exp (``_exp_f32``), so a sample gives the JAX
    package's mask bit for bit, on the CPU and on the card alike.  The
    gradient is ``torch.softmax``'s."""
    if noise is None:
        noise = gumbel_noise(logits2.shape, generator, logits2.device, logits2.dtype)
    z = (logits2 + noise) / tau
    e = _exp_f32(z.detach() - z.detach().amax(dim=-1, keepdim=True))
    soft = torch.softmax(z, dim=-1)
    y = e / e.sum(dim=-1, keepdim=True) + (soft - soft.detach())
    hard = torch.nn.functional.one_hot(y.argmax(dim=-1), logits2.shape[-1]).to(y.dtype)
    return hard + y - y.detach()
