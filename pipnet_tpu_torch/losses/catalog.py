"""The HComP-Net loss catalog as batched PyTorch functions.

Counterpart of the JAX package's ``losses/catalog.py`` (itself the
reference's per-node Python loops, ``pipnet/train.py:852-1341``): every loss
is a masked segment reduction over the stacked prototype and classifier
axes, using the lookup tables of ``tree/compile.py``.

Batch layout: the two augmented views are concatenated ``[view1; view2]``
with labels duplicated (``pipnet/train.py:213-214``); label -1 (OOD) maps to
an extra all-false table row.  Each function returns ``(total, per_node)``,
the per-node values summed over the nodes and divided by the node count.

Reference quirks kept, as the JAX package keeps them: tanh_desc counts leaf
descendants absent from the batch (their pooled sum is 0, a constant
``-log(eps)``); the overspecificity denominator counts relevant prototypes
of children with no in-batch descendant; the presence Gumbel noise is drawn
once per step (by the caller).

The global feature losses (alignment and uniformity of the l2-normalised
patch features, ref pipnet/train.py:898-928,1376-1396) and the OOD losses
(``ood_bce_loss``, and ``ood_entropy_loss``, which no loss total reads, as
in the JAX package) come after the per-node ones.  ``uniform_loss`` sums
over every pair of a view's patch rows (43,264 of them at the flagship
size): CUDA rows through the hand-written K5 and K5b
(``ops/uniform_pairs.py``), which keep the distances in registers, CPU
rows in row blocks that the backward recomputes, so no (n, n) matrix
outlives a block.  It accumulates the pair sum in float32 whatever the
input's dtype (the JAX package carries it in the input's dtype, bf16 on
the flagship): a deliberate difference.  On a mesh (``shard``, ``runtime/mesh.py``) each
rank holds its own rows' features: the alignment is the ranks' sums of
squares summed, and each rank sums the pairs of its own rows against every
rank's (``_UniformRowPairs``), so the pair work is split over the ranks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.uniform_pairs import (UNIFORM_BLOCK, acc_dtype, row_pairs, uniform_pairs,
                                 uniform_pairs_backward)
from ..tree.compile import TreeArrays

EPS = 1e-8           # calculate_loss is invoked with EPS=1e-8 (pipnet/train.py:238)
ALIGN_EPS = 1e-12    # CARL align loss epsilon (pipnet/train.py:1399-1405)

Loss = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class TreeConsts:
    """Device tensors derived from ``TreeArrays``.  Label tables carry an
    extra trailing row (index L) for label -1: all-false / -1 entries."""
    proto_node: torch.Tensor       # (P,) long, clipped to [0, N-1]; padding -> node 0
    proto_valid: torch.Tensor      # (P,) f32
    proto_child_col: torch.Tensor  # (P,) long global child column, -1 otherwise
    node_onehot: torch.Tensor      # (P, N) f32 one-hot of proto_node (0 rows for padding)
    under: torch.Tensor            # (L+1, N) f32: leaf under node
    leaf_slot: torch.Tensor        # (L+1, N) long: child slot, -1 when absent
    colmat: torch.Tensor           # (L+1, P) long: child column of leaf at proto's node, -1 absent
    child_leaf: torch.Tensor       # (L+1, C) f32: leaf descendant of child column
    node_cols: torch.Tensor        # (N, Cmax) long child columns, 0 padding
    node_cols_valid: torch.Tensor  # (N, Cmax) bool
    node_num_protos: torch.Tensor  # (N,) f32
    node_weights: torch.Tensor     # (C,) f32
    num_leaves: int
    num_nodes: int


def make_tree_consts(tree: TreeArrays, device="cpu") -> TreeConsts:
    L, N, P, C = (tree.num_classes, tree.num_nodes, tree.num_protos_padded,
                  tree.num_children_total)
    pn = np.clip(tree.proto_node, 0, N - 1)
    onehot = np.zeros((P, N), np.float32)
    onehot[np.arange(P), pn] = (tree.proto_node >= 0).astype(np.float32)
    under = np.zeros((L + 1, N), np.float32)
    under[:L] = tree.leaf_under_node
    slot = np.full((L + 1, N), -1, np.int64)
    slot[:L] = tree.leaf_child_slot
    colmat = np.full((L + 1, P), -1, np.int64)
    colmat[:L] = np.where(tree.proto_node[None, :] >= 0, tree.leaf_child_col[:, pn], -1)
    child_leaf = np.zeros((L + 1, C), np.float32)
    child_leaf[:L] = tree.child_leaf_matrix
    node_cols = np.full((N, tree.max_children), -1, np.int64)
    for ni in range(N):
        cn = int(tree.node_num_children[ni])
        node_cols[ni, :cn] = np.arange(tree.node_child_offset[ni],
                                       tree.node_child_offset[ni] + cn)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return TreeConsts(
        proto_node=t(pn, torch.long), proto_valid=t(tree.proto_valid, torch.float32),
        proto_child_col=t(tree.proto_child_col, torch.long),
        node_onehot=t(onehot, torch.float32), under=t(under, torch.float32),
        leaf_slot=t(slot, torch.long), colmat=t(colmat, torch.long),
        child_leaf=t(child_leaf, torch.float32),
        node_cols=t(np.maximum(node_cols, 0), torch.long),
        node_cols_valid=t(node_cols >= 0, torch.bool),
        node_num_protos=t(tree.node_num_protos, torch.float32),
        node_weights=t(tree.node_weights, torch.float32),
        num_leaves=L, num_nodes=N)


def label_rows(ys: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Fine label -> table row, mapping OOD (-1) to the sentinel row L."""
    return torch.where(ys >= 0, ys, torch.full_like(ys, num_leaves))


def _per_node(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den per node where den > 0, else 0."""
    return torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros_like(num))


def _total(tc: TreeConsts, per_node: torch.Tensor) -> Loss:
    return per_node.sum() / tc.num_nodes, per_node


def node_batch_masks(tc: TreeConsts, ys: torch.Tensor):
    """(B, N) in-node mask and per-node in-batch counts."""
    under = tc.under[label_rows(ys, tc.num_leaves)]
    return under, under.sum(dim=0)


def align_pf_loss(tc: TreeConsts, proto_features: torch.Tensor, ys: torch.Tensor,
                  eps: float = ALIGN_EPS) -> Loss:
    """CARL alignment of the two views' softmaxed maps, per node over in-node
    samples, with both stop-gradient directions averaged
    (ref pipnet/train.py:1063-1074): ``0.5 (a sg(b) + sg(a) b)`` has the
    average's value and gradient.  The per-node inner products accumulate
    in f32."""
    B = proto_features.shape[0] // 2
    pf1, pf2 = proto_features[:B], proto_features[B:]
    prod = 0.5 * (pf1 * pf2.detach() + pf1.detach() * pf2)
    ip = prod.float() @ tc.node_onehot                               # (B, H, W, N)
    under, counts = node_batch_masks(tc, ys[:B])
    hw = pf1.shape[1] * pf1.shape[2]
    t = -torch.log(ip + eps) * under[:, None, None, :]
    return _total(tc, _per_node(t.sum(dim=(0, 1, 2)), counts * hw))


def align_pf_row_logsum(tc: TreeConsts, proto_features: torch.Tensor,
                        eps: float = ALIGN_EPS, columns=None) -> torch.Tensor:
    """``logsum[b, n] = sum_hw log(ip + eps)`` (B/2, N) of the two stacked
    views' maps, the per-row part of ``align_pf_loss`` (the no-pf head's
    reduction, K2's, computed from pf): on a mesh each rank reduces its own
    rows and the ranks gather these, not the maps.  With ``columns`` (a
    model rank's ``ops/segment.py::ProtoColumns``) the maps are the rank's
    columns: a node's inner products sum over the ranks where a boundary
    cuts it, each node's log sum counts on the rank that owns it, and the
    ranks' (B/2, N) parts are summed."""
    B = proto_features.shape[0] // 2
    pf1, pf2 = proto_features[:B], proto_features[B:]
    prod = 0.5 * (pf1 * pf2.detach() + pf1.detach() * pf2)
    if columns is None:
        return torch.log(prod.float() @ tc.node_onehot + eps).sum(dim=(1, 2))
    dev = prod.device
    logsum = torch.log(columns.node_sum(prod) + eps).sum(dim=(1, 2))       # (B/2, N_local)
    logsum = logsum * columns.owner(dev)
    part = logsum.new_zeros(B, tc.num_nodes).index_copy(-1, columns.node_ids(dev), logsum)
    return columns.mesh.model_sum(part)


def align_pf_from_logsum(tc: TreeConsts, logsum: torch.Tensor, ys: torch.Tensor,
                         hw: int) -> Loss:
    """align_pf from the no-pf head's reduction ``logsum[b, n] = sum_hw
    log(ip + eps)`` (K2): the same loss with the (B, H, W, P) maps gone."""
    under, counts = node_batch_masks(tc, ys[:logsum.shape[0]])
    return _total(tc, _per_node(-(logsum * under).sum(dim=0), counts * hw))


def tanh_loss(tc: TreeConsts, pooled: torch.Tensor, ys: torch.Tensor,
              eps: float = EPS) -> Loss:
    """-log(tanh(sum over in-node batch of pooled) + eps), averaged over each
    node's prototypes, per view (ref pipnet/train.py:1076-1087)."""
    B = pooled.shape[0] // 2
    under, counts = node_batch_masks(tc, ys[:B])
    mask_p = under[:, tc.proto_node]                                 # (B, P)

    def per_view(pool_v):
        s = (pool_v * mask_p).sum(dim=0)
        lt = torch.log(torch.tanh(s) + eps) * tc.proto_valid
        return -(lt @ tc.node_onehot) / tc.node_num_protos.clamp(min=1.0)

    pn = (per_view(pooled[:B]) + per_view(pooled[B:])) / 2.0
    return _total(tc, torch.where(counts > 0, pn, torch.zeros_like(pn)))


def _relevant_rows(w_eff: torch.Tensor, cols: torch.Tensor, thr: float) -> torch.Tensor:
    """(w_eff > thr) of column ``cols`` (any shape, -1 = none) per prototype,
    0 where cols < 0."""
    rel = (w_eff > thr).float()                                      # (C, P)
    P = w_eff.shape[1]
    flat = cols.reshape(-1, P)
    picked = torch.gather(rel, 0, flat.clamp(min=0))
    return (picked * (flat >= 0)).reshape(cols.shape)


def tanh_desc_loss(tc: TreeConsts, pooled: torch.Tensor, ys: torch.Tensor,
                   w_eff: torch.Tensor, eps: float = EPS) -> Loss:
    """Per-descendant tanh loss (ref pipnet/train.py:1089-1134): for every
    node n and every leaf descendant l, present or not, over the prototypes
    relevant (> 1e-3) to l's child of n, the mean of
    -log(tanh(per-leaf per-view pooled sum) + eps); a node's loss is the mean
    over its leaf descendants."""
    B = pooled.shape[0] // 2
    rows = label_rows(ys[:B], tc.num_leaves)
    L1, P = tc.num_leaves + 1, pooled.shape[1]
    s1 = pooled.new_zeros(L1, P).index_add(0, rows, pooled[:B])
    s2 = pooled.new_zeros(L1, P).index_add(0, rows, pooled[B:])
    rel = _relevant_rows(w_eff, tc.colmat, 1e-3) * tc.proto_valid[None, :]
    lt = (torch.log(torch.tanh(s1) + eps) + torch.log(torch.tanh(s2) + eps)) / 2.0
    numer = (-lt * rel) @ tc.node_onehot                             # (L+1, N)
    cnt = rel @ tc.node_onehot
    term = _per_node(numer, cnt)
    desc_valid = tc.under * (cnt > 0)
    return _total(tc, _per_node((term * desc_valid).sum(dim=0), desc_valid.sum(dim=0)))


def classification_loss(tc: TreeConsts, logits: torch.Tensor, ys: torch.Tensor,
                        multiplier: torch.Tensor, *, pipnet_sparsity: bool = True,
                        weighted: bool = True,
                        focal_gamma: Optional[float] = None) -> Loss:
    """Per-node weighted NLL on in-node rows of both views
    (ref pipnet/train.py:1153-1163, WeightedNLLLoss): softmax over each
    node's children of ``log1p(logits^m)`` (with ``pipnet_sparsity``); each
    row weighted by its child's class weight, a plain mean over rows."""
    B = logits.shape[0]
    z = torch.log1p(logits ** multiplier) if pipnet_sparsity else logits
    zc = z[:, tc.node_cols.reshape(-1)].reshape(B, *tc.node_cols.shape)   # (B, N, Cmax)
    zc = torch.where(tc.node_cols_valid[None], zc, torch.full_like(zc, float("-inf")))
    logp = torch.log_softmax(zc, dim=-1)
    slot = tc.leaf_slot[label_rows(ys, tc.num_leaves)]                  # (B, N)
    under = (slot >= 0).to(logits.dtype)
    picked = torch.gather(logp, -1, slot.clamp(min=0)[..., None])[..., 0]
    nll = -picked
    if focal_gamma is not None:
        nll = (1.0 - torch.exp(picked)) ** focal_gamma * nll
    if weighted:
        col = tc.node_cols[torch.arange(tc.num_nodes, device=slot.device)[None, :],
                           slot.clamp(min=0)]
        nll = nll * tc.node_weights[col]
    return _total(tc, _per_node((nll * under).sum(dim=0), under.sum(dim=0)))


def kernel_orth_loss(tree: TreeArrays, tc: TreeConsts, add_on_kernel: torch.Tensor,
                     w_eff: torch.Tensor, cap: Optional[float] = None) -> Loss:
    """Orthogonality of each node's class-relevant prototype kernels
    (ref pipnet/train.py:1136-1147, orth_dist 1408-1412), as the JAX package
    computes it: the masked (width x width) gram per bucket, with the rank
    correction ``||A^T A - I_D||^2 = ||A A^T - I_P||^2 - P_rel + D`` when
    P_rel >= D.  ``cap`` rescales a node's term above it to exactly ``cap``
    through a stop-gradient, a per-node gradient clip."""
    D = add_on_kernel.shape[0]
    rel = (w_eff > 1e-3).any(dim=0).float() * tc.proto_valid         # (P,)
    sq, nrel = [], []
    for b in tree.buckets:
        sl = slice(b.proto_offset, b.proto_offset + b.num_nodes * b.width)
        r = rel[sl].reshape(b.num_nodes, b.width)
        km = add_on_kernel[:, sl].reshape(D, b.num_nodes, b.width) * r[None]
        g = torch.einsum("dnw,dnv->nwv", km, km)
        eye = r[:, :, None] * r[:, None, :] * torch.eye(b.width, device=r.device)[None]
        sq.append(((g - eye) ** 2).sum(dim=(1, 2)))
        nrel.append(r.sum(dim=1))
    sq, nrel = torch.cat(sq), torch.cat(nrel)
    sq = torch.where(nrel >= D, sq - nrel + D, sq)
    per_node = torch.sqrt(sq.clamp(min=0.0))
    if cap is not None:
        per_node = per_node * (cap / per_node.detach().clamp(min=cap))
    return _total(tc, per_node)


def overspecificity_losses(tc: TreeConsts, pooled: torch.Tensor, ys: torch.Tensor,
                           w_eff: torch.Tensor, presence: torch.Tensor, *,
                           boost: Optional[float] = None, geometric_mean: bool = False,
                           sg_score: bool = True) -> Dict[str, torch.Tensor]:
    """Overspecificity mask-pruning and the presence-mask L1
    (ref pipnet/train.py:946-1015; weights 2.0 and 0.5 at 957-958).

    ``presence`` (P,) is the keep column of the soft Gumbel-softmaxed
    presence logits.  score(p) = product over the in-batch leaf descendants
    of p's child of their batch-max pooled activation (boosted and clamped
    to 1, or the geometric mean); loss = -sum(score * presence) over the
    total relevant-prototype count."""
    L1 = tc.num_leaves + 1
    rows = label_rows(ys, tc.num_leaves)
    idx = rows[:, None].expand_as(pooled)
    maxs = pooled.new_zeros(L1, pooled.shape[1]).scatter_reduce(
        0, idx, pooled, "amax", include_self=False)                 # absent rows stay 0
    present = torch.zeros(L1, device=pooled.device).index_add(
        0, rows, torch.ones_like(rows, dtype=torch.float32)) > 0
    present[tc.num_leaves:].fill_(False)       # OOD row never counts (no host copy)
    maxs = torch.where(present[:, None], maxs, torch.zeros_like(maxs))

    vals = maxs if boost is None else (maxs * boost).clamp(max=1.0)
    logv = torch.log(vals.clamp(min=1e-30))
    member = ((tc.colmat == tc.proto_child_col[None, :]) & (tc.colmat >= 0)
              & present[:, None]).float()                           # (L+1, P)
    n_desc = member.sum(dim=0)
    logsum = (logv * member).sum(dim=0)
    if geometric_mean:
        logsum = logsum / n_desc.clamp(min=1.0)
    score = torch.where(n_desc > 0, torch.exp(logsum), torch.zeros_like(logsum))
    if sg_score:
        score = score.detach()

    rel = _relevant_rows(w_eff, tc.proto_child_col[None, :], 1e-3)[0] * tc.proto_valid
    total_rel = rel @ tc.node_onehot
    per_node_os = _per_node(-((score * presence * rel) @ tc.node_onehot), total_rel)
    per_node_l1 = _per_node((presence * rel * (n_desc > 0)) @ tc.node_onehot, total_rel)
    n = tc.num_nodes
    return {"overspecificity": 2.0 * per_node_os.sum() / n,
            "mask_l1": 0.5 * per_node_l1.sum() / n,
            "overspecificity_per_node": per_node_os,
            "mask_l1_per_node": per_node_l1}


def min_contrast_loss(tc: TreeConsts, pooled: torch.Tensor, ys: torch.Tensor,
                      w_eff: torch.Tensor, *, topk: int = 1) -> Loss:
    """Minimise the top-K activations of each child's prototypes over its
    contrasting set, the in-node samples not under that child
    (ref pipnet/train.py:1017-1060).  The mean runs over K x the relevant
    (> 1e-5) prototype columns of children with a non-empty contrast set,
    counting only the rows that exist."""
    rows = label_rows(ys, tc.num_leaves)
    pcol = tc.proto_child_col
    under_node = tc.under[rows][:, tc.proto_node]                    # (B, P)
    under_child = tc.child_leaf[rows][:, pcol.clamp(min=0)]          # (B, P)
    contrast = under_node * (1.0 - under_child)
    vals = torch.where(contrast > 0, pooled, torch.full_like(pooled, float("-inf")))
    top = torch.topk(vals.T, topk, dim=1).values                     # (P, K)
    valid_rows = torch.isfinite(top)
    rel = _relevant_rows(w_eff, pcol[None, :], 1e-5)[0] * tc.proto_valid
    col_ok = rel * (contrast.sum(dim=0) > 0)
    numer = torch.where(valid_rows, top, torch.zeros_like(top)).sum(dim=1) * col_ok
    denom = valid_rows.sum(dim=1) * col_ok
    return _total(tc, _per_node(numer @ tc.node_onehot, denom @ tc.node_onehot))


# ---------------------------------------------------------------------------
# global (non-tree) losses
# ---------------------------------------------------------------------------

def flatten_patches(features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B*H*W, D) (ref flatten_tensor, pipnet/train.py:1344-1349)."""
    return features.reshape(-1, features.shape[-1])


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize``'s semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


def _split_rows(shard):
    """``shard`` where it splits the batch over more than one data rank."""
    return shard if shard is not None and shard.mesh.n_data > 1 else None


def align_loss_unit_space(x: torch.Tensor, y: torch.Tensor, shard=None) -> torch.Tensor:
    """Mean of ||x - y||^2 over rows (Wang-Isola alignment at alpha = 2, the
    only value used, ref pipnet/train.py:1395-1396), as a sum of squares:
    the same value as the squared norm, but smooth where x == y, where the
    norm's gradient is NaN (two augmented views can coincide).  With
    ``shard`` (one view's ``BatchShard``) the rows are this rank's and the
    mean is over every rank's."""
    shard = _split_rows(shard)
    if shard is None:
        return ((x - y) ** 2).sum(dim=-1).mean()
    part = ((x - y) ** 2).sum(dtype=acc_dtype(x))
    return (shard.total(part) / shard.global_rows(x.shape[0])).to(x.dtype)


class _UniformPairSum(torch.autograd.Function):
    """S(x) = sum over i < j of exp(-t max(d2_ij, 0)) for the rows of x, in
    f32 (float64 for float64 x): K5 and K5b (``ops/uniform_pairs.py``) for
    CUDA rows, else the plain version by row blocks, whose backward
    recomputes each block."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, t: float, block: int) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.t, ctx.block = t, block
        return uniform_pairs(x, t, block)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return uniform_pairs_backward(x, g, ctx.t, ctx.block), None, None


class _UniformRowPairs(torch.autograd.Function):
    """One rank's share of ``_UniformPairSum`` on a mesh: half the sum over
    j != i of exp(-t max(d2_ij, 0)) for its rows i, ``xr``, which are the
    rows ``at:at + len(xr)`` of ``x`` (every rank's rows, no gradient).
    The ranks' shares add up to the pair sum, each for len(xr) * n pairs.
    The gradient for ``xr`` is the whole pair sum's (a pair's term counts
    for both its rows, where a share holds half of each); the forward
    computes it beside the sum (``ops/uniform_pairs.py::row_pairs``)."""

    @staticmethod
    def forward(ctx, xr: torch.Tensor, x: torch.Tensor, at: int, t: float,
                block: int) -> torch.Tensor:
        ctx.dtype = xr.dtype
        share, ctx.dx = row_pairs(xr, x, at, t, block, ctx.needs_input_grad[0])
        return share

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (ctx.dx * g).to(ctx.dtype), None, None, None, None


def uniform_loss(x: torch.Tensor, t: float = 2.0, block: int = UNIFORM_BLOCK,
                 shard=None) -> torch.Tensor:
    """log(mean over i < j of exp(-t ||x_i - x_j||^2) + 1e-10) over the rows
    of ``x`` (n, D) (ref pipnet/train.py:1376-1386), in f32 (float64 for
    float64 ``x``): the pair sum by K5 and K5b for CUDA rows, else by
    blocks of ``block`` rows (``_UniformPairSum``), so the n^2 distance
    matrix never exists at once.  With ``shard`` (one view's
    ``BatchShard``) the rows are this rank's, the pairs every rank's: the
    rank sums its rows' pairs against the gathered rows
    (``_UniformRowPairs``) and the ranks' sums are added."""
    shard = _split_rows(shard)
    if shard is None:
        n = x.shape[0]
        total = _UniformPairSum.apply(x, t, block)
    else:
        whole = shard.gather(x.detach())
        n = whole.shape[0]
        share = _UniformRowPairs.apply(x, whole, shard.mesh.data_rank * x.shape[0], t, block)
        total = shard.total(share)
    return torch.log(total / (n * (n - 1) / 2.0) + 1e-10)


def align_and_uniform(features: torch.Tensor, *, align: bool, uni: bool,
                      shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alignment of the two views' l2-normalised patch features and their
    mean uniformity (ref pipnet/train.py:898-928); ``features`` (2B, H, W,
    D) holds the views stacked.  A loss that is off is 0.  With ``shard``
    (a mesh's ``BatchShard`` of the two views) ``features`` are this
    rank's rows and the losses the global batch's."""
    f1, f2 = features.chunk(2, dim=0)
    x1, x2 = l2_normalize(flatten_patches(f1)), l2_normalize(flatten_patches(f2))
    view = None if shard is None else dataclasses.replace(shard, views=1)
    zero = torch.zeros((), dtype=torch.float32, device=features.device)
    a = align_loss_unit_space(x1, x2, view) if align else zero
    u = (uniform_loss(x1, shard=view) + uniform_loss(x2, shard=view)) / 2.0 if uni else zero
    return a, u


def entropy_loss(probs: torch.Tensor) -> torch.Tensor:
    """Mean entropy over the batch (ref pipnet/train.py:28-37)."""
    p = probs.clamp(min=1e-9)
    return (-(p * torch.log(p)).sum(dim=-1)).mean()


def ood_bce_loss(tc: TreeConsts, logits: torch.Tensor, ys: torch.Tensor,
                 multiplier: torch.Tensor) -> Loss:
    """Push the node logits of rows not under a node (OOD rows, label -1,
    are under none) towards 0: BCE(sigmoid(log1p(logits^m)), 0) =
    softplus(log1p(logits^m)), averaged over (rows not under the node) x
    (the node's children) (ref pipnet/train.py:1166-1178)."""
    B = logits.shape[0]
    bce = torch.nn.functional.softplus(torch.log1p(logits ** multiplier))    # (B, C)
    not_under = (1.0 - tc.under[label_rows(ys, tc.num_leaves)])[:, :, None]  # (B, N, 1)
    bce_n = bce[:, tc.node_cols.reshape(-1)].reshape(B, *tc.node_cols.shape)
    valid = tc.node_cols_valid[None].to(bce.dtype)
    num = (bce_n * not_under * valid).sum(dim=(0, 2))
    den = (not_under * valid).sum(dim=(0, 2))
    return _total(tc, _per_node(num, den))


def ood_entropy_loss(tc: TreeConsts, logits: torch.Tensor, ys: torch.Tensor,
                     multiplier: torch.Tensor) -> Loss:
    """Mean per-node softmax entropy over the rows not under the node.  The
    reference's ``--OOD_ent`` flag exists (util/args.py:251-255) but its live
    loss never fills ``OOD_ent_loss`` (only a dead copy computes it,
    pipnet/pipnet.py:840-851): like the JAX package, the port provides it
    here and no loss total reads it."""
    B = logits.shape[0]
    z = torch.log1p(logits ** multiplier)
    zc = z[:, tc.node_cols.reshape(-1)].reshape(B, *tc.node_cols.shape)
    zc = torch.where(tc.node_cols_valid[None], zc, torch.full_like(zc, float("-inf")))
    p = torch.softmax(zc, dim=-1)
    plogp = torch.where(p > 0, p * torch.log(p.clamp(min=1e-9)), torch.zeros_like(p))
    not_under = 1.0 - tc.under[label_rows(ys, tc.num_leaves)]
    return _total(tc, _per_node((-plogp.sum(dim=-1) * not_under).sum(dim=0),
                                not_under.sum(dim=0)))


def byol_regression_loss(online: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BYOL's normalised MSE between the crossed views, per patch (ref
    regression_loss pipnet/train.py:1414-1419 and its use at 887-893):
    ``online`` and ``target`` (2B, H, W, D) hold the two views stacked; each
    view's online output regresses the other view's target (detached), both
    l2-normalised over D (``F.normalize``'s eps 1e-12)."""
    o1, o2 = online.chunk(2, dim=0)
    t1, t2 = target.detach().chunk(2, dim=0)

    def reg(x, y):
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
        yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-12)
        return ((xn - yn) ** 2).sum(dim=-1).mean()

    return (reg(o1, t2) + reg(o2, t1)) / 2.0
