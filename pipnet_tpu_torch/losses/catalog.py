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
once per step (by the caller).  Not ported yet (they raise in
``aggregate.py``): the align/uniform feature losses, the OOD losses and the
entropy loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
