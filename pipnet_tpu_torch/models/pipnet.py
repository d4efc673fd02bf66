"""PIPNet: backbone + stacked prototype head, and the joint leaf decode.

Counterpart of the JAX package's ``models/pipnet.py`` (itself the reference
``PIPNet``, ``pipnet/pipnet.py:54-185``): the ConvNeXt backbones (each
block's branch through K4 under ``use_pallas_backbone``, or with the
Gaussian multiplier on some stages' depthwise kernels), the ResNets with
their BatchNorm statistics and DINOv2 ViT-S/14, the optional stage-4
reducer (dense layers after the backbone, whose last width the head
takes), the prototype head over K1 (or K2 for a training step that fuses
align_pf; the head variants on the composed operations), BYOL's projector
and predictor, the vectorized joint distribution over leaves, and the
overspecificity mask's presence sample and degenerate-node verdict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.segment import gumbel_noise, segment_hard_gumbel, tree_tensor
from ..runtime.mesh import BatchShard
from ..runtime.profiling import span
from ..tree.compile import TreeArrays, compile_tree
from ..tree.node import Node
from .byol import TARGET_PREFIXES, PatchMLP
from .convnext import convnext_tiny_7, convnext_tiny_13, convnext_tiny_26
from .heads import PrototypeHead
from .resnet import (resnet18_features, resnet34_features, resnet50_features,
                     resnet50_features_inat, resnet101_features, resnet152_features)
from .vit import dinov2_vits14

BACKBONES = {
    "convnext_tiny_26": (convnext_tiny_26, 768),
    "convnext_tiny_13": (convnext_tiny_13, 768),
    "convnext_tiny_7": (convnext_tiny_7, 768),
    "resnet18": (resnet18_features, 512),
    "resnet34": (resnet34_features, 512),
    "resnet50": (resnet50_features, 2048),
    "resnet50_inat": (resnet50_features_inat, 2048),
    "resnet101": (resnet101_features, 2048),
    "resnet152": (resnet152_features, 2048),
    "dinov2_vits14": (dinov2_vits14, 384),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Stage4Reducer(nn.Module):
    """The optional channel reducer after the backbone (ref
    pipnet/pipnet.py:1167-1183, ``--stage4_reducer_net 'in,out,gelu|...'``):
    a stack of 1x1 convolutions, dense layers ``reducer{i}`` over the last
    axis here (the JAX package's names), each followed by the exact GELU
    where its flag is set, computed in the compute dtype."""

    def __init__(self, layers):
        super().__init__()
        self.layers = tuple((int(cin), int(cout), bool(gelu)) for cin, cout, gelu in layers)
        for i, (cin, cout, _) in enumerate(self.layers):
            self.add_module(f"reducer{i}", nn.Linear(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (cin, _, gelu) in enumerate(self.layers):
            if x.shape[-1] != cin:
                raise ValueError(f"reducer layer {i} expects {cin} channels, got {x.shape[-1]}")
            dense = getattr(self, f"reducer{i}")
            x = torch.nn.functional.linear(x, dense.weight.to(x.dtype), dense.bias.to(x.dtype))
            if gelu:
                x = torch.nn.functional.gelu(x)
        return x


class PIPNet(nn.Module):
    """Hierarchical prototype network over a compiled tree."""

    def __init__(self, tree: TreeArrays, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone}; options: {list(BACKBONES)}")
        self.tree, self.cfg = tree, cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        ctor, channels = BACKBONES[cfg.backbone]
        if cfg.gaussian_stages and not cfg.backbone.startswith("convnext"):
            raise ValueError("gaussian multiplier surgery is a ConvNeXt-only option "
                             "(ref pipnet/pipnet.py:1142-1143)")
        if cfg.backbone.startswith("convnext"):
            # with the Gaussian multiplier no block is fused, as in the JAX
            # package, which builds that backbone without its Pallas blocks
            self.backbone = ctor(dtype=self.dtype, fast_gelu=cfg.fast_gelu,
                                 fused=cfg.use_pallas_backbone,
                                 gaussian_stages=tuple(cfg.gaussian_stages),
                                 gaussian_sigma=cfg.gaussian_sigma,
                                 gaussian_factor=cfg.gaussian_factor)
        elif cfg.use_pallas_backbone:
            raise ValueError(f"use_pallas_backbone fuses ConvNeXt blocks (K4); backbone "
                             f"{cfg.backbone!r} has none")
        else:
            self.backbone = ctor(dtype=self.dtype)
        if cfg.stage4_reducer:
            if cfg.use_byol:
                raise ValueError("BYOL with a stage-4 reducer: the JAX package's EMA target "
                                 "holds no reducer (train/step.py:160-166)")
            self.reducer = Stage4Reducer(cfg.stage4_reducer)
            channels = cfg.stage4_reducer[-1][1]
        self.head = PrototypeHead(tree, cfg.head, channels)
        if cfg.use_byol:
            self.projector = PatchMLP(channels)
            self.predictor = PatchMLP(channels)

    def features(self, xs: torch.Tensor, *, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 shard: Optional[BatchShard] = None) -> torch.Tensor:
        with span("backbone"):
            f = self.backbone(xs, train=train, generator=generator, shard=shard)
            return self.reducer(f) if self.cfg.stage4_reducer else f

    def forward(self, xs: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                inference: bool = False, apply_overspecificity_mask: bool = False,
                keep: Optional[torch.Tensor] = None,
                fuse_align_pf: bool = False,
                with_byol: bool = False,
                gumbel_noise: Optional[torch.Tensor] = None,
                shard: Optional[BatchShard] = None) -> Dict[str, torch.Tensor]:
        """xs (B, S, S, 3) -> {'features', 'proto_features', 'pooled',
        'logits'} with layouts (B,H,W,D), (B,H,W,P), (B,P), (B,C).  ``train``
        turns stochastic depth on, drawing from ``generator``, and
        normalises BatchNorm layers with the batch's statistics, updating
        their running ones.  ``apply_overspecificity_mask`` masks pooled
        with the presence sample ``keep`` (P,) (``presence_keep``).
        ``fuse_align_pf`` (two stacked views): 'align_pf_logsum' (B/2, N)
        replaces 'proto_features' (K2; see ``PrototypeHead``).
        ``with_byol`` adds 'byol_online' = predictor(projector(features))
        (ref pipnet_byol/pipnet_byol.py:105-110).  ``gumbel_noise`` is the
        Gumbel-softmax head's sample (``PrototypeHead``).  ``shard``: ``xs``
        is this rank's rows of a batch split over a mesh
        (``runtime/mesh.py``); stochastic depth and BatchNorm then act on
        the whole batch.  A head split over the model axis
        (``PrototypeHead.shard_columns``) returns its rank's columns of
        'proto_features' and 'pooled', and the whole 'logits'; 'features'
        (this rank's rows, whole) feed the head through
        ``Mesh.to_model`` and every other reader directly, so their
        gradient counts the head's columns once each and the rest once."""
        f = self.features(xs, train=train, generator=generator, shard=shard)
        with span("head"):
            out = self.head(f, inference=inference,
                            apply_overspecificity_mask=apply_overspecificity_mask,
                            keep=keep, fuse_align_pf=fuse_align_pf, gumbel_noise=gumbel_noise)
        out["features"] = f
        if with_byol:
            if not self.cfg.use_byol:
                raise ValueError("model built without use_byol")
            out["byol_online"] = self.predictor(self.projector(f, train=train, shard=shard),
                                                train=train, shard=shard)
        return out

    @torch.no_grad()
    def byol_target_projection(self, xs: torch.Tensor,
                               target: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The target branch, projector(backbone(xs)) with the EMA target's
        parameters ``target`` (``backbone.*``, ``projector.*``), in
        inference mode: BatchNorm layers normalise with the online model's
        running statistics as they stand (ref pipnet_byol/pipnet_byol.py:110;
        the JAX step hands the target ``state.batch_stats``)."""
        from torch.func import functional_call
        bb, proj = ({n[len(pre):]: t for n, t in target.items() if n.startswith(pre)}
                    for pre in TARGET_PREFIXES)
        f = functional_call(self.backbone, bb, (xs,), {"train": False})
        return functional_call(self.projector, proj, (f,), {"train": False})


# ----------------------------------------------------------------------------
# the overspecificity mask
# ----------------------------------------------------------------------------

def presence_keep(presence: torch.Tensor, seed: int, num: Optional[int] = None,
                  columns=None) -> torch.Tensor:
    """Hard-Gumbel presence samples of the overspecificity mask (the
    reference's ``F.gumbel_softmax(proto_presence, tau=0.5, hard=True)[:, 1]``,
    pipnet/pipnet.py:165): ``keep`` (P,), or with ``num`` (num, P) drawn in
    one go, on ``presence``'s device.  The Gumbel noise comes from a CPU
    ``torch.Generator`` seeded ``seed`` and the sample is computed bit for
    bit alike on every device (``ops/segment.py::segment_hard_gumbel``), so
    a seed gives the same pruned model on the CPU and on the card.  With
    ``columns`` (a model rank's ``ops/segment.py::ProtoColumns``)
    ``presence`` is the rank's rows of the (P, 2) logits: the noise is
    drawn for the whole of P, as on every rank, and the rank keeps its
    columns of the sample."""
    whole = tuple(presence.shape)
    if columns is not None:
        whole = (columns.tree.num_protos_padded, *whole[1:])
    shape = whole if num is None else (num, *whole)
    noise = gumbel_noise(shape, torch.Generator().manual_seed(seed))
    if columns is not None:
        noise = noise[..., columns.lo:columns.hi, :]
    with torch.no_grad():
        return segment_hard_gumbel(presence.detach().float(), None, tau=0.5,
                                   noise=noise.to(presence.device))[..., 1]


def degenerate_nodes_traced(masked_w: torch.Tensor, tree: TreeArrays) -> torch.Tensor:
    """(N,) bool from the presence-masked effective classifier: a node is
    degenerate when ANY of its child classes keeps no weight > 1e-3 (ref
    util/node.py:342-347).  ``masked_w`` is ``effective_cls_weight() *
    keep[None, :]`` (C, P); child rows are contiguous per node, so the
    per-node ANY adds each row's verdict into its node, on ``masked_w``'s
    device."""
    row_node = tree_tensor(tree, "row_node", np.repeat(np.arange(tree.num_nodes),
                                                       tree.node_num_children),
                           masked_w.device, torch.long)
    row_deg = (masked_w.amax(dim=1) <= 1e-3).to(torch.float32)
    hits = torch.zeros(tree.num_nodes, device=masked_w.device).index_add_(0, row_node, row_deg)
    return hits > 0


def masked_decode_degenerates(model: PIPNet, tree: TreeArrays,
                              keep: torch.Tensor) -> torch.Tensor:
    """The degenerate-node verdict of a masked decode from the SAME presence
    sample ``keep`` the head's forward used, so the pooled masking and the
    leaf-count-prior fallback (ref util/node.py:336-361) agree.  The
    reference draws a second, independent sample inside its decode; the
    JAX package reuses the forward's (``train/step.py:362-368``), and so
    does the port."""
    w = model.head.effective_cls_weight()
    return degenerate_nodes_traced(w * keep.to(w.dtype)[None, :], tree)


# ----------------------------------------------------------------------------
# joint distribution over leaves
# ----------------------------------------------------------------------------

def leave_out_decode_tables(tree: TreeArrays, leave_out_idx) -> tuple:
    """Static tables implementing the reference's leave-out-class (LOU)
    short-circuit (``util/node.py:319-326``): at a node where ANY child's
    entire leaf set is left out, the whole subtree distribution is replaced by
    a deterministic indicator on that node's first left-out LEAF child.  The
    recursion is top-down, so only the TOPMOST triggering node on a leaf's
    root path applies.

    Returns ``(use_mask (L, N) f32, extra (L,) f32)``: a leaf's log joint is
    the sum of its path edges where ``use_mask`` is 1 plus ``extra``
    (0 for the chosen indicator leaf, -inf for other leaves under a trigger).
    """
    L, N = tree.leaf_under_node.shape
    lo = np.zeros(L, bool)
    lo[np.asarray(list(leave_out_idx), np.int64)] = True
    under = tree.leaf_under_node.astype(bool)                       # (L, N)
    child_leaf = tree.child_leaf_matrix.astype(bool)                # (L, C)

    trigger = np.zeros(N, bool)
    chosen = np.full(N, -1, np.int64)
    for ni in range(N):
        cs = tree.node_child_slice(ni)
        cols = np.arange(cs.start, cs.stop)
        full_out = [c for c in cols
                    if child_leaf[:, c].any() and lo[child_leaf[:, c]].all()]
        if not full_out:
            continue
        trigger[ni] = True
        leaf_cols = [c for c in cols
                     if tree.child_leaf_class[c] >= 0
                     and lo[tree.child_leaf_class[c]]]
        if not leaf_cols:
            raise ValueError(
                f"node {tree.node_names[ni]}: an internal child subtree is "
                "fully left out but no direct leaf child is left out — the "
                "reference decode is undefined here (util/node.py:319-326)")
        chosen[ni] = int(tree.child_leaf_class[leaf_cols[0]])

    # depth = number of strict ancestors (nodes with a strict leafset superset)
    sizes = under.sum(axis=0)
    depth = np.zeros(N, np.int64)
    for n in range(N):
        for m in range(N):
            if m != n and sizes[m] > sizes[n] and not (under[:, n] & ~under[:, m]).any():
                depth[n] += 1

    use = under.copy()
    extra = np.zeros(L, np.float32)
    for leaf in range(L):
        path = np.flatnonzero(under[leaf])
        trig = [n for n in path if trigger[n]]
        if not trig:
            continue
        top = min(trig, key=lambda n: depth[n])
        for n in path:
            if depth[n] >= depth[top]:
                use[leaf, n] = False        # T's edge and everything below
        extra[leaf] = 0.0 if leaf == chosen[top] else -np.inf
    return use.astype(np.float32), extra


def _child_columns(tree: TreeArrays) -> np.ndarray:
    """(N, Cmax) global child column per (node, child slot), -1 past the end."""
    cols = np.full((tree.num_nodes, tree.max_children), -1, np.int64)
    for ni in range(tree.num_nodes):
        cn = int(tree.node_num_children[ni])
        cols[ni, :cn] = np.arange(tree.node_child_offset[ni],
                                  tree.node_child_offset[ni] + cn)
    return cols


def _leaf_count_prior(tree: TreeArrays) -> np.ndarray:
    """(N, Cmax) log leaf-count prior per child slot (degenerate nodes)."""
    prior = np.zeros((tree.num_nodes, tree.max_children), np.float32)
    for ni in range(tree.num_nodes):
        cn = int(tree.node_num_children[ni])
        counts = tree.child_num_leaves[
            tree.node_child_offset[ni]: tree.node_child_offset[ni] + cn]
        prior[ni, :cn] = np.log(counts / counts.sum())
    return prior


def joint_leaf_log_distribution(logits: torch.Tensor, tree: TreeArrays,
                                softmax_tau: float = 1.0,
                                degenerate_nodes=None,
                                leave_out_idx=None) -> torch.Tensor:
    """Log joint distribution over the fine classes, (B, C) -> (B, L).

    Vectorized form of the reference's recursive
    ``distribution_over_furthest_descendents`` (``util/node.py:300-395``):
    at every node, child probabilities are ``softmax(log1p(out^2)/tau)``; a
    leaf's joint probability is the product along its root-to-leaf path:

        logp[leaf] = sum over nodes n with leaf under n of
                     log_softmax_n(log1p(out_n^2)/tau)[child_col(leaf, n)]

    Classes are ordered by sorted name.  ``degenerate_nodes`` (N,) bool falls
    back to leaf-count priors at those nodes (ref util/node.py:336-361);
    ``leave_out_idx`` applies the LOU short-circuit
    (``leave_out_decode_tables``).
    """
    dev = logits.device
    C = logits.shape[1]
    cols = _child_columns(tree)
    z = torch.log1p(logits ** 2) / softmax_tau
    idx = tree_tensor(tree, "decode_cols", np.clip(cols, 0, C - 1), dev, torch.long)
    valid = tree_tensor(tree, "decode_valid", cols >= 0, dev, torch.bool)
    zc = z[:, idx]                                                    # (B, N, Cmax)
    zc = torch.where(valid[None], zc, torch.full_like(zc, float("-inf")))
    logp_children = torch.log_softmax(zc, dim=-1)

    if degenerate_nodes is not None:
        prior = tree_tensor(tree, "decode_prior", _leaf_count_prior(tree), dev,
                            logp_children.dtype)
        deg = torch.as_tensor(degenerate_nodes, device=dev).reshape(1, -1, 1)
        logp_children = torch.where(deg, prior[None], logp_children)

    slot = tree_tensor(tree, "decode_slot",
                       np.where(tree.leaf_child_slot >= 0, tree.leaf_child_slot, 0),
                       dev, torch.long)                               # (L, N)
    if leave_out_idx is not None and len(leave_out_idx) > 0:
        # the tables take a Python loop over node pairs: built once per
        # leave-out set and device, not per batch
        lo = tuple(sorted({int(i) for i in leave_out_idx}))
        tables = tree.__dict__.setdefault("_leave_out_tables", {})
        if lo not in tables:
            tables[lo] = leave_out_decode_tables(tree, lo)
        under = tree_tensor(tree, f"decode_lou_use{lo}", tables[lo][0] > 0, dev, torch.bool)
        extra = tree_tensor(tree, f"decode_lou_extra{lo}", tables[lo][1], dev,
                            torch.float32)[None]
    else:
        under = tree_tensor(tree, "decode_under", tree.leaf_under_node, dev, torch.bool)
        extra = 0.0
    node = torch.arange(tree.num_nodes, device=dev)[None, :].expand_as(slot)
    g = logp_children[:, node, slot]                                  # (B, L, N)
    g = torch.where(under[None], g, torch.zeros_like(g))
    return g.sum(dim=-1) + extra


def joint_leaf_distribution(logits: torch.Tensor, tree: TreeArrays,
                            softmax_tau: float = 1.0) -> torch.Tensor:
    return torch.exp(joint_leaf_log_distribution(logits, tree, softmax_tau))


# ----------------------------------------------------------------------------
# construction helpers
# ----------------------------------------------------------------------------

def assign_prototype_budgets(root: Node, cfg: ModelConfig) -> None:
    """Apply the per-node budget rule of the reference's main.py:148-155."""
    if cfg.num_features == 0 and cfg.num_protos_per_descendant == 0 and cfg.num_protos_per_child == 0:
        raise ValueError("one of num_features / num_protos_per_descendant / num_protos_per_child must be > 0")
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=cfg.num_protos_per_descendant,
                            num_protos_per_child=cfg.num_protos_per_child,
                            min_protos=cfg.num_features,
                            split_protos=not cfg.head.protopool)


def build_pipnet(root: Node, cfg: ModelConfig, *, weighted: bool = False,
                 class_names: Sequence[str] = None,
                 device: Union[str, torch.device] = "cuda") -> Tuple[PIPNet, TreeArrays]:
    """Budget the tree, compile it, and construct the model on ``device``
    (the card unless the caller asks for the CPU).  Parameters come from a
    checkpoint (``run_io.load_run``) or ``models/convert.py``."""
    dev = resolve_device(device)
    assign_prototype_budgets(root, cfg)
    tree = compile_tree(root, class_names=class_names,
                        protopool=cfg.head.protopool, weighted=weighted)
    return PIPNet(tree, cfg).to(dev).eval(), tree


def latent_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """Static latent (H, W) for an image_size."""
    s = cfg.image_size
    if cfg.backbone.startswith("resnet"):
        return (s // 8, s // 8)     # stride-1 layer3/4
    if cfg.backbone.startswith("dinov2"):
        return (s // 14, s // 14)   # ViT-S/14 patch grid (ref pipnet.py:1137)
    if not cfg.backbone.startswith("convnext"):
        raise ValueError(cfg.backbone)
    s4 = s // 4
    if cfg.backbone.endswith("_26"):
        h = (s4 - 2) // 2 + 1   # down1 stride 2
        h = h - 1               # down2 stride 1, k2 VALID
        h = h - 1               # down3 stride 1
    elif cfg.backbone.endswith("_13"):
        h = (s4 - 2) // 2 + 1
        h = (h - 2) // 2 + 1
        h = h - 1
    else:
        h = s // 32
    return (h, h)
