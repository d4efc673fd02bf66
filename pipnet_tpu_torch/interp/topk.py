"""Prototype projection: sweep a loader, collect per-image pooled activations
and argmax patch locations for every prototype.

Counterpart of the JAX package's ``interp/topk.py`` (the visualization data
collection of ``util/vis_pipnet.py:21-241``, ``util/vis_hpipnet.py:184-305``
and ``prune_by_threshold.ipynb`` cell 11): instead of bs=1 loops per node,
one batched forward (K1 on the card) returns, for ALL prototypes at once,
pooled (B, P), the argmax latent locations, and the cosine similarity and
softmax values gathered AT the argmax (the reference's
``findCorrespondingToMax``, pipnet/pipnet.py:24-32).  ``torch.argmax``, like
``jnp.argmax``, returns the first maximum.  Top-k selection then happens on
the host over the collected arrays (numpy, copied).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import host_to_device
from ..models.pipnet import PIPNet
from ..tree.compile import TreeArrays
from .patches import get_img_coordinates, get_patch_size


def make_projection_step(model: PIPNet, tree: TreeArrays) -> Callable:
    """``step(xs) -> {'pooled', 'h_idx', 'w_idx', 'cs_at_max', 'pf_at_max',
    'proto_features', 'logits'}``: the per-prototype projection record of
    the images ``xs`` (B, S, S, 3) on the model's device, without
    gradients."""

    @torch.no_grad()
    def step(xs: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(xs, train=False)
        pf = out["proto_features"]                       # (B, H, W, P)
        B, H, W, P = pf.shape
        flat = pf.reshape(B, H * W, P)
        idx = flat.argmax(dim=1)                         # (B, P)
        # cosine similarity gathered at the softmax argmax (vis_hpipnet:117-121)
        cs = model.head.cosine_maps(out["features"]).reshape(B, H * W, P)
        cs_at_max = cs.gather(1, idx[:, None, :])[:, 0, :]
        pf_at_max = flat.gather(1, idx[:, None, :])[:, 0, :]
        return {"pooled": out["pooled"], "h_idx": idx // W, "w_idx": idx % W,
                "cs_at_max": cs_at_max, "pf_at_max": pf_at_max,
                "proto_features": pf, "logits": out["logits"]}

    return step


@dataclasses.dataclass
class ProjectionResult:
    """Projection sweep over a loader: everything needed for top-k galleries,
    pruning and part-purity CSVs."""
    pooled: np.ndarray         # (n, P)
    h_idx: np.ndarray          # (n, P)
    w_idx: np.ndarray          # (n, P)
    cs_at_max: np.ndarray      # (n, P)
    ys: np.ndarray             # (n,)
    paths: List[str]
    latent_hw: Tuple[int, int]
    image_size: int

    def patch_box(self, image_idx: int, proto: int) -> Tuple[int, int, int, int]:
        patchsize, skip = get_patch_size(self.image_size, self.latent_hw[1])
        return get_img_coordinates(self.image_size, self.latent_hw, patchsize, skip,
                                   int(self.h_idx[image_idx, proto]),
                                   int(self.w_idx[image_idx, proto]))


def run_projection(model: PIPNet, tree: TreeArrays, loader, *, image_size: int,
                   batch_size: int = 32) -> ProjectionResult:
    """Sweep the (unshuffled) projection loader.

    The loader's dataset must expose ``folder.samples`` for image paths
    (matching the reference's projectloader with bs=1, shuffle=False —
    util/data.py:627-634).  Its one-image batches are gathered into batches
    of ``batch_size``, each sent to the model's device once from pinned
    memory; the records stay on the device and come back in one copy after
    the sweep (pooled, the flat argmax index and cs_at_max in float32, each
    exact there: the index is below 2^24)."""
    step = make_projection_step(model, tree)
    dev = next(model.parameters()).device
    records, ys, buf_x = [], [], []
    latent_hw = None

    def flush():
        nonlocal latent_hw
        if not buf_x:
            return
        out = step(host_to_device(np.stack(buf_x), dev))
        W = out["proto_features"].shape[2]
        latent_hw = tuple(out["proto_features"].shape[1:3])
        records.append(torch.stack([out["pooled"].float(),
                                    (out["h_idx"] * W + out["w_idx"]).float(),
                                    out["cs_at_max"].float()], dim=1))
        buf_x.clear()

    for batch in loader.epoch(0):
        for i in range(len(batch.ys)):
            buf_x.append(batch.xs1[i])
            ys.append(int(batch.ys[i]))
            if len(buf_x) == batch_size:
                flush()
    flush()

    host = torch.cat(records).cpu().numpy()              # (n, 3, P)
    flat_idx = host[:, 1].astype(np.int32)
    folder = getattr(loader.dataset, "folder", None)
    paths = [p for p, _ in folder.samples] if folder is not None else []
    return ProjectionResult(
        pooled=np.ascontiguousarray(host[:, 0]), h_idx=flat_idx // latent_hw[1],
        w_idx=flat_idx % latent_hw[1], cs_at_max=np.ascontiguousarray(host[:, 2]),
        ys=np.asarray(ys), paths=paths, latent_hw=latent_hw, image_size=image_size)


def topk_per_prototype(proj: ProjectionResult, k: int = 10,
                       threshold: Optional[float] = None) -> Dict[int, List[Tuple[int, float]]]:
    """Top-k (image_idx, score) per prototype (``visualize_topk`` first pass,
    util/vis_pipnet.py:21-120).  With ``threshold``, instead returns every
    image scoring above it (``visualize``, util/vis_pipnet.py:244-370)."""
    out = {}
    P = proj.pooled.shape[1]
    for p in range(P):
        col = proj.pooled[:, p]
        if threshold is not None:
            idx = np.nonzero(col > threshold)[0]
            idx = idx[np.argsort(-col[idx])]
        else:
            idx = np.argsort(-col)[:k]
        out[p] = [(int(i), float(col[i])) for i in idx]
    return out


def topk_per_prototype_per_leaf(proj: ProjectionResult, tree: TreeArrays,
                                w_eff: np.ndarray, k: int = 10
                                ) -> Dict[int, Dict[int, List[Tuple[int, float]]]]:
    """Per prototype, per RELEVANT leaf descendant, the top-k images of that
    leaf (the hierarchical gallery / pruning statistic,
    vis_hpipnet.py:268-288 & prune_by_threshold cell 11).

    Relevance: leaf classes under children whose classifier weight on the
    prototype exceeds 1e-3."""
    out: Dict[int, Dict[int, List[Tuple[int, float]]]] = {}
    P = proj.pooled.shape[1]
    # leaf classes relevant to each prototype: leaf under a child with w>1e-3
    thr = w_eff > 1e-3                                     # (C, P)
    leaf_by_class: Dict[int, np.ndarray] = {
        li: np.nonzero(proj.ys == li)[0] for li in range(tree.num_classes)}
    for p in range(P):
        if not tree.proto_valid[p]:
            continue
        ni = int(tree.proto_node[p])
        if ni < 0:
            continue
        cs = tree.node_child_slice(ni)
        rel_cols = np.nonzero(thr[cs, p])[0] + cs.start
        if len(rel_cols) == 0:
            continue
        leaf_mask = tree.child_leaf_matrix[:, rel_cols].sum(axis=1) > 0
        per_leaf = {}
        for li in np.nonzero(leaf_mask)[0]:
            rows = leaf_by_class[int(li)]
            if len(rows) == 0:
                continue
            col = proj.pooled[rows, p]
            order = np.argsort(-col)[:k]
            per_leaf[int(li)] = [(int(rows[i]), float(col[i])) for i in order]
        out[p] = per_leaf
    return out
