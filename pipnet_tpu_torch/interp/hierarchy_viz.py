"""Hierarchical prototype galleries.

The port's copy of the JAX package's ``interp/hierarchy_viz.py``, the
counterpart of ``util/vis_hpipnet.py:184-389`` (``save_images_topk``): per
node, per prototype, a gallery of the top-k activating patches for every
RELEVANT leaf descendant — and optionally for NON-descendants (evidence the
prototype leaks outside its clade) — with JET heatmap overlays and the
overspecificity verdict from the learned presence logits.  Only
``make_heatmap_forward`` differs: it runs the port's model."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from ..tree.compile import TreeArrays
from .heatmaps import draw_patch_box, overlay_heatmap, save_image_grid
from .pruning import presence_prune_mask
from .topk import ProjectionResult, topk_per_prototype_per_leaf

# the heatmap re-forward's largest batch (``make_heatmap_forward``)
MAX_BATCH = 64


def _load(proj: ProjectionResult, idx: int) -> np.ndarray:
    # the same top-activating images recur across prototypes/leaves/nodes —
    # a gallery sweep re-decodes each popular image hundreds of times
    # without this cache (~85 MB at 4096 224² entries).  Scoped to the
    # ProjectionResult (not module-global) so regenerating galleries after
    # the image files change can never serve stale pixels; it dies with
    # the projection object.
    cache = getattr(proj, "_decode_cache", None)
    if cache is None:
        cache = proj._decode_cache = {}
    out = cache.get(idx)
    if out is None:
        with Image.open(proj.paths[idx]) as im:
            im = im.convert("RGB").resize((proj.image_size, proj.image_size),
                                          Image.BILINEAR)
        out = np.asarray(im, np.uint8)
        if len(cache) >= 4096:              # bound RAM; FIFO eviction
            cache.pop(next(iter(cache)))
        cache[idx] = out
    return out


def nondescendant_topk(proj: ProjectionResult, tree: TreeArrays,
                       w_eff: np.ndarray, k: int = 5) -> Dict[int, List]:
    """Per prototype, top-k images among classes NOT under the prototype's
    relevant children (the 'non-descendants' gallery,
    vis_hpipnet find_non_descendants branch)."""
    out = {}
    thr = w_eff > 1e-3
    for p in range(proj.pooled.shape[1]):
        if not tree.proto_valid[p]:
            continue
        ni = int(tree.proto_node[p])
        cs = tree.node_child_slice(ni)
        rel_cols = np.nonzero(thr[cs, p])[0] + cs.start
        if len(rel_cols) == 0:
            continue
        leaf_in = tree.child_leaf_matrix[:, rel_cols].sum(axis=1) > 0
        rows = np.nonzero(~leaf_in[proj.ys])[0]
        if len(rows) == 0:
            continue
        col = proj.pooled[rows, p]
        order = np.argsort(-col)[:k]
        out[p] = [(int(rows[i]), float(col[i])) for i in order]
    return out


def make_heatmap_forward(model, tree: TreeArrays, proj: ProjectionResult):
    """Returns ``f(image_indices, proto_idx) -> (B, H, W)`` softmaxed maps of
    one prototype, by re-running the forward (K1 on the card) on the
    selected projection images: the maps are not retained during the
    projection sweep, so the gallery re-computes them for just the chosen
    top-k images (as the reference effectively does by running the whole viz
    forward per image, util/vis_hpipnet.py:62-127).

    The re-forward goes in chunks of at most ``MAX_BATCH`` images: a
    ROOT-node gallery gathers top-k images over every leaf descendant (190
    leaves x k = up to ~1900 images), whose maps as one batch would be ~10
    GB in bf16 at flagship shapes.  Each chunk's prototype column stays on
    the device; one copy brings them all back."""
    from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
    from ..device import host_to_device

    dev = next(model.parameters()).device
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)

    @torch.no_grad()
    def forward(image_indices, proto_idx):
        # decode via the shared u8 cache (EvalTransform == resize+normalize)
        xs = [(_load(proj, idx).astype(np.float32) / 255.0 - mean) / std
              for idx in image_indices]
        maps = []
        for start in range(0, len(xs), MAX_BATCH):
            batch = host_to_device(np.stack(xs[start:start + MAX_BATCH]), dev)
            maps.append(model(batch, train=False)["proto_features"][..., proto_idx].float())
        return torch.cat(maps).cpu().numpy()                 # (B, H, W)

    return forward


def save_hierarchy_galleries(proj: ProjectionResult, tree: TreeArrays,
                             w_eff: np.ndarray, proto_presence: np.ndarray,
                             out_dir: str, *, k: int = 10,
                             with_nondescendants: bool = True,
                             heatmaps: bool = True,
                             heatmap_forward=None,
                             nodes: Optional[List[int]] = None) -> List[str]:
    """Write per-node galleries; returns written paths.

    Layout: ``<out_dir>/<node>/prototype_<p>[_OVERSPECIFIC]/<leaf>.png`` grids
    of cropped argmax patches, plus ``<leaf>_heatmaps.png`` full-image JET
    overlays of the REAL softmaxed activation maps (ref
    util/vis_hpipnet.py:134-153) when ``heatmap_forward`` (see
    ``make_heatmap_forward``) is given — otherwise a peak-box marker;
    ``<node>/nondesc_prototype_<p>.png`` for the contrast galleries."""
    per_leaf = topk_per_prototype_per_leaf(proj, tree, w_eff, k=k)
    keep = presence_prune_mask(proto_presence)
    written: List[str] = []
    node_list = nodes if nodes is not None else range(tree.num_nodes)
    nd = (nondescendant_topk(proj, tree, w_eff, k=max(3, k // 2))
          if with_nondescendants else {})
    for ni in node_list:
        node_name = tree.node_names[ni]
        sl = tree.node_proto_slice(ni)
        for p in range(sl.start, sl.stop):
            if p not in per_leaf or not per_leaf[p]:
                continue
            verdict = "" if keep[p] > 0 else "_OVERSPECIFIC"
            pdir = os.path.join(out_dir, node_name, f"prototype_{p}{verdict}")
            for li, entries in per_leaf[p].items():
                patches, labels = [], []
                for img_idx, score in entries:
                    img = _load(proj, img_idx)
                    h0, h1, w0, w1 = proj.patch_box(img_idx, p)
                    patches.append(np.asarray(
                        Image.fromarray(img[h0:h1, w0:w1]).resize((64, 64))))
                    labels.append(f"{score:.2f}")
                if patches:
                    written.append(save_image_grid(
                        patches, os.path.join(pdir, f"{tree.class_names[li]}.png"),
                        labels=labels))
            if heatmaps and per_leaf[p]:
                if heatmap_forward is not None:
                    # real softmaxed-map JET overlays per leaf gallery
                    # (ref util/vis_hpipnet.py:134-153): one re-forward over
                    # the prototype's selected images
                    all_entries = [(li, idx) for li, es in per_leaf[p].items()
                                   for idx, _ in es]
                    uniq = sorted({idx for _, idx in all_entries})
                    maps = heatmap_forward(uniq, p)               # (B, H, W)
                    pos = {idx: i for i, idx in enumerate(uniq)}
                    for li, entries in per_leaf[p].items():
                        overlays, labels = [], []
                        for img_idx, score in entries:
                            img = _load(proj, img_idx)
                            overlays.append(overlay_heatmap(
                                img, maps[pos[img_idx]]))
                            labels.append(f"{score:.2f}")
                        if overlays:
                            written.append(save_image_grid(
                                overlays,
                                os.path.join(pdir,
                                             f"{tree.class_names[li]}_heatmaps.png"),
                                labels=labels))
                else:
                    # no forward available: peak marker box fallback
                    some_li = next(iter(per_leaf[p]))
                    if per_leaf[p][some_li]:
                        img_idx, _ = per_leaf[p][some_li][0]
                        img = _load(proj, img_idx)
                        boxed = draw_patch_box(Image.fromarray(img),
                                               proj.patch_box(img_idx, p))
                        path = os.path.join(pdir, "peak_patch.png")
                        os.makedirs(pdir, exist_ok=True)
                        boxed.save(path)
                        written.append(path)
        for p, entries in nd.items():
            if not (sl.start <= p < sl.stop):
                continue
            patches = []
            for img_idx, score in entries:
                img = _load(proj, img_idx)
                h0, h1, w0, w1 = proj.patch_box(img_idx, p)
                patches.append(np.asarray(
                    Image.fromarray(img[h0:h1, w0:w1]).resize((64, 64))))
            if patches:
                written.append(save_image_grid(
                    patches,
                    os.path.join(out_dir, node_name, f"nondesc_prototype_{p}.png")))
    return written
