"""Per-test-image prediction explanations.

Counterpart of the JAX package's ``interp/prediction.py`` (itself
``util/visualize_prediction.py:19-169``): for one image, the top predicted
classes with, per contributing prototype, the evidence ``similarity x
weight``, the activating patch crop with bounding box, and a JET heatmap
overlay — written into one folder per image, with the JAX package's folder
layout and file names."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..device import host_to_device
from ..models.pipnet import PIPNet, joint_leaf_log_distribution
from ..tree.compile import TreeArrays
from .heatmaps import denormalize, draw_patch_box, overlay_heatmap
from .patches import get_img_coordinates, get_patch_size


def explain_image(model: PIPNet, tree: TreeArrays, x: np.ndarray, out_dir: str, *,
                  image_size: int, top_classes: int = 3, min_evidence: float = 1e-3,
                  raw_image: Optional[np.ndarray] = None) -> Dict:
    """Explain one normalized image (H,W,3): one forward (K1 on the card)
    with the inference threshold at B = 1, on the model's device.  Writes:

    out_dir/
      <rank>_<class>_<prob>/ evidence patches ``p<idx>_sim<...>_w<...>.png``
      heatmap_p<idx>.png for each contributing prototype
    Returns the explanation structure for programmatic use.
    """
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(host_to_device(np.ascontiguousarray(x[None], np.float32), dev),
                    inference=True)
        logits = out["logits"].float()
        # the decode runs on the f32 logits, as the JAX package decodes the
        # logits it fetched and cast
        logp = joint_leaf_log_distribution(logits, tree)
        w_eff = model.head.effective_cls_weight()
        pooled = out["pooled"][0].float().cpu().numpy()
        pf = out["proto_features"][0].float().cpu().numpy()          # (H, W, P)
        logp = logp[0].cpu().numpy()
        w_eff = w_eff.float().cpu().numpy()
    order = np.argsort(-logp)[:top_classes]

    latent_hw = pf.shape[:2]
    patchsize, skip = get_patch_size(image_size, latent_hw[1])
    img = denormalize(x) if raw_image is None else raw_image

    result: Dict = {"classes": []}
    os.makedirs(out_dir, exist_ok=True)
    for rank, cls_idx in enumerate(order):
        cls_name = tree.class_names[cls_idx]
        cdir = os.path.join(out_dir, f"{rank}_{cls_name}_{np.exp(logp[cls_idx]):.3f}")
        os.makedirs(cdir, exist_ok=True)
        # evidence: along the path root->leaf, every node's child column
        contributions: List[Tuple[int, float, float]] = []
        for ni in range(tree.num_nodes):
            col = tree.leaf_child_col[cls_idx, ni]
            if col < 0:
                continue
            sl = tree.node_proto_slice(ni)
            for p in range(sl.start, sl.stop):
                ev = pooled[p] * w_eff[col, p]
                if ev > min_evidence:
                    contributions.append((p, float(pooled[p]), float(w_eff[col, p])))
        contributions.sort(key=lambda t: -t[1] * t[2])
        cls_entry = {"name": cls_name, "score": float(np.exp(logp[cls_idx])),
                     "evidence": []}
        for p, sim, w in contributions[:10]:
            hw = int(np.argmax(pf[..., p]))
            h_idx, w_idx = hw // latent_hw[1], hw % latent_hw[1]
            box = get_img_coordinates(image_size, latent_hw, patchsize, skip,
                                      h_idx, w_idx)
            h0, h1, w0, w1 = box
            patch = img[h0:h1, w0:w1]
            Image.fromarray(patch).save(
                os.path.join(cdir, f"p{p}_sim{sim:.3f}_w{w:.3f}_patch.png"))
            boxed = draw_patch_box(Image.fromarray(img.copy()), box)
            boxed.save(os.path.join(cdir, f"p{p}_sim{sim:.3f}_w{w:.3f}_rect.png"))
            hm = overlay_heatmap(img, pf[..., p])
            Image.fromarray(hm).save(os.path.join(cdir, f"heatmap_p{p}.png"))
            cls_entry["evidence"].append({"prototype": int(p), "similarity": sim,
                                          "weight": w, "box": box})
        result["classes"].append(cls_entry)
    return result
