"""Interpretability: projection, galleries, pruning, part purity, prediction
explanations, adversarial robustness, MIPS (the JAX package's ``interp``
on the port's model: its forwards run K1, its gradients K1b, on the card)."""

from .adversarial import adversarial_attack, adversarial_locs_mask
from .heatmaps import (denormalize, draw_patch_box, jet_heatmap,
                       overlay_heatmap, save_image_grid, save_topk_gallery)
from .hierarchy_viz import nondescendant_topk, save_hierarchy_galleries
from .mips import PatchIndex, build_patch_index, mips_query
from .part_purity import eval_prototypes_parts_csv, write_topk_patch_csv
from .patches import get_img_coordinates, get_patch_size
from .prediction import explain_image
from .pruning import presence_prune_mask, prototype_report, threshold_prune
from .topk import (ProjectionResult, make_projection_step, run_projection,
                   topk_per_prototype, topk_per_prototype_per_leaf)

__all__ = [
    "adversarial_attack", "adversarial_locs_mask",
    "denormalize", "draw_patch_box", "jet_heatmap", "overlay_heatmap",
    "save_image_grid", "save_topk_gallery",
    "nondescendant_topk", "save_hierarchy_galleries",
    "PatchIndex", "build_patch_index", "mips_query",
    "eval_prototypes_parts_csv", "write_topk_patch_csv",
    "get_img_coordinates", "get_patch_size", "explain_image",
    "presence_prune_mask", "prototype_report", "threshold_prune",
    "ProjectionResult", "make_projection_step", "run_projection",
    "topk_per_prototype", "topk_per_prototype_per_leaf",
]
