"""Prototype part-purity evaluation against CUB keypoint annotations (the
port's copy of the JAX package's ``interp/part_purity.py``).

Counterpart of ``util/eval_cub_csv.py`` (and its per-node variant
``util/eval_cub_csv_hierarchy.py``): prototypes' top-k patch boxes are written
to CSV; purity of a prototype w.r.t. an annotated bird part = fraction of its
patches containing that part's keypoint (left/right parts merged by taking the
max presence); reported as mean/max purity and the count of part-related
prototypes (purity > 0.5).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from ..tree.compile import TreeArrays
from .topk import ProjectionResult, topk_per_prototype


def write_topk_patch_csv(proj: ProjectionResult, out_csv: str, *, k: int = 10,
                         tree: Optional[TreeArrays] = None,
                         w_eff: Optional[np.ndarray] = None,
                         node: Optional[int] = None) -> str:
    """The ``get_topk_cub`` CSV: per prototype, the top-k images' patch boxes
    in 224-resized coordinates (ref util/eval_cub_csv.py:178-240).  With
    ``node`` set, restrict to that node's prototypes (hierarchy variant)."""
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    topk = topk_per_prototype(proj, k=k)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["prototype", "img_name", "h_min_224", "h_max_224",
                    "w_min_224", "w_max_224"])
        for p, entries in topk.items():
            if node is not None and tree is not None:
                sl = tree.node_proto_slice(node)
                if not (sl.start <= p < sl.stop):
                    continue
            if w_eff is not None and w_eff[:, p].max() <= 1e-3:
                continue
            for img_idx, score in entries:
                h0, h1, w0, w1 = proj.patch_box(img_idx, p)
                w.writerow([p, proj.paths[img_idx], h0, h1, w0, w1])
    return out_csv


def _load_part_annotations(parts_loc_path: str, parts_name_path: str,
                           imgs_id_path: str):
    path_to_id = {}
    with open(imgs_id_path) as f:
        for line in f:
            iid, path = line.strip().split(" ")
            path_to_id[path] = iid
    img_parts: Dict[str, Dict[str, Tuple[float, float]]] = {}
    with open(parts_loc_path) as f:
        for line in f:
            img, part, x, y, vis = line.strip().split(" ")
            if vis == "1":
                img_parts.setdefault(img, {})[part] = (float(x), float(y))
    id_to_name, name_to_id = {}, {}
    with open(parts_name_path) as f:
        for line in f:
            pid, name = line.strip().split(" ", 1)
            id_to_name[pid] = name
            name_to_id[name] = pid
    merge_pairs = [(pid, name_to_id[name.replace("left", "right")])
                   for pid, name in id_to_name.items() if "left" in name]
    return path_to_id, img_parts, id_to_name, merge_pairs


def eval_prototypes_parts_csv(csvfile: str, parts_loc_path: str,
                              parts_name_path: str, imgs_id_path: str,
                              *, image_size: int = 224,
                              patchsize: int = 32) -> Dict[str, float]:
    """Purity evaluation of a patch CSV (ref util/eval_cub_csv.py:16-175).

    Patch boxes larger than ``patchsize`` are center-cropped before scoring
    (otherwise bigger patches inflate purity); boxes are mapped back to
    original image coordinates via each image's true size.
    """
    path_to_id, img_parts, id_to_name, merge_pairs = _load_part_annotations(
        parts_loc_path, parts_name_path, imgs_id_path)

    presences: Dict[str, Dict[str, List[int]]] = {}
    with open(csvfile, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        for proto, imgname, h0, h1, w0, w1 in reader:
            presences.setdefault(proto, {})
            with Image.open(imgname) as img:
                ow, oh = img.size
            imgname = imgname.replace("\\", "/")
            key = "/".join(imgname.split("/")[-2:])
            if "normal_" in key:
                key = key.split("normal_")[-1]
            img_id = path_to_id[key]
            h0, h1, w0, w1 = float(h0), float(h1), float(w0), float(w1)
            if h1 - h0 > patchsize:
                c = (h1 - h0) - patchsize
                h0, h1 = h0 + c // 2.0, h1 - c // 2.0
            if w1 - w0 > patchsize:
                c = (w1 - w0) - patchsize
                w0, w1 = w0 + c // 2.0, w1 - c // 2.0
            oh0, oh1 = (oh / image_size) * h0, (oh / image_size) * h1
            ow0, ow1 = (ow / image_size) * w0, (ow / image_size) * w1
            parts = img_parts.get(img_id, {})
            for part, (x, y) in parts.items():
                inside = int(oh0 <= y <= oh1 and ow0 <= x <= ow1)
                presences[proto].setdefault(part, []).append(inside)
            # merge left parts into right
            for left, right in merge_pairs:
                if left in parts:
                    if right in parts:
                        p0 = presences[proto][left][-1]
                        p1 = presences[proto][right][-1]
                        if p0 > p1:
                            presences[proto][right][-1] = p0
                        del presences[proto][left]
                    else:
                        presences[proto].setdefault(right, []).append(
                            presences[proto][left][-1])
                        del presences[proto][left]

    max_purity, most_often_purity = {}, {}
    part_related = 0
    for proto, parts in presences.items():
        best, best_sum = 0.0, -1
        often_part, often_sum, often_purity = None, -1, 0.0
        for part, vals in parts.items():
            purity = float(np.mean(vals))
            s = int(np.sum(vals))
            if purity > best or (purity == best and (purity == 0.0 or s > best_sum)):
                best, best_sum = purity, s
            if s > often_sum:
                often_part, often_sum, often_purity = part, s, purity
        max_purity[proto] = best
        most_often_purity[proto] = often_purity
        if best > 0.5:
            part_related += 1

    vals = list(max_purity.values())
    return {
        "mean_max_purity": float(np.mean(vals)) if vals else 0.0,
        "std_max_purity": float(np.std(vals)) if vals else 0.0,
        "mean_most_often_purity": float(np.mean(list(most_often_purity.values())))
        if most_often_purity else 0.0,
        "num_prototypes": len(presences),
        "num_part_related": part_related,
    }
