"""Synthetic dataset fixture: a tiny on-disk ImageFolder + matching Newick
phylogeny, so tests and smoke runs need no cluster data paths
(the reference hard-codes cluster filesystems in util/data.py:126-425).

The fixture is HIERARCHICAL: the phylogeny is generated first, every
internal node is assigned a distinct visual marker (golden-ratio hue +
shape family + orientation), and each image is stamped with one marker per
ancestor of its class.  This matches the data assumption HComP-Net's
losses encode — tanh_desc demands, for every child of every node, a
prototype that activates on EVERY leaf descendant (pipnet/train.py:
1089-1134), and minimize_contrasting_set demands it NOT activate on
non-descendants (1017-1060).  Real phylogenetic datasets satisfy this
through inherited morphology; a fixture with only per-class cues and a
random tree cannot (measured: a 190-class run from random init holds
tanh_desc pinned at its saturation value from the first full-loss epoch —
most (child, leaf) terms are unsatisfiable — and ~5 epochs of the
resulting prototype-death cascade collapse the run regardless of every
optimizer guard; runs/full_phase_190_*collapse forensics).  With
node-aligned markers every descendant-product term has an actual visual
trait to bind to."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

# Bump when the generator's output changes: the on-disk fixture cache
# (datasets.resolve_dataset) is keyed by this, so stale images from an
# older generator are never silently reused.
FIXTURE_VERSION = 2


def synthetic_class_names(num_classes: int) -> List[str]:
    return [f"syn_{i + 1:03d}_Species_{chr(65 + i % 26)}{i}" for i in range(num_classes)]


def _merge_topology(class_names: List[str], rng: np.random.Generator
                    ) -> Tuple[str, Dict[int, List[int]]]:
    """Random binary merge tree over the classes.

    Returns (newick, ancestors) where ancestors[ci] lists the internal-node
    ids on the root->leaf path of class ci (ids in merge order, 0-based).
    """
    items: List[Tuple[str, List[int]]] = [
        (f"{n}:{rng.uniform(0.5, 2.0):.3f}", [ci])
        for ci, n in enumerate(class_names)]
    order = rng.permutation(len(items))
    items = [items[i] for i in order]
    ancestors: Dict[int, List[int]] = {ci: [] for ci in range(len(class_names))}
    nid = 0
    while len(items) > 1:
        a = items.pop(int(rng.integers(len(items))))
        b = items.pop(int(rng.integers(len(items))))
        for ci in a[1] + b[1]:
            ancestors[ci].append(nid)
        items.append((f"({a[0]},{b[0]}):{rng.uniform(0.5, 2.0):.3f}",
                      a[1] + b[1]))
        nid += 1
    return items[0][0].rsplit(":", 1)[0] + ";", ancestors


def make_synthetic_newick(class_names: List[str], rng: np.random.Generator) -> str:
    """Random binary phylogeny over the class names with random branch lengths."""
    return _merge_topology(class_names, rng)[0]


def _marker_cues(k: int) -> Tuple[np.ndarray, float, int]:
    """Deterministic visual identity for marker id ``k``: golden-ratio HSV
    color (well-separated across hundreds of ids), orientation, shape family.
    """
    import colorsys
    hue = (k * 0.61803398875) % 1.0
    sat = 0.6 + 0.35 * ((k // 2) % 2)
    val = 0.65 + 0.3 * ((k // 4) % 2)
    color = np.array(colorsys.hsv_to_rgb(hue, sat, val)) * 255.0
    angle = np.deg2rad((k * 49.3) % 180.0)
    shape = k % 5
    return color, angle, shape


def _stamp_marker(img: np.ndarray, xx: np.ndarray, yy: np.ndarray,
                  cx: float, cy: float, rad: float, k: int,
                  r: np.random.Generator) -> None:
    """Draw marker ``k`` centered at (cx, cy) with radius ``rad`` in place."""
    color, angle, shape = _marker_cues(k)
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    u = (xx - cx) * np.cos(angle) + (yy - cy) * np.sin(angle)
    v = -(xx - cx) * np.sin(angle) + (yy - cy) * np.cos(angle)
    if shape == 0:                                   # disc
        blob = d2 < rad ** 2
    elif shape == 1:                                 # ring
        blob = (d2 < rad ** 2) & (d2 > (0.5 * rad) ** 2)
    elif shape == 2:                                 # oriented bar
        blob = (np.abs(u) < rad) & (np.abs(v) < 0.38 * rad)
    elif shape == 3:                                 # cross
        blob = ((np.abs(u) < rad) & (np.abs(v) < 0.3 * rad)) | (
            (np.abs(v) < rad) & (np.abs(u) < 0.3 * rad))
    else:                                            # square (axis-aligned)
        blob = (np.abs(xx - cx) < 0.8 * rad) & (np.abs(yy - cy) < 0.8 * rad)
    img[blob] = np.clip(color + r.integers(-18, 18, 3), 0, 255)


def generate_synthetic_dataset(root: str, *, num_classes: int = 8,
                               images_per_class: int = 6, image_size: int = 128,
                               seed: int = 0) -> Tuple[str, str, str]:
    """Create train/ and test/ ImageFolders plus a MATCHING phylogeny .phy.

    Every image of class ci carries: a faint class-colored oriented-stripe
    field (leaf-level cue, survives resize/augment), one marker per
    INTERNAL-NODE ancestor of ci in the generated phylogeny (the
    hierarchically-shared traits the per-node prototypes exist to find),
    and one leaf marker unique to ci.  Markers are placed on a shuffled
    grid over the central region so random-resized-crop keeps them, and
    are sized to span roughly one 32px prototype patch after the 224px
    resize.  Returns (train_dir, test_dir, phylo_path).
    """
    rng = np.random.default_rng(seed)
    names = synthetic_class_names(num_classes)
    newick, ancestors = _merge_topology(names, rng)
    num_internal = num_classes - 1
    max_markers = max(len(a) for a in ancestors.values()) + 1  # + leaf marker
    # grid sized to fit the deepest leaf's marker set, over central ~88%
    gcells = 1
    while gcells * gcells < max_markers:
        gcells += 1
    gcells = max(gcells, 4)
    lo, hi = 0.06 * image_size, 0.94 * image_size
    cell = (hi - lo) / gcells
    rad = 0.42 * cell

    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    yy, xx = np.mgrid[:image_size, :image_size].astype(np.float64)
    for ci, name in enumerate(names):
        # leaf-level cue: class-colored stripes (golden-ratio hue offset by
        # 0.31 so leaf stripe hues do not track marker hues)
        scolor, sangle, _ = _marker_cues(num_internal + num_classes + ci)
        sfreq = 2.0 + (ci % 5)
        marker_ids = ancestors[ci] + [num_internal + ci]
        for split, n_imgs, off in ((train_dir, images_per_class, 0),
                                   (test_dir, max(2, images_per_class // 3), 1000)):
            cdir = os.path.join(split, name)
            os.makedirs(cdir, exist_ok=True)
            for ii in range(n_imgs):
                r = np.random.default_rng((seed, ci, ii + off))
                img = r.integers(0, 60, (image_size, image_size, 3)).astype(np.float64)
                proj = (xx * np.cos(sangle) + yy * np.sin(sangle)) / image_size
                phase = r.uniform(0, 2 * np.pi)
                stripe = np.sin(2 * np.pi * sfreq * proj + phase) > 0.3
                img[stripe] = np.clip(img[stripe] + scolor * 0.35, 0, 255)
                # one marker per ancestor node + the leaf marker, each in its
                # own random grid cell (no overlap, never near the border)
                cells = r.permutation(gcells * gcells)[:len(marker_ids)]
                for k, cidx in zip(marker_ids, cells):
                    gx, gy = cidx % gcells, cidx // gcells
                    cx = lo + (gx + 0.5) * cell + r.uniform(-0.08, 0.08) * cell
                    cy = lo + (gy + 0.5) * cell + r.uniform(-0.08, 0.08) * cell
                    _stamp_marker(img, xx, yy, cx, cy, rad, k, r)
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(cdir, f"img_{ii:03d}.png"))
    phylo_path = os.path.join(root, "phylogeny.phy")
    with open(phylo_path, "w") as f:
        f.write(newick)
    return train_dir, test_dir, phylo_path
