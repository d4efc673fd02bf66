"""K1's f32 kernel (``csrc/fused_head.cu::fused_head_f32``) launches one
block per (column group, row tile of ``F32_ROW_TILE`` of the B * H * W patch
rows) on the f32 column plan (``head_plan``), over every bucket of the tree: the
whole-node groups in one launch, the parts of nodes wider than its
128-column tile in two (row statistics, then the normalising pass).  On the
CPU: that grid writes every pf value exactly once, each image's pooled value
of a column is met from the row tiles that hold its rows, each group fits the
tile from its 16-byte aligned start, and the parts of a wide node are its
consecutive columns.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from torch_port_util import (MIXED_NEWICK, MULTI_NEWICK, budget, flagship_roots, flat_tree_port,
                             port_tree)


def _tree(name):
    from pipnet_tpu_torch.tree import compile_tree
    if name == "flagship":
        _, root, classes = flagship_roots()
        return compile_tree(budget(root, 10), class_names=classes, protopool=False)
    if name.startswith("flat"):
        return flat_tree_port(200, int(name[4:]))
    return port_tree(*{"mixed": (MIXED_NEWICK,), "multi_bucket": (MULTI_NEWICK, 2, 3)}[name])


def _blocks(plan, rows):
    """(first column, columns, first row, rows) of each block (g, rt) of one
    launch over ``plan`` and ``rows`` patch rows: group g, row tile rt."""
    from pipnet_tpu_torch.ops.fused_head import F32_ROW_TILE
    row_tiles = -(-rows // F32_ROW_TILE)
    for c0, ncols in plan[:, :2].tolist():
        for rt in range(row_tiles):
            r0 = rt * F32_ROW_TILE
            yield c0, ncols, r0, min(F32_ROW_TILE, rows - r0)


# the flagship tree at its 26x26 patches (serving and a training view's
# batch), ResNet-50's 28x28 and ViT-S's 16x16; flat PIP-Net's node of 768 and
# nodes of 300 and 2000; a narrow bucket beside a node of 300 starting at
# column 60; several bucket widths with a padded tail; 99 rows an image (a
# row tile holding two or three images), one image
GRID_CASES = [("flagship", 8, 676), ("flagship", 16, 676), ("flagship", 8, 784),
              ("flagship", 8, 256), ("flagship", 3, 99), ("flagship", 1, 99),
              ("flat768", 8, 676), ("flat300", 3, 99), ("flat2000", 3, 99), ("mixed", 3, 99),
              ("multi_bucket", 3, 99)]


@pytest.mark.parametrize("tree_name,B,hw", GRID_CASES)
def test_f32_grid_writes_every_pf_value_once(tree_name, B, hw):
    """The launches that write pf (WHOLE over the whole-node groups, FINAL
    over the parts) cover every (patch row, column) of the B images exactly
    once, the padded tail included; every row tile holds a row; every group
    fits the 128-column tile from c0 & ~3, where its 16-byte loads start;
    each image's pooled value of a column is the atomicMax of the maxima of
    one group's row tiles over that image's rows (the kernel's runs of a
    tile's rows by image), which together hold every row of the image."""
    from pipnet_tpu_torch.ops.fused_head import (F32_ROW_TILE, SIMT_ALIGN_COLS,
                                                 SIMT_TILE_COLS, head_plan)
    tree = _tree(tree_name)
    P = tree.num_protos_padded
    whole, wide = head_plan(tree, torch.float32, torch.device("cpu"))
    plans = [p.numpy() for p in (whole, wide) if p is not None]
    count = np.zeros((B * hw, P), np.int8)
    pooled_rows = np.zeros((B, P), np.int32)
    for plan in plans:
        c0, ncols = plan[:, 0], plan[:, 1]
        assert (c0 % SIMT_ALIGN_COLS + ncols <= SIMT_TILE_COLS).all()
        assert (ncols > 0).all() and P % SIMT_ALIGN_COLS == 0
        for c, n, r0, rows in _blocks(plan, B * hw):
            assert 0 < rows <= F32_ROW_TILE
            count[r0:r0 + rows, c:c + n] += 1
            r = 0
            while r < rows:               # the kernel's runs of rows by image
                img = (r0 + r) // hw
                end = min(rows, (img + 1) * hw - r0)
                pooled_rows[img, c:c + n] += end - r
                r = end
    assert (count == 1).all()
    assert (pooled_rows == hw).all()


WIDE_TREES = ["flat768", "flat300", "flat2000", "mixed"]


@pytest.mark.parametrize("tree_name", WIDE_TREES)
def test_f32_wide_node_parts_are_its_consecutive_columns(tree_name):
    """On a tree with a node wider than the tile, the parts launch (STATS
    writes each part's row statistics and z, FINAL the node's softmax) holds
    each wide node as consecutive parts from its first column, numbered 0..
    parts - 1, each within the tile from its aligned start, their columns
    adding up to the node's width; a call launches K1 twice more than a
    tree of whole nodes."""
    from pipnet_tpu_torch.ops.fused_head import (SIMT_ALIGN_COLS, SIMT_TILE_COLS, head_plan,
                                                 plan_launches)
    tree = _tree(tree_name)
    whole, wide = head_plan(tree, torch.float32, torch.device("cpu"))
    assert wide is not None
    parts = wide.numpy()
    nodes = parts[parts[:, 2] > 0]
    wide_buckets = [b for b in tree.buckets if b.width > SIMT_TILE_COLS - (SIMT_ALIGN_COLS - 1)]
    assert sum(b.num_nodes for b in wide_buckets) == int((nodes[:, 4] == 0).sum())
    i = 0
    while i < len(nodes):
        c0, _, width, off, part, n = nodes[i].tolist()
        assert off == 0 and part == 0 and n > 1
        run = nodes[i:i + n]
        assert (run[:, 4] == np.arange(n)).all() and (run[:, 5] == n).all()
        assert (run[:, 2] == width).all() and run[:, 1].sum() == width
        assert (run[:, 0] == c0 + np.concatenate([[0], np.cumsum(run[:-1, 1])])).all()
        assert (run[:, 3] == run[:, 0] - c0).all()
        assert (run[:, 0] % SIMT_ALIGN_COLS + run[:, 1] <= SIMT_TILE_COLS).all()
        i += n
    assert plan_launches(whole, wide, 2) == (whole is not None) + 2
