"""K1 (the fused prototype head) in the port: its plain version against the
JAX package's Pallas kernel (interpret mode) and its ``segment_softmax``,
the column plan the CUDA kernel runs on, and the wrapper's dispatch.  The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MULTI_NEWICK, budget, compiled_pair, flagship_roots

# one bf16 ulp for values in [0.5, 1): pf is rounded from f32 values that
# differ by the two products' summation order, so a value next to a rounding
# boundary may land one ulp apart
BF16_PF_ATOL = 2.0 ** -8


def _inputs(tree, B=2, H=5, W=5, D=32, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    f = r.standard_normal((B, H, W, D)).astype(np.float32)
    k = (scale * r.standard_normal((D, tree.num_protos_padded))).astype(np.float32)
    return f, k


def _port(f, k, tree, tau, dtype=torch.float32):
    from pipnet_tpu_torch.ops.fused_head import fused_head
    pf, pooled = fused_head(torch.from_numpy(f).to(dtype),
                            torch.from_numpy(k).to(dtype), tree, tau=tau)
    return pf.float().numpy(), pooled.numpy()


TREES = {
    "tiny": lambda newick: compiled_pair(newick, 10, 0),
    "multi_bucket": lambda newick: compiled_pair(MULTI_NEWICK, 2, 3),
}


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_f32_matches_jax_kernel_and_segment_softmax(tiny_newick, name, tau):
    from pipnet_tpu.ops import segment_softmax
    from pipnet_tpu.ops.pallas_head import fused_head_forward
    tj, tt = TREES[name](tiny_newick)
    f, k = _inputs(tt, seed=1)
    pf, pooled = _port(f, k, tt, tau)
    pf_k, pooled_k = fused_head_forward(jnp.asarray(f), jnp.asarray(k), tj,
                                        tau=tau, interpret=True)
    np.testing.assert_allclose(pf, np.asarray(pf_k), atol=2e-6, rtol=0)
    np.testing.assert_allclose(pooled, np.asarray(pooled_k), atol=2e-6, rtol=0)
    pf_s = np.asarray(segment_softmax(jnp.asarray(f) @ jnp.asarray(k), tj, tau=tau))
    np.testing.assert_allclose(pf, pf_s, atol=2e-6, rtol=0)
    # padded slots and the padded tail are exactly zero
    assert (pf[..., ~tt.proto_valid] == 0).all()
    assert (pooled[:, ~tt.proto_valid] == 0).all()


@pytest.mark.parametrize("name", sorted(TREES))
def test_bf16_matches_jax_kernel(tiny_newick, name):
    """bf16 inputs, f32 accumulation in both: pf within one bf16 ulp,
    pooled (f32, taken before the cast) to f32 summation-order noise."""
    from pipnet_tpu.ops.pallas_head import fused_head_forward
    tj, tt = TREES[name](tiny_newick)
    f, k = _inputs(tt, seed=2)
    pf, pooled = _port(f, k, tt, 1.0, torch.bfloat16)
    pf_k, pooled_k = fused_head_forward(jnp.asarray(f, jnp.bfloat16),
                                        jnp.asarray(k, jnp.bfloat16), tj,
                                        interpret=True)
    np.testing.assert_allclose(pf, np.asarray(pf_k, np.float32),
                               atol=BF16_PF_ATOL, rtol=0)
    np.testing.assert_allclose(pooled, np.asarray(pooled_k), atol=1e-5, rtol=0)


def test_node_far_below_another_keeps_its_softmax(tiny_newick):
    """One node's logits ~100 below another's in the same tile: the Pallas
    kernel's tile-row-max shift underflows that node to zeros; the port
    shifts by the per-node max, as JAX ``segment_softmax`` defines it."""
    from pipnet_tpu.ops import segment_softmax
    tj, tt = compiled_pair(tiny_newick, 10, 0)
    r = np.random.default_rng(3)
    f = np.concatenate([np.ones((2, 4, 4, 1), np.float32),
                        r.standard_normal((2, 4, 4, 7)).astype(np.float32)], -1)
    k = r.standard_normal((8, tt.num_protos_padded)).astype(np.float32)
    k[0] = np.where(tt.proto_node % 2 == 0, 50.0, -50.0)
    pf, pooled = _port(f, k, tt, 1.0)
    want = np.asarray(segment_softmax(jnp.asarray(f) @ jnp.asarray(k), tj))
    np.testing.assert_allclose(pf, want, atol=2e-6, rtol=0)
    for ni in range(tt.num_nodes):
        np.testing.assert_allclose(pf[..., tt.node_proto_slice(ni)].sum(-1), 1.0,
                                   atol=1e-5)


def test_cpu_wrapper_runs_plain_version(tiny_newick):
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    _, tt = compiled_pair(tiny_newick, 10, 0)
    f, k = _inputs(tt, seed=4)
    before = fused_head.launches
    got = fused_head(torch.from_numpy(f), torch.from_numpy(k), tt, tau=0.5)
    want = fused_head_reference(torch.from_numpy(f), torch.from_numpy(k), tt, tau=0.5)
    assert fused_head.launches == before == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32


def _check_groups(tree, groups, tile_cols, max_nodes=None, align=1):
    covered = np.zeros(tree.num_protos_padded, int)
    for start, ncols, width in groups:
        assert 0 < ncols <= tile_cols
        # a bf16 tile starts on an aligned column before the group
        assert width == 0 or start % align + ncols <= tile_cols
        covered[start:start + ncols] += 1
        if width == 0:                      # padded tail: no real node
            assert (tree.proto_node[start:start + ncols] == -1).all()
        else:                               # whole nodes of one bucket
            assert ncols % width == 0
            assert max_nodes is None or ncols // width <= max_nodes
            assert (tree.node_proto_width[tree.proto_node[start:start + ncols]
                                          [tree.proto_valid[start:start + ncols]]]
                    == width).all()
            assert tree.proto_node[start] != tree.proto_node[start - 1] or start == 0
    assert (covered == 1).all()


# each kernel's column plan: the f32 SIMT tile (K1, K2), and the bf16
# tile of K1 and K2 (one group of 128 columns, on 8-column boundaries, at
# most 16 nodes), with a wider tile for contrast
PLANS = {"simt": (128, None, 1), "bf16": (128, 16, 8), "wide": (240, 16, 8)}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_column_groups_multi_bucket(plan):
    from pipnet_tpu_torch.ops.fused_head import column_groups
    _, tt = compiled_pair(MULTI_NEWICK, 2, 3)
    groups = column_groups(tt, *PLANS[plan])
    _check_groups(tt, groups, *PLANS[plan])
    # one group per bucket (each bucket's nodes fit every tile), then the
    # padded tail
    assert [int(w) for w in groups[:-1, 2]] == [b.width for b in tt.buckets]
    assert groups[-1, 2] == 0


@pytest.mark.parametrize("plan,count,full,last", [
    # 189 nodes of width 20: 31 groups of 6 and one of 3, then the 60-column tail
    ("simt", 33, 120, (3720, 60, 20)),
    ("bf16", 33, 120, (3720, 60, 20)),
    # 15 groups of 12 nodes and one of 9 (a group narrower than the tile)
    ("wide", 17, 240, (3600, 180, 20)),
])
def test_column_groups_flagship(plan, count, full, last):
    from pipnet_tpu_torch.ops.fused_head import column_groups
    from pipnet_tpu_torch.tree import compile_tree
    _, rt, classes = flagship_roots()
    tt = compile_tree(budget(rt, 10), class_names=classes, protopool=False)
    groups = column_groups(tt, *PLANS[plan])
    _check_groups(tt, groups, *PLANS[plan])
    assert len(groups) == count and (groups[:count - 2, 1] == full).all()
    assert tuple(groups[count - 2]) == last and tuple(groups[count - 1]) == (3780, 60, 0)


def test_column_groups_cap_nodes_per_group():
    """Narrow nodes fill a bf16 tile only up to the kernels' 16-node tables:
    the flagship tree at one prototype per child has buckets of many narrow
    nodes."""
    from pipnet_tpu_torch.ops.fused_head import column_groups
    from pipnet_tpu_torch.tree import compile_tree
    _, rt, classes = flagship_roots()
    tt = compile_tree(budget(rt, 1), class_names=classes, protopool=False)
    assert max(b.num_nodes for b in tt.buckets) > 16 and min(b.width for b in tt.buckets) * 16 < 240
    groups = column_groups(tt, 240, 16, 8)
    _check_groups(tt, groups, 240, 16, 8)
    assert max(n // w for _, n, w in groups if w) == 16
    assert len(column_groups(tt, 240, None, 8)) < len(groups)


def test_kernel_groups_pick_each_kernels_plan(tiny_newick):
    """K1 and K2 launch each dtype's own plan (``head_plan``), one table of
    whole-node groups on a tree without a wide node."""
    from pipnet_tpu_torch.ops.fused_head import column_groups, head_plan
    _, tt = compiled_pair(tiny_newick, 10, 0)
    cpu = torch.device("cpu")
    for dtype, want in ((torch.float32, column_groups(tt, 128)),
                        (torch.bfloat16, column_groups(tt, 128, 16, 8))):
        got, wide = head_plan(tt, dtype, cpu)
        assert wide is None
        assert got.dtype == torch.int32 and np.array_equal(got[:, :3].numpy(), want)


# K1b's own plan (``backward_plan``) at the flagship train step's 26x26
# patches, at a 56x56 map (narrower groups: the slice takes more rows), and
# on small trees with several bucket widths
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,hw", [("flagship", 676), ("flagship", 3136),
                                          ("multi_bucket", 99), ("tiny", 169)])
def test_backward_plan_covers_every_column_once_in_whole_nodes(tiny_newick, dtype, tree_name,
                                                               hw):
    """Every column in exactly one group, every group whole nodes of one
    bucket (or the padded tail), each node group inside the kernel's window
    of ``sv`` 16-byte vectors (at most a warp's 32) seen from the boundary
    below its start; the slice leaves room for two blocks an SM unless the
    widest node needs more."""
    from pipnet_tpu_torch.ops.fused_head import (BACKWARD_MAX_VECTORS, BACKWARD_SLICE_BYTES,
                                                 backward_plan)
    from pipnet_tpu_torch.tree import compile_tree
    if tree_name == "flagship":
        _, rt, classes = flagship_roots()
        tt = compile_tree(budget(rt, 10), class_names=classes, protopool=False)
    else:
        _, tt = (compiled_pair(MULTI_NEWICK, 2, 3) if tree_name == "multi_bucket"
                 else compiled_pair(tiny_newick, 10, 0))
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    vec = 16 // es
    sv, groups, wide = backward_plan(tt, dt, hw, torch.device("cpu"))
    g = groups[:, :3].numpy()
    assert wide is None
    assert groups.dtype == torch.int32 and 1 <= sv <= BACKWARD_MAX_VECTORS
    _check_groups(tt, g, int(g[:, 1].max()), None, vec)
    nodes = g[g[:, 2] > 0]
    assert (nodes[:, 0] % vec + nodes[:, 1] <= sv * vec).all()
    widest = max(b.width for b in tt.buckets)
    assert hw * sv * 16 <= BACKWARD_SLICE_BYTES or sv * vec < widest + 2 * vec - 1


@pytest.mark.parametrize("dtype,sv,full", [("bfloat16", 10, 80), ("float32", 10, 40)])
def test_backward_plan_flagship_groups_end_on_sectors(dtype, sv, full):
    """At the flagship train step's shape, K1b's groups are runs of nodes
    whose dz bytes start and end on 32-byte sectors (4 nodes of 20 bf16
    columns, 2 in f32), so no sector is written by two blocks; only the
    bucket's last node and the padded tail break the run."""
    from pipnet_tpu_torch.ops.fused_head import backward_plan
    from pipnet_tpu_torch.tree import compile_tree
    _, rt, classes = flagship_roots()
    tt = compile_tree(budget(rt, 10), class_names=classes, protopool=False)
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    got_sv, groups, wide = backward_plan(tt, dt, 676, torch.device("cpu"))
    g = groups[:, :3].numpy()
    assert wide is None
    assert got_sv == sv
    runs = g[(g[:, 1] == full) & (g[:, 2] == 20)]
    assert len(runs) == 189 // (full // 20)           # all nodes but the odd last one
    assert ((runs[:, 0] * es) % 32 == 0).all() and (((runs[:, 0] + runs[:, 1]) * es) % 32 == 0).all()
    assert g[-1, 2] == 0
