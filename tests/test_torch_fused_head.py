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


def _check_groups(tree, groups):
    from pipnet_tpu_torch.ops.fused_head import TILE_COLS
    covered = np.zeros(tree.num_protos_padded, int)
    for start, ncols, width in groups:
        assert 0 < ncols <= TILE_COLS
        covered[start:start + ncols] += 1
        if width == 0:                      # padded tail: no real node
            assert (tree.proto_node[start:start + ncols] == -1).all()
        else:                               # whole nodes of one bucket
            assert ncols % width == 0
            assert (tree.node_proto_width[tree.proto_node[start:start + ncols]
                                          [tree.proto_valid[start:start + ncols]]]
                    == width).all()
            assert tree.proto_node[start] != tree.proto_node[start - 1] or start == 0
    assert (covered == 1).all()


def test_column_groups_multi_bucket():
    from pipnet_tpu_torch.ops.fused_head import column_groups
    _, tt = compiled_pair(MULTI_NEWICK, 2, 3)
    groups = column_groups(tt)
    _check_groups(tt, groups)
    assert len({int(w) for w in groups[:, 2] if w}) == len(tt.buckets)
    assert groups[-1, 2] == 0          # the padded tail is its own group


def test_column_groups_flagship():
    from pipnet_tpu_torch.ops.fused_head import column_groups
    from pipnet_tpu_torch.tree import compile_tree
    _, rt, classes = flagship_roots()
    tt = compile_tree(budget(rt, 10), class_names=classes, protopool=False)
    groups = column_groups(tt)
    _check_groups(tt, groups)
    # 189 nodes of width 20 in groups of 6, then the 60-column tail
    assert len(groups) == 33 and (groups[:31, 1] == 120).all()
    assert tuple(groups[31]) == (3720, 60, 20) and tuple(groups[32]) == (3780, 60, 0)


def test_column_groups_reject_nodes_wider_than_a_tile(tiny_newick):
    from pipnet_tpu_torch.ops.fused_head import column_groups
    _, tt = compiled_pair(tiny_newick, 70, 0)
    with pytest.raises(ValueError, match="exceeds"):
        column_groups(tt)
