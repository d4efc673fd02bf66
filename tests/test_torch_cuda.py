"""Tests of the port that need a CUDA card: the hand-written kernels (K1,
its adjoint K1b, the no-pf head K2, the depthwise conv K3, the fused block
K4) against their plain versions on the card, the wrappers' launch counts
and input checks, and a small model on the card against the same model on
the CPU.

They skip without a card.  The card's host has no JAX, so this file imports
none and uses no fixture of ``conftest.py``; run it there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_util import (MIXED_NEWICK, MULTI_NEWICK, budget, compiled_pair, flagship_roots,
                             flat_tree_port, port_tree)

TINY = ("((((cub_001_A:1,cub_002_B:1):1,cub_003_C:2):2,((cub_004_D:1.5,"
        "cub_005_E:1.5):1,cub_006_F:2.5):1.5):1,(cub_007_G:2,cub_008_H:2):3);")


def assert_pf_close(pf, pf_r, dtype):
    """pf against its plain version: f32 within 1e-5; bf16 within one bf16
    ulp of each plain value (2^-7 of it: an ulp is 2^-8 to 2^-7 of a
    value), beyond a floor at f32's least normal (exponentials of slots at
    the clip, flushed to zero)."""
    if dtype == "float32":
        torch.testing.assert_close(pf.float(), pf_r.float(), atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(pf.float(), pf_r.float(), atol=2.0 ** -126, rtol=2.0 ** -7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _tree(name):
    if name == "flagship":
        from pipnet_tpu_torch.tree import compile_tree
        _, root, classes = flagship_roots()
        return compile_tree(budget(root, 10), class_names=classes, protopool=False)
    if name.startswith("flat"):
        return flat_tree_port(200, int(name[4:]))
    newick, per = {"multi_bucket": (MULTI_NEWICK, (2, 3)), "tiny": (TINY, (10, 0)),
                   "mixed": (MIXED_NEWICK, (10, 0))}[name]
    return port_tree(newick, *per)


# (tree, shape (B, H, W, D), tau): several bucket widths (6, 9, 15, 30: none
# divides the bf16 kernels' 128-column tile, every group narrower than its
# tile, groups starting off an 8-column boundary, a padded tail) with D not
# a multiple of the 64-deep stage and 99 rows, not a multiple of the 128-row
# tile; the flagship tree at the training slice's per-image shape (its last
# group of 60 columns is narrower than the tile); one image pair; tau 0.5
KERNEL_CASES = [("multi_bucket", (4, 9, 11, 72), 0.5), ("tiny", (2, 13, 13, 64), 1.0),
                ("flagship", (4, 26, 26, 768), 1.0), ("multi_bucket", (2, 9, 11, 72), 0.5),
                ("flagship", (2, 26, 26, 768), 0.5)]
# nodes wider than every kernel's column tile, cut into parts: flat PIP-Net
# (one node of 768 prototypes, at the flat model's per-image shape), a
# node of 300 (its last part ends inside a 16-byte vector; a padded tail
# follows), of 130 (a last part of 2 columns, held by one lane of a quad)
# and of 2000 (16 parts in bf16, 25 and 50 in K1b), and a tree mixing a
# narrow bucket with a node of 300 starting at column 60 (its first bf16
# part sits 4 columns into its TMA tile)
WIDE_CASES = [("flat768", (2, 26, 26, 768), 1.0), ("flat300", (4, 9, 11, 72), 0.5),
              ("flat130", (2, 9, 11, 72), 1.0), ("flat2000", (2, 9, 11, 72), 1.0),
              ("mixed", (4, 9, 11, 72), 0.5)]


def _inputs(tree, B, H, W, D, seed, dtype, scale=0.3):
    r = np.random.default_rng(seed)
    f = torch.from_numpy(r.standard_normal((B, H, W, D)).astype(np.float32))
    k = torch.from_numpy((scale * r.standard_normal((D, tree.num_protos_padded)))
                         .astype(np.float32))
    return f.to("cuda", dtype), k.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,shape,tau", [
    ("multi_bucket", (3, 9, 11, 72), 0.5),     # D not a multiple of the depth tile
    ("tiny", (2, 13, 13, 64), 1.0),            # rows not a multiple of the row tile
    ("multi_bucket", (1, 9, 11, 72), 0.5),     # one image
    ("flagship", (1, 26, 26, 768), 0.5),       # a group narrower than the bf16 tile
] + WIDE_CASES)
def test_fused_head_kernel_matches_plain(card, dtype, tree_name, shape, tau):
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    tree = _tree(tree_name)
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, *shape, seed=5, dtype=dt)
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree, tau=tau)
        torch.cuda.synchronize()
        pf_r, pooled_r = fused_head_reference(f, k, tree, tau=tau)
    assert pf.dtype == dt and pooled.dtype == torch.float32
    assert_pf_close(pf, pf_r, dtype)
    torch.testing.assert_close(pooled, pooled_r, atol=1e-5, rtol=0)
    invalid = torch.from_numpy(~tree.proto_valid).cuda()
    assert (pf[..., invalid] == 0).all() and (pooled[:, invalid] == 0).all()


@pytest.mark.cuda
def test_fused_head_counts_launches_and_checks_inputs(card):
    from pipnet_tpu_torch.ops.fused_head import fused_head
    _, tree = compiled_pair(MULTI_NEWICK, 2, 3)
    f, k = _inputs(tree, 2, 4, 4, 32, seed=6, dtype=torch.float32)
    before = fused_head.launches
    with torch.inference_mode():
        fused_head(f, k, tree)
        fused_head(f, k, tree)
    assert fused_head.launches == before + 2
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_head(f, k.bfloat16(), tree)
        with pytest.raises(TypeError):
            fused_head(f.half(), k.half(), tree)
        with pytest.raises(ValueError):
            fused_head(f.transpose(1, 2), k, tree)          # not contiguous
        with pytest.raises(ValueError):
            fused_head(f, k[:, :-1].contiguous(), tree)     # wrong P
        # the bf16 kernel reads by TMA: D a multiple of 8, 16-byte aligned rows
        with pytest.raises(ValueError):
            fused_head(torch.zeros(2, 4, 4, 36, dtype=torch.bfloat16, device="cuda"),
                       torch.zeros(36, k.shape[1], dtype=torch.bfloat16, device="cuda"), tree)
        shifted = torch.zeros(f.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:]
        with pytest.raises(ValueError):
            fused_head(shifted.view(f.shape), k.bfloat16(), tree)
    assert fused_head.launches == before + 2


# K1b's own edges besides: one image (a single group row of blocks), and a
# map of 80x80 patches whose pf slice does not fit a block's shared memory
# (pf is read from device memory in both passes)
BACKWARD_CASES = KERNEL_CASES + WIDE_CASES + [("multi_bucket", (1, 9, 11, 72), 0.5),
                                 ("flagship", (1, 26, 26, 768), 1.0),
                                 ("flagship", (1, 80, 80, 64), 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,shape,tau", BACKWARD_CASES)
def test_head_backward_kernel_matches_plain(card, dtype, tree_name, shape, tau):
    """K1b against its plain version on the same pf and cotangents, with and
    without g_pf: f32 to summation-order noise; bf16 dz within one bf16 ulp
    (2^-7 relative) of the plain value rounded from f32."""
    from pipnet_tpu_torch.ops.fused_head import (fused_head_reference, head_backward,
                                                 head_backward_reference)
    tree = _tree(tree_name)
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, *shape, seed=7, dtype=dt)
    pf, _ = fused_head_reference(f, k, tree, tau=tau)
    r = np.random.default_rng(8)
    g_pf = torch.from_numpy(r.standard_normal(pf.shape).astype(np.float32)).to("cuda", dt)
    g_pooled = torch.from_numpy(r.standard_normal((pf.shape[0], pf.shape[-1]))
                                .astype(np.float32)).cuda()
    for g in (g_pf, None):
        dz = head_backward(pf, g, g_pooled, tree, tau=tau)
        torch.cuda.synchronize()
        ref = head_backward_reference(pf, g, g_pooled, tree, tau=tau)
        assert dz.dtype == dt and dz.shape == pf.shape
        d, w = dz.float(), ref.float()
        bar = (1e-5 if dtype == "float32" else 2.0 ** -7) * w.abs() + 1e-6 * w.abs().max()
        assert ((d - w).abs() <= bar).all(), (d - w).abs().max()
        assert (dz[..., torch.from_numpy(~tree.proto_valid).cuda()] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name", ["flagship", "multi_bucket"])
def test_head_backward_splits_exact_ties_at_the_max(card, dtype, tree_name):
    """Rows copied onto others tie exactly at many columns' max, and a
    constant column ties on every row: each tied row gets an even share of
    the pooled cotangent, as in the plain version, with and without g_pf."""
    from pipnet_tpu_torch.ops.fused_head import (fused_head_reference, head_backward,
                                                 head_backward_reference)
    tree = _tree(tree_name)
    dt = getattr(torch, dtype)
    shape = (2, 9, 11, 72) if tree_name == "multi_bucket" else (2, 26, 26, 768)
    f, k = _inputs(tree, *shape, seed=11, dtype=dt)
    pf, _ = fused_head_reference(f, k, tree)
    pf = pf.reshape(shape[0], -1, pf.shape[-1])
    pf[:, 5] = pf[:, 3]
    pf[:, 7] = pf[:, 3]
    col = int(np.flatnonzero(tree.proto_valid)[0])
    pf[:, :, col] = pf[:, 0, col].unsqueeze(1)
    pf = pf.reshape(shape[0], shape[1], shape[2], -1).contiguous()
    r = np.random.default_rng(12)
    g_pooled = torch.from_numpy(r.standard_normal((shape[0], pf.shape[-1])).astype(np.float32)).cuda()
    g_pf = torch.from_numpy(r.standard_normal(pf.shape).astype(np.float32)).to("cuda", dt)
    for g in (None, g_pf):
        dz = head_backward(pf, g, g_pooled, tree)
        torch.cuda.synchronize()
        ref = head_backward_reference(pf, g, g_pooled, tree)
        d, w = dz.float(), ref.float()
        bar = (1e-5 if dtype == "float32" else 2.0 ** -7) * w.abs() + 1e-6 * w.abs().max()
        assert ((d - w).abs() <= bar).all(), (d - w).abs().max()


@pytest.mark.cuda
def test_head_backward_splits_ties(card):
    """Two equal spatial maxima share the pooled cotangent evenly."""
    from pipnet_tpu_torch.ops.fused_head import head_backward, head_backward_reference
    tree = _tree("tiny")
    pf = torch.full((1, 2, 2, tree.num_protos_padded), 0.25, device="cuda")
    pf[..., ~torch.from_numpy(tree.proto_valid).cuda()] = 0.0
    pf[0, 1, 1] *= 0.5                      # three rows tie at the max 0.25
    g_pooled = torch.ones(1, tree.num_protos_padded, device="cuda")
    dz = head_backward(pf, None, g_pooled, tree)
    torch.testing.assert_close(dz, head_backward_reference(pf, None, g_pooled, tree),
                               atol=1e-7, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,shape,tau", KERNEL_CASES + WIDE_CASES)
def test_fused_head_nopf_kernel_matches_plain(card, dtype, tree_name, shape, tau):
    """K2 against its plain version: pooled and logsum are f32 in both and
    the products sum exact bf16 products in f32, so both dtypes agree to
    summation-order noise."""
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    tree = _tree(tree_name)
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, *shape, seed=9, dtype=dt)
    with torch.inference_mode():
        pooled, logsum = fused_head_nopf(f, k, tree, tau=tau, eps=1e-12)
        torch.cuda.synchronize()
        pooled_r, logsum_r = fused_head_nopf_reference(f, k, tree, tau=tau, eps=1e-12)
    B = shape[0] // 2
    assert pooled.shape == (2 * B, tree.num_protos_padded) and logsum.shape == (B, tree.num_nodes)
    torch.testing.assert_close(pooled, pooled_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(logsum, logsum_r, atol=1e-4, rtol=1e-5)
    assert (pooled[:, ~torch.from_numpy(tree.proto_valid).cuda()] == 0).all()


@pytest.mark.cuda
def test_training_heads_count_launches_and_check_inputs(card):
    """Autograd through K1 launches K1 then K1b; through K2 launches K2, then
    K1 (the recompute) and K1b.  Bad inputs raise before any launch."""
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tree = _tree("multi_bucket")
    f, k = _inputs(tree, 4, 4, 4, 32, seed=10, dtype=torch.float32)
    f.requires_grad_()
    counts = lambda: (fused_head.launches, head_backward.launches, fused_head_nopf.launches)
    before = counts()
    pf, pooled = fused_head(f, k, tree)
    (pf.sum() + pooled.sum()).backward()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0]
    pooled, logsum = fused_head_nopf(f, k, tree)
    (pooled.sum() + logsum.sum()).backward()
    assert [a - b for a, b in zip(counts(), before)] == [2, 2, 1]
    before = counts()
    pf = pf.detach()
    g = torch.zeros_like(pooled)
    with pytest.raises(TypeError):
        head_backward(pf, None, g.double(), tree)              # g_pooled not f32
    with pytest.raises(TypeError):
        head_backward(pf, pf.bfloat16(), g, tree)              # g_pf dtype
    with pytest.raises(ValueError):
        head_backward(pf.transpose(1, 2), None, g, tree)       # not contiguous
    with pytest.raises(ValueError):
        head_backward(pf, None, g.cpu(), tree)                 # device mismatch
    with torch.inference_mode():
        with pytest.raises(ValueError):
            fused_head_nopf(f[:3], k, tree)                    # odd batch: no view pairs
        with pytest.raises(TypeError):
            fused_head_nopf(f, k.bfloat16(), tree)
        with pytest.raises(ValueError):
            fused_head_nopf(f, k.cpu(), tree)                  # device mismatch
        with pytest.raises(ValueError):
            fused_head_nopf(f.transpose(1, 2), k, tree)        # not contiguous
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name", ["flat768", "mixed"])
def test_wide_node_logits_spread_beyond_the_clip(card, dtype, tree_name):
    """Logits falling 0.6 a column across every node (460 across the flat
    node, 180 across the mixed tree's node of 300, 77 across a 128-column
    part): the slots more than 80 below their node's max take exp(-80) in
    the plain softmax, and each part's own sum is taken against its own
    max, so K1 and K2 must shift by the node max and merge the parts' sums
    to match the plain versions at their usual tolerances."""
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    tree = _tree(tree_name)
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, 4, 9, 11, 72, seed=13, dtype=torch.float32, scale=0.1)
    f[..., 0] = 1.0
    col = torch.from_numpy(np.arange(tree.num_protos_padded)
                           - tree.node_proto_offset[np.maximum(tree.proto_node, 0)])
    k[0] = -0.6 * col.float().cuda()
    f, k = f.to(dt), k.to(dt)
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree)
        pooled2, logsum = fused_head_nopf(f, k, tree, eps=1e-12)
        torch.cuda.synchronize()
        pf_r, pooled_r = fused_head_reference(f, k, tree)
        pooled2_r, logsum_r = fused_head_nopf_reference(f, k, tree, eps=1e-12)
    # some slots sit at the clip: exp(-80) over a sum of at least 1
    assert ((pf_r.float() > 0) & (pf_r.float() < 2e-35)).any()
    assert_pf_close(pf, pf_r, dtype)
    torch.testing.assert_close(pooled, pooled_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(pooled2, pooled2_r, atol=1e-5, rtol=0)
    torch.testing.assert_close(logsum, logsum_r, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,launches", [("flat768", (2, 2, 3)), ("mixed", (3, 3, 4))])
def test_wide_trees_launch_the_kernels_only(card, dtype, tree_name, launches):
    """A tree with a wide node runs K1 as two launches over its parts (the
    row statistics, then the normalised pass) and one over its narrow
    groups, K1b likewise, and K2 as three over the parts (statistics,
    normalised pass, log sums) plus one; no call reaches a plain version."""
    import pipnet_tpu_torch.ops.fused_head as fh
    import pipnet_tpu_torch.ops.fused_head_nopf as fn
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tree = _tree(tree_name)
    assert tree_name == "flat768" or tree.node_proto_offset[-1] % 8   # a shifted first part
    f, k = _inputs(tree, 4, 9, 11, 72, seed=14, dtype=getattr(torch, dtype))
    counts = lambda: (fused_head.launches, head_backward.launches, fused_head_nopf.launches)

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran for CUDA tensors")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((fh, "fused_head_reference"), (fh, "head_backward_reference"),
                          (fh, "segment_softmax"), (fn, "fused_head_nopf_reference"),
                          (fn, "segment_softmax")):
            mp.setattr(mod, name, plain)
        before = counts()
        fg = f.clone().requires_grad_()
        pf, pooled = fused_head(fg, k, tree)
        (pf.float().sum() + pooled.sum()).backward()
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == [launches[0], launches[1], 0]
        with torch.inference_mode():
            fused_head_nopf(f, k, tree)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == list(launches)
    assert torch.isfinite(fg.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_small_pipnet_on_card_matches_cpu(card, compute_dtype):
    """A narrow PIPNet built on the card (kernel head) against the same
    weights on the CPU (plain head): f32 to 1e-4 (cuDNN and oneDNN sum in
    other orders); in bf16 the features within 3% of their scale (the
    two devices round at other places; the kernel's bf16 head is held to
    its plain version above, and pooled values near the 0.1 cut may land
    on either side of it, so logits are not compared in bf16)."""
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu_torch.config import HeadConfig, ModelConfig
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    from pipnet_tpu_torch.ops.fused_head import fused_head
    from pipnet_tpu_torch.tree import Node, Phylogeny, construct_phylo_tree
    depths, dims = (1, 1, 2, 1), (8, 16, 32, 64)
    cfg = ModelConfig(backbone="convnext_tiny_26", image_size=64, num_protos_per_child=10,
                      head=HeadConfig(protopool=False), compute_dtype=compute_dtype,
                      use_pallas_head=True, fast_gelu=True)
    root = construct_phylo_tree(phylo=Phylogeny(newick=TINY))
    root.assign_all_descendents()
    models = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tp.BACKBONES, "convnext_tiny_26", (functools.partial(
            ConvNeXtTiny, stride_threshold=10, depths=depths, dims=dims), dims[-1]))
        for dev in ("cpu", "cuda"):
            models[dev], tree = build_pipnet(Node.from_dict(root.to_dict()), cfg,
                                             device=dev)
    params = random_jax_params(cfg, tree, seed=9, depths=depths, dims=dims)
    xs = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (4, 64, 64, 3)).astype(np.float32))
    out = {}
    before = fused_head.launches
    for dev, m in models.items():
        m.load_state_dict(params_from_jax(params))
        with torch.inference_mode():
            out[dev] = {k: v.float().cpu() for k, v in m(xs.to(dev), inference=True).items()}
    assert fused_head.launches == before + 1
    if compute_dtype == "float32":
        for key in ("features", "pooled", "logits"):
            torch.testing.assert_close(out["cuda"][key], out["cpu"][key], atol=1e-4, rtol=0)
    else:
        fc, fg = out["cpu"]["features"], out["cuda"]["features"]
        assert (fg - fc).abs().max() <= 0.03 * fc.abs().max()


@pytest.mark.cuda
def test_interp_gradients_on_card_match_cpu(card):
    """The adversarial attack (K1 num_steps + 2 times, K1b num_steps) and
    integrated gradients (K1 and K1b num_steps times), at B = 1 with only
    g_pf or only g_pooled reaching K1b, on a narrow f32 PIPNet on the card
    against the same weights on the CPU: within 1e-3 (of the largest
    attribution for integrated gradients; cuDNN and oneDNN sum in other
    orders through a forward and a backward)."""
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu_torch.config import HeadConfig, ModelConfig
    from pipnet_tpu_torch.interp import adversarial_attack
    from pipnet_tpu_torch.interp.adversarial import integrated_gradients_patch
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.tree import Node, Phylogeny, construct_phylo_tree
    depths, dims = (1, 1, 2, 1), (8, 16, 32, 64)
    cfg = ModelConfig(backbone="convnext_tiny_26", image_size=64, num_protos_per_child=10,
                      head=HeadConfig(protopool=False))
    root = construct_phylo_tree(phylo=Phylogeny(newick=TINY))
    root.assign_all_descendents()
    models = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tp.BACKBONES, "convnext_tiny_26", (functools.partial(
            ConvNeXtTiny, stride_threshold=10, depths=depths, dims=dims), dims[-1]))
        for dev in ("cpu", "cuda"):
            models[dev], tree = build_pipnet(Node.from_dict(root.to_dict()), cfg, device=dev)
    params = random_jax_params(cfg, tree, seed=9, depths=depths, dims=dims)
    x = np.random.default_rng(10).standard_normal((64, 64, 3)).astype(np.float32)
    proto = int(np.flatnonzero(tree.proto_valid)[4])
    out = {}
    for dev, m in models.items():
        m.load_state_dict(params_from_jax(params))
        before = (fused_head.launches, head_backward.launches)
        moved, adv = adversarial_attack(m, x, proto, num_steps=3, threshold=0.05)
        ig = integrated_gradients_patch(m, x, proto, num_steps=4).cpu().numpy()
        out[dev] = (moved, adv, ig)
        if dev == "cuda":
            assert (fused_head.launches - before[0], head_backward.launches - before[1]) == \
                (3 + 2 + 4, 3 + 4)
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=0,
                               atol=1e-3 * out["cpu"][2].max())


# ---------------------------------------------------------------------------
# K3 (depthwise 7x7) and K4 (fused ConvNeXt block branch)
# ---------------------------------------------------------------------------

def _dw_inputs(shape, seed, dtype):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    k = torch.from_numpy((r.standard_normal((7, 7, shape[-1])) / 7).astype(np.float32))
    return x.to("cuda", dtype), k.to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 9, 11, 40),       # odd H and W, C not a multiple of the 32-channel slice
    (1, 5, 3, 12),        # map smaller than a tile, C not a multiple of 8
    (2, 26, 26, 64),      # the stage-3 map
    (1, 26, 26, 96),      # the four stage maps, one image each: strips of 4
    (1, 27, 27, 40),      # columns over 26, 27 (the last strip ragged), 28
    (1, 28, 28, 24),      # and 56
    (1, 56, 56, 16),
    (1, 3, 5, 12),        # a map smaller than the 7x7 window
    (2, 26, 26, 100),     # bf16 rows of 200 bytes: not TMA-aligned, direct loads
    (1, 7, 9, 7),         # C below one 32-channel slice and odd
])
def test_dwconv_kernel_matches_plain(card, dtype, shape):
    """K3 and its flipped-kernel form against the plain version: f32 to
    1e-5 of the scale (the same 49 taps in the same order, fused or not);
    bf16 within one bf16 ulp of the scale (2^-7: one rounding of f32 values
    that differ that way)."""
    from pipnet_tpu_torch.ops.dwconv import _forward, dwconv7x7, dwconv7x7_reference
    dt = getattr(torch, dtype)
    x, k = _dw_inputs(shape, seed=sum(shape), dtype=dt)
    with torch.inference_mode():
        for got, want in ((dwconv7x7(x, k), dwconv7x7_reference(x, k)),
                          (_forward(x, k, flip=True),
                           dwconv7x7_reference(x, k.flip(0, 1).contiguous()))):
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == x.shape
            scale = want.float().abs().max()
            bar = (1e-5 if dtype == "float32" else 2.0 ** -7) * scale
            assert (got.float() - want.float()).abs().max() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 9, 11, 40),       # 198 pixels: a ragged last tile, tiles across images
    (1, 7, 5, 768),       # the widest stage, one partial tile
    (2, 27, 27, 96),      # 729 pixels per image
])
def test_cnblock_kernel_matches_plain(card, dtype, fast_gelu, shape):
    """K4 against its plain version (the Pallas rounding order): f32 within
    2e-5 of the output scale (sums of up to 4C products in another order);
    bf16 within one bf16 ulp of the scale (2^-7: the output is rounded once
    from f32 values that differ that way, and a z or h1 element that rounds
    the other way moves the output far less)."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch, cnblock_branch_reference
    dt = getattr(torch, dtype)
    args = _cnblock_inputs(shape, seed=sum(shape), dtype=dt)
    with torch.inference_mode():
        got = cnblock_branch(*args, fast_gelu=fast_gelu)
        torch.cuda.synchronize()
        want = cnblock_branch_reference(*args, fast_gelu=fast_gelu)
    assert got.dtype == dt and got.shape == args[0].shape
    scale = want.float().abs().max()
    bar = (2e-5 if dtype == "float32" else 2.0 ** -7) * scale
    assert (got.float() - want.float()).abs().max() <= bar


# K4's bf16 product launches at the shapes the model gives them: each stage
# at the serving B=8 (stage 0: C = 96, a depth of 1.5 swizzle atoms and a
# 96-column output in a 128-column tile), stage 3 at the training B=128,
# and a ragged map with C = 40 (one depth stage, N = 160, 198 rows)
BLOCK_PART_SHAPES = [(8, 56, 56, 96), (8, 28, 28, 192), (8, 27, 27, 384), (8, 26, 26, 768),
                     (128, 26, 26, 768), (2, 9, 11, 40)]


def _bf16_within_one_ulp_of_scale(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("shape", BLOCK_PART_SHAPES)
def test_cnblock_products_match_plain(card, shape, fast_gelu):
    """K4's second and third launches (``cnblock_up``, ``cnblock_down``: the
    TMA + wgmma product with its epilogue) against their plain pieces on the
    same inputs, bf16 within one bf16 ulp of the output's scale (one
    rounding of f32 sums taken in another order)."""
    from pipnet_tpu_torch.ops import cnblock as cb
    x, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = _cnblock_inputs(shape, seed=sum(shape),
                                                                  dtype=torch.bfloat16)
    with torch.inference_mode():
        z = cb.cnblock_dwln_reference(x, dwk, dwb, lns, lnb)
        h1 = cb.cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu)
        got_h1 = cb.cnblock_up(z, w1, b1, fast_gelu=fast_gelu)
        got_out = cb.cnblock_down(h1, w2, b2, ls)
        torch.cuda.synchronize()
        want_out = cb.cnblock_down_reference(h1, w2, b2, ls)
    _bf16_within_one_ulp_of_scale(got_h1, h1)
    _bf16_within_one_ulp_of_scale(got_out, want_out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 11, 40), (8, 56, 56, 96), (8, 26, 26, 768),
                                   (1, 3, 5, 16)])
def test_cnblock_dwln_matches_plain(card, shape):
    """K4's first launch (depthwise + LayerNorm, z in bf16) against
    ``cnblock_dwln_reference``: within one bf16 ulp of z's scale."""
    from pipnet_tpu_torch.ops import cnblock as cb
    x, dwk, dwb, lns, lnb = _cnblock_inputs(shape, seed=sum(shape), dtype=torch.bfloat16)[:5]
    with torch.inference_mode():
        got = cb.cnblock_dwln(x, dwk, dwb, lns, lnb)
        torch.cuda.synchronize()
        want = cb.cnblock_dwln_reference(x, dwk, dwb, lns, lnb)
    _bf16_within_one_ulp_of_scale(got, want)


def _cnblock_inputs(shape, seed, dtype):
    """x and the ten branch inputs in the JAX layout (w1 (C, 4C), w2 (4C, C)),
    at the scales of ``random_jax_params``."""
    r = np.random.default_rng(seed)
    C = shape[-1]

    def n(s, std):
        return torch.from_numpy((r.standard_normal(s) * std).astype(np.float32))
    ts = [n(shape, 1.0), n((7, 7, C), 49 ** -0.5), n((C,), 0.02), 1.0 + n((C,), 0.05),
          n((C,), 0.02), n((C, 4 * C), C ** -0.5), n((4 * C,), 0.02),
          n((4 * C, C), (4 * C) ** -0.5), n((C,), 0.02),
          torch.from_numpy(r.uniform(0.05, 0.2, C).astype(np.float32))]
    return [t.to("cuda", dtype) for t in ts]


@pytest.mark.cuda
def test_dwconv_and_cnblock_count_launches_and_check_inputs(card):
    """Autograd through K3 launches it once forward and once for dx; K4 is
    one launch in f32 and three in bf16 (depthwise + LayerNorm, then the two
    products); the backward of ``FusedCNBlock`` recomputes the unfused
    composition and launches no K4.  Bad inputs raise before any launch."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch, cnblock_up
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    counts = lambda: (dwconv7x7.launches, cnblock_branch.launches)  # noqa: E731
    x, k = _dw_inputs((2, 6, 7, 16), seed=1, dtype=torch.float32)
    before = counts()
    xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
    dwconv7x7(xg, kg).square().sum().backward()
    assert [a - b for a, b in zip(counts(), before)] == [2, 0]
    xg = x.clone()
    kg = k.clone().requires_grad_()
    dwconv7x7(xg, kg).sum().backward()          # dw only: no dx launch
    assert [a - b for a, b in zip(counts(), before)] == [3, 0]
    args = _cnblock_inputs((2, 5, 6, 16), seed=2, dtype=torch.float32)
    args[0].requires_grad_()
    out = cnblock_branch(*args, fast_gelu=True)
    assert [a - b for a, b in zip(counts(), before)] == [3, 1]
    out.sum().backward()
    assert [a - b for a, b in zip(counts(), before)] == [3, 1]
    assert args[0].grad is not None and args[5].grad is None
    bf = [a.detach().bfloat16().requires_grad_(i == 0) for i, a in enumerate(args)]
    out = cnblock_branch(*bf, fast_gelu=True)
    assert [a - b for a, b in zip(counts(), before)] == [3, 4]
    out.float().sum().backward()
    assert [a - b for a, b in zip(counts(), before)] == [3, 4]
    before = counts()
    plain = [a.detach() for a in args]
    with torch.inference_mode():
        with pytest.raises(TypeError):
            dwconv7x7(x, k.bfloat16())                                  # dtype
        with pytest.raises(ValueError):
            dwconv7x7(x, k.cpu())                                       # device
        with pytest.raises(ValueError):
            dwconv7x7(x.transpose(1, 2), k)                             # contiguity
        with pytest.raises(TypeError):
            cnblock_branch(plain[0].bfloat16(), *plain[1:], fast_gelu=True)
        with pytest.raises(TypeError):
            cnblock_branch(*[a.half() for a in plain], fast_gelu=True)
        with pytest.raises(ValueError):
            cnblock_branch(plain[0], *plain[1:5], plain[5].cpu(), *plain[6:], fast_gelu=True)
        with pytest.raises(ValueError):
            cnblock_branch(plain[0].transpose(1, 2), *plain[1:], fast_gelu=True)
        x12 = _cnblock_inputs((1, 4, 4, 12), seed=3, dtype=torch.float32)
        with pytest.raises(ValueError):
            cnblock_branch(*x12, fast_gelu=True)                        # C % 8 != 0
        with pytest.raises(TypeError):                                  # f32 launches fused
            cnblock_up(plain[0].reshape(-1, 16), plain[5], plain[6], fast_gelu=True)
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("cars", [False, True])
def test_device_augmentation_on_card_matches_cpu(card, cars):
    """The train step's augmentation (transform1, then both views of
    transform2) on the card equals the same functions on the CPU for the
    same draws, drawn by a generator on the card; the device cache gathers
    the same bytes on both."""
    from pipnet_tpu_torch.data import DeviceDataCache
    from pipnet_tpu_torch.train import augment_views, sample_augment
    base = np.random.default_rng(3).integers(0, 256, (20, 72, 72, 3), dtype=np.uint8)
    caches = [DeviceDataCache(base, "u8base", device=d) for d in (card, "cpu")]
    rows = np.asarray([4, 0, 19, 7, 7, 12])
    x, x_cpu = (c.fetch(rows) for c in caches)
    assert x.device.type == "cuda" and torch.equal(x.cpu(), x_cpu)
    draws = sample_augment(len(rows), 72, 64, torch.Generator(device=card).manual_seed(1),
                           cars)
    cpu_draws = type(draws)(draws.geometric.to("cpu"), tuple(v.to("cpu") for v in draws.views))
    # the op counts read with the draws (on a stream of their own) are theirs
    n_ops = 9 if cars else 8
    assert draws.op_counts == [torch.bincount(v.op, minlength=n_ops).tolist()
                               for v in cpu_draws.views]
    for got, want in zip(augment_views(x, 64, draws, cars),
                         augment_views(x_cpu, 64, cpu_draws, cars)):
        assert got.shape == (len(rows), 64, 64, 3)
        torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


# the head's input on the other backbones (at 224^2: ResNet-50/101/152
# 28x28x2048, DINOv2 ViT-S/14 16x16x384), two images on the flagship tree
BACKBONE_HEAD_SHAPES = [(2, 28, 28, 2048), (2, 16, 16, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BACKBONE_HEAD_SHAPES, ids=["resnet50", "dinov2"])
def test_head_kernels_at_backbone_shapes(card, dtype, shape):
    """K1, K1b (with and without g_pf) and K2 at the other backbones' head
    shapes (32 and 6 K-tiles of the TMA ring, 784 and 256 patch rows in
    K1b's slice) against their plain versions, with the bars above; f32 pf
    within 1e-5 · D / 768 (the bar of the flagship's 768 grown with the
    number of terms each logit sums in an order of its own: at D = 2048 the
    card gave 1.95e-5)."""
    from pipnet_tpu_torch.losses.catalog import ALIGN_EPS
    from pipnet_tpu_torch.ops.fused_head import (fused_head, fused_head_reference,
                                                 head_backward, head_backward_reference)
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    tree = _tree("flagship")
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, *shape, seed=11, dtype=dt, scale=0.3 * (768 / shape[-1]) ** 0.5)
    D = shape[-1]
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree)
        pf_r, pooled_r = fused_head_reference(f, k, tree)
        if dtype == "float32":
            bar = 1e-5 * max(D / 768, 1.0)
            torch.testing.assert_close(pf, pf_r, atol=bar, rtol=0)
            torch.testing.assert_close(pooled, pooled_r, atol=bar, rtol=0)
        else:
            assert_pf_close(pf, pf_r, dtype)
            torch.testing.assert_close(pooled, pooled_r, atol=1e-5, rtol=0)
        r = np.random.default_rng(12)
        g_pf = torch.from_numpy(r.standard_normal(pf.shape).astype(np.float32)).to("cuda", dt)
        g_pooled = torch.from_numpy(r.standard_normal(pooled.shape).astype(np.float32)).cuda()
        for g in (g_pf, None):
            d = head_backward(pf_r, g, g_pooled, tree).float()
            w = head_backward_reference(pf_r, g, g_pooled, tree).float()
            bar = (1e-5 if dtype == "float32" else 2.0 ** -7) * w.abs() + 1e-6 * w.abs().max()
            assert ((d - w).abs() <= bar).all(), (d - w).abs().max()
        pooled2, logsum = fused_head_nopf(f, k, tree, eps=ALIGN_EPS)
        pooled2_r, logsum_r = fused_head_nopf_reference(f, k, tree, eps=ALIGN_EPS)
        torch.testing.assert_close(pooled2, pooled2_r, atol=1e-5, rtol=0)
        assert (logsum - logsum_r).abs().max() <= 1e-5 * logsum_r.abs().max() + 1e-4


@pytest.mark.cuda
def test_resnet18_step_on_card_matches_cpu(card):
    """One joint-phase train step of the flagship run config on a full
    ResNet-18 at 32^2, f32 (TF32 off), four images in two views, on the
    card (K1, K1b) and on the CPU (their plain versions) from the same
    weights, statistics, batch and presence noise: the loss within 1e-5,
    every BatchNorm's running statistics within 1e-4 of their largest
    value, and each parameter's gradient (Adam's first moment) within 1e-2
    in norm (cuDNN and oneDNN sum in other orders, and the difference grows
    through the backward of eight blocks and their BatchNorms: layer1's
    gradients differed by 1.0e-3 in norm on the card; a ReLU input within
    rounding of zero may also fall on either side)."""
    import dataclasses
    import os
    from pipnet_tpu_torch.models import build_pipnet, random_jax_variables, state_dict_from_jax
    from pipnet_tpu_torch.run_io import load_run_config
    from pipnet_tpu_torch.train import (Scalars, StepStatics, init_train_state,
                                        make_train_step, phase_for_epoch)
    from torch_port_util import FLAGSHIP_META
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone="resnet18", image_size=32, compute_dtype="float32"))
    r = np.random.default_rng(13)
    xs = torch.from_numpy(r.standard_normal((2, 2, 32, 32, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        _, root, classes = flagship_roots()
        model, tree = build_pipnet(root, cfg.model, weighted=cfg.train.loss.weighted_ce,
                                   class_names=classes, device=dev)
        model.load_state_dict(state_dict_from_jax(random_jax_variables(cfg.model, tree, seed=3)))
        ys = torch.from_numpy(np.random.default_rng(14).integers(0, tree.num_classes, 2))
        statics = StepStatics(phase=phase_for_epoch(20, cfg.train, pretrain=False),
                              mask_prune_active=True, eta_min_net=5e-6)
        step = make_train_step(model, tree, cfg, statics)
        state, m = step(init_train_state(model, seed=0), xs[0].to(dev), xs[1].to(dev),
                        ys.to(dev), Scalars(3.0, 100.0, 0.5, 5.0, 2.0),
                        presence_noise=torch.zeros((tree.num_protos_padded, 2), device=dev))
        out[dev] = (float(m["loss"]), {k: v.cpu() for k, v in model.state_dict().items()},
                    {k: v.cpu() for k, v in state.opt.mu.items()})
    (loss_c, sd_c, mu_c), (loss_g, sd_g, mu_g) = out["cpu"], out["cuda"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, v in sd_c.items():
        if "running_" in k:
            assert (sd_g[k] - v).abs().max() <= 1e-4 * max(v.abs().max().item(), 1.0), k
    for k, v in mu_c.items():
        assert (mu_g[k] - v).norm() <= 1e-2 * v.norm() + 1e-12, k
