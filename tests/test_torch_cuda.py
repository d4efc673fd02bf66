"""Tests of the port that need a CUDA card: the hand-written kernels (K1,
its adjoint K1b, the no-pf head K2) against their plain versions on the
card, the wrappers' launch counts and input checks, and a small model on
the card against the same model on the CPU.

They skip without a card.  The card's host has no JAX, so this file imports
none and uses no fixture of ``conftest.py``; run it there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_util import MULTI_NEWICK, budget, compiled_pair, flagship_roots

TINY = ("((((cub_001_A:1,cub_002_B:1):1,cub_003_C:2):2,((cub_004_D:1.5,"
        "cub_005_E:1.5):1,cub_006_F:2.5):1.5):1,(cub_007_G:2,cub_008_H:2):3);")
BF16_PF_ATOL = 2.0 ** -8      # one bf16 ulp below 1.0


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
    newick, per = {"multi_bucket": (MULTI_NEWICK, (2, 3)), "tiny": (TINY, (10, 0))}[name]
    return compiled_pair(newick, *per)[1]


# (tree, shape (B, H, W, D), tau): several bucket widths with D not a
# multiple of the depth tile; rows not a multiple of the row tile; the
# flagship tree at the training slice's per-image shape
KERNEL_CASES = [("multi_bucket", (4, 9, 11, 72), 0.5), ("tiny", (2, 13, 13, 64), 1.0),
                ("flagship", (4, 26, 26, 768), 1.0)]


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
])
def test_fused_head_kernel_matches_plain(card, dtype, tree_name, shape, tau):
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    newick, budget = {"multi_bucket": (MULTI_NEWICK, (2, 3)),
                      "tiny": (TINY, (10, 0))}[tree_name]
    _, tree = compiled_pair(newick, *budget)
    dt = getattr(torch, dtype)
    f, k = _inputs(tree, *shape, seed=5, dtype=dt)
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree, tau=tau)
        torch.cuda.synchronize()
        pf_r, pooled_r = fused_head_reference(f, k, tree, tau=tau)
    assert pf.dtype == dt and pooled.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else BF16_PF_ATOL
    torch.testing.assert_close(pf.float(), pf_r.float(), atol=atol, rtol=0)
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
    assert fused_head.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tree_name,shape,tau", KERNEL_CASES)
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
@pytest.mark.parametrize("tree_name,shape,tau", KERNEL_CASES)
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
