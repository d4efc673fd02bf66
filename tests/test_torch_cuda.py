"""Tests of the port that need a CUDA card: the hand-written kernels against
their plain versions on the card, the wrappers' launch counts and input
checks, and a small model on the card against the same model on the CPU.

They skip without a card.  The card's host has no JAX, so this file imports
none and uses no fixture of ``conftest.py``; run it there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_util import MULTI_NEWICK, compiled_pair

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
    with pytest.raises(NotImplementedError, match="backward"):
        fused_head(f, k.clone().requires_grad_(), tree)
    assert fused_head.launches == before + 2


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
