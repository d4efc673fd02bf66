"""The port's ConvNeXt backbone against the JAX package's on the same
(converted) parameters and images: f32 to 1e-5 for the 26 / 13 / 7 stride
variants with exact and tanh GELU, and bf16 to a stated looser bar."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (SMALL_DEPTHS, SMALL_DIMS, SMALL_THRESHOLDS,
                             compiled_pair, to_jax)


def _backbone_params(seed):
    """Seeded random backbone params in the JAX layout, and the port's
    state_dict for the same values."""
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models.convert import params_from_jax, random_jax_params
    _, tt = compiled_pair("((cub_001_A:1,cub_002_B:1):1,cub_003_C:1);", 2, 0)
    params = random_jax_params(ModelConfig(), tt, seed=seed,
                               depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    state = {k[len("backbone."):]: v for k, v in params_from_jax(params).items()
             if k.startswith("backbone.")}
    return params["backbone"], state


def _run_both(name, fast_gelu, jdtype, tdtype, seed=0, size=64):
    from pipnet_tpu.models.convnext import ConvNeXtTiny as JaxConvNeXt
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    thr = SMALL_THRESHOLDS[name]
    params, state = _backbone_params(seed)
    x = np.random.default_rng(seed + 100).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    jm = JaxConvNeXt(stride_threshold=thr, depths=SMALL_DEPTHS, dims=SMALL_DIMS,
                     fast_gelu=fast_gelu, dtype=jdtype)
    want = np.asarray(jm.apply({"params": to_jax(params)}, jnp.asarray(x)),
                      np.float32)
    tm = ConvNeXtTiny(stride_threshold=thr, depths=SMALL_DEPTHS, dims=SMALL_DIMS,
                      fast_gelu=fast_gelu, dtype=tdtype)
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(SMALL_THRESHOLDS))
@pytest.mark.parametrize("fast_gelu", [False, True])
def test_f32_matches_jax(name, fast_gelu):
    got, want = _run_both(name, fast_gelu, jnp.float32, torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bf16_matches_jax():
    """bf16 compute in both; the two frameworks round at different places
    (conv+bias and matmul+bias fused here, rounded twice in XLA), so each of
    the five blocks may move a feature by a few bf16 ulps (measured: 1.1% of
    the feature scale at most): bar 3% of the feature scale."""
    got, want = _run_both("convnext_tiny_26", True, jnp.bfloat16, torch.bfloat16)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.03 * scale


@pytest.mark.parametrize("name,size,hw", [("convnext_tiny_26", 224, 26),
                                          ("convnext_tiny_13", 224, 13),
                                          ("convnext_tiny_7", 224, 7)])
def test_latent_shape_and_constructors(name, size, hw):
    """The full-width constructors' stride surgery gives the latent that
    ``latent_shape`` predicts (checked on a meta-device model: no memory)."""
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models import convnext
    from pipnet_tpu_torch.models.pipnet import latent_shape
    assert latent_shape(ModelConfig(backbone=name, image_size=size)) == (hw, hw)
    with torch.device("meta"):
        m = getattr(convnext, name)()
        out = m(torch.empty(1, size, size, 3))
    assert tuple(out.shape) == (1, hw, hw, 768)


def test_stochastic_depth_drops_whole_rows_with_the_jax_ramp():
    """Training drops a block's whole residual branch per sample (kept rows
    scaled by 1/keep), drawing from the generator given; the probability
    ramps linearly over the blocks as in the JAX package."""
    from pipnet_tpu_torch.models.convnext import CNBlock, ConvNeXtTiny
    m = ConvNeXtTiny(stride_threshold=10, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    n = sum(SMALL_DEPTHS)
    probs = [m.get_submodule(f"stage{s}_block{b}").sd_prob
             for s, d in enumerate(SMALL_DEPTHS) for b in range(d)]
    np.testing.assert_allclose(probs, [0.1 * i / (n - 1) for i in range(n)])
    block = CNBlock(8, sd_prob=0.5)
    with torch.no_grad():
        block.layer_scale.fill_(0.5)
        x = torch.randn(64, 5, 5, 8)
        branch = block(x, torch.float32) - x
        gen = torch.Generator().manual_seed(3)
        out = block(x, torch.float32, train=True, generator=gen)
        again = block(x, torch.float32, train=True,
                      generator=torch.Generator().manual_seed(3))
    dropped = (out == x).flatten(1).all(1)
    kept = torch.isclose(out, x + branch / 0.5, atol=1e-6).flatten(1).all(1)
    assert (dropped ^ kept).all() and 10 < int(dropped.sum()) < 54
    assert torch.equal(out, again)


def test_param_groups_match_jax():
    from pipnet_tpu.models.convnext import convnext_param_groups as jax_groups
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny, convnext_param_groups
    with torch.device("meta"):
        names = [n for n, _ in ConvNeXtTiny().named_children()]
    assert convnext_param_groups(names) == jax_groups({n: None for n in names})
    assert set(convnext_param_groups(names).values()) == {"train", "freeze", "backbone",
                                                          "frozen"}
