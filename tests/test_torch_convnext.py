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
