"""The fused-backbone configuration (``use_pallas_backbone``: every ConvNeXt
block's branch through K4) as a slice: the port's small-backbone
``PIPNet`` against the JAX package's on converted parameters, one train
step against the JAX step, and the parameter tree, which the fused
configuration shares with the unfused one.  The JAX side runs its Pallas
block kernel in interpret mode (monkeypatched in; nothing in the JAX
package changes); the port runs K4's plain version on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as ts
from torch_port_util import (MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, flagship_configs,
                             roots_from_newick, small_backbones, to_jax)


@pytest.fixture
def interpret_blocks():
    """The JAX ``CNBlock`` looks ``make_fused_cnblock`` up at call time; on the
    CPU its kernel runs only in interpret mode."""
    import pipnet_tpu.ops.pallas_convnext as pc
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc, "make_fused_cnblock",
                   functools.partial(pc.make_fused_cnblock, interpret=True))
        yield


def _fused(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              use_pallas_backbone=True))


def _models(image_size=48, batch_size=4, **model):
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    jcfg, tcfg = [dataclasses.replace(c, model=dataclasses.replace(c.model, **model)) for c in
                  map(_fused, flagship_configs(image_size=image_size, batch_size=batch_size))]
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    params = random_jax_params(tcfg.model, tt, seed=11, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    return jcfg, tcfg, mj, tj, mt, tt, params


def test_the_port_builds_every_block_fused():
    _, _, _, _, mt, _, _ = _models()
    blocks = [m for n, m in mt.backbone.named_children() if n.startswith("stage")]
    assert len(blocks) == sum(SMALL_DEPTHS) and all(b.fused for b in blocks)


@pytest.mark.parametrize("key", ["features", "pooled", "logits"])
def test_fused_pipnet_forward_matches_jax(interpret_blocks, key):
    """Inference forward of the whole small model (f32): features, pooled and
    logits to 1e-5."""
    _, _, mj, _, mt, _, params = _models(image_size=64)
    xs = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with small_backbones():
        want = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)[key]
    with torch.no_grad():
        got = mt(torch.from_numpy(xs), inference=True)[key]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_f32_kernel_configuration_forward_matches_jax(interpret_blocks, fast_gelu):
    """The f32 kernel configuration (``compute_dtype`` float32 with
    ``use_pallas_head`` and ``use_pallas_backbone`` on, the configuration
    phase 18 of ``chip_smoke.py`` serves and trains on the card) of the
    small model, inference forward: the JAX package's head runs its Pallas
    kernel and every block its Pallas block kernel in interpret mode, the
    port K1's and K4's plain versions on the CPU.  features, pf, pooled and
    logits to 1e-5, with the flagship's tanh GELU and with erf."""
    _, _, mj, _, mt, _, params = _models(image_size=64, use_pallas_head=True,
                                         fast_gelu=fast_gelu)
    xs = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with small_backbones():
        want = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)
    with torch.no_grad():
        got = mt(torch.from_numpy(xs), inference=True)
    for key in ("features", "proto_features", "pooled", "logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0,
                                   err_msg=key)


def test_fused_train_step_matches_jax(interpret_blocks):
    """One train step (epoch 20: joint phase, backbone unfrozen, mask-prune
    on) of the fused configuration against the JAX step, at the bars of
    ``tests/test_torch_train_step.py``: loss and every metric, gradients
    (Adam's first moment) and updated parameters.  The unfrozen blocks'
    gradients come through ``FusedCNBlock``'s recompute."""
    from pipnet_tpu_torch.models import params_from_jax
    jcfg, tcfg, mj, tj, mt, tt, params = _models()
    xs1, xs2, ys = ts._batch(tt)
    (noise, jparams, jopt, jmetrics), = ts._run_jax(mj, tj, jcfg, "train", params, xs1, xs2,
                                                    ys, steps=1)
    state, metrics = ts._run_port(mt, tt, tcfg, "train", xs1, xs2, ys, noise)
    ts._check_metrics(metrics, jmetrics)
    g_jax = {n: m.numpy() / 0.1 for n, m in params_from_jax(jopt.mu).items()}
    ts._check_update(dict(mt.state_dict()), state.opt, jparams, jopt, g_jax, lr_max=1e-3)
    assert state.params["backbone.stage2_block1.mlp_in.weight"].grad is not None
    assert state.params["backbone.stage1_block0.mlp_in.weight"].grad is None


def test_params_from_jax_maps_the_fused_parameter_tree():
    """The fused JAX model's ``init`` gives the same leaves and shapes as
    ``random_jax_params``, and ``params_from_jax`` maps them onto exactly
    the fused port model's ``state_dict``."""
    from pipnet_tpu_torch.models import params_from_jax, random_jax_params
    jcfg, tcfg, mj, _, mt, tt, _ = _models()
    with small_backbones():
        shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 48, 48, 3)))["params"]
    ours = random_jax_params(tcfg.model, tt, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(ours) == flat(shapes)
    state = params_from_jax(ours)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in mt.state_dict().items()}
