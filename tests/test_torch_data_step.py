"""One uint8 train step of the port against the JAX package's step, on the
flagship run's loss set, optimiser and clipping with a narrow ConvNeXt and
the multi-bucket tree, 48^2 images, batch 4, f32 (the setting of
``tests/test_torch_train_step.py``, whose helpers and bars this reuses).

The port's step takes one uint8 batch (the 56^2 resized base: transform1
then transform2; or the 52^2 geometric view: transform2 only) and augments
it on the device with the JAX step's own draws (``jax_step_augment_draws``).
The JAX step is fed the same two views as float, so the two steps see the
same pixels: loss, every metric, gradients and updated parameters at the
bars of the float step.  The port's views are also held within one grey
level of the views the JAX step makes from the same uint8 batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipnet_tpu.ops.device_augment import two_view_transform2
from pipnet_tpu.ops.device_geometric import transform1_batch
from test_torch_train_step import (B, S, _Jax, _Port, _check_metrics, _check_update, _models,
                                   _run_jax, _statics)
from torch_port_util import jax_step_augment_draws


@pytest.fixture(scope="module")
def models():
    return _models()


def _jax_views(x_u8, size):
    """The two views the JAX step derives from a uint8 batch with its state
    key ``PRNGKey(0)``."""
    _, _, _, aug = jax.random.split(jax.random.PRNGKey(0), 4)
    x = jnp.asarray(x_u8)
    if size > S + 4:
        aug, geo = jax.random.split(aug)
        x = transform1_batch(x, geo, S + 4)
    return [np.asarray(v) for v in two_view_transform2(x, aug, S)]


@pytest.mark.parametrize("size", [S + 8, S + 4])
def test_uint8_step_matches_jax_step_on_the_same_views(models, size):
    from pipnet_tpu_torch.models import params_from_jax
    from pipnet_tpu_torch.train import augment_views
    jcfg, tcfg, mj, tj, mt, tt, params = models
    mt.load_state_dict(params_from_jax(params))
    r = np.random.default_rng(21)
    x_u8 = r.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    ys = r.integers(0, tt.num_classes, B)
    draws = jax_step_augment_draws(jax.random.PRNGKey(0), B, size, S)
    v1, v2 = (v.numpy() for v in augment_views(torch.from_numpy(x_u8), S, draws))
    level = 1.0 / (255.0 * 0.225)
    for got, want in zip((v1, v2), _jax_views(x_u8, size)):
        assert got.shape == (B, S, S, 3)
        assert np.abs(got - want).max() <= level + 1e-6
    assert np.abs(v1 - v2).max() > 0.5          # the two views differ

    ((noise, jparams, jopt, jmetrics),) = _run_jax(mj, tj, jcfg, "train", params, v1, v2, ys,
                                                   steps=1)
    statics, sc = _statics(_Port, tcfg, "train")
    step = _Port.make_train_step(mt, tt, tcfg, statics)
    state, metrics = step(_Port.init_train_state(mt, seed=0), torch.from_numpy(x_u8), None,
                          torch.from_numpy(ys), _Port.Scalars(**sc),
                          presence_noise=torch.tensor(noise), augment_draws=draws)
    _check_metrics(metrics, jmetrics)
    g_jax = {n: m.numpy() / 0.1 for n, m in params_from_jax(jopt.mu).items()}
    _check_update(dict(mt.state_dict()), state.opt, jparams, jopt, g_jax, lr_max=1e-3)


def test_uint8_step_draws_from_the_state_generator(models):
    """Without given draws the augmentation draws from the TrainState's
    generator: the same seed gives the same step, another seed another."""
    from pipnet_tpu_torch.models import params_from_jax
    _, tcfg, _, _, mt, tt, params = models
    x_u8 = torch.from_numpy(np.random.default_rng(22).integers(0, 256, (B, S + 8, S + 8, 3),
                                                               dtype=np.uint8))
    ys = torch.zeros(B, dtype=torch.long)
    statics, sc = _statics(_Port, tcfg, "train")
    step = _Port.make_train_step(mt, tt, tcfg, statics)
    noise = torch.zeros(tt.num_protos_padded, 2)
    losses = []
    for seed in (1, 1, 2):
        mt.load_state_dict(params_from_jax(params))
        _, m = step(_Port.init_train_state(mt, seed=seed), x_u8, None, ys, _Port.Scalars(**sc),
                    presence_noise=noise)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]
