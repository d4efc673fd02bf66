"""The port's train step against the JAX package's ``make_train_step``, on
the flagship run's loss set, optimiser and clipping, with a narrow ConvNeXt
and the multi-bucket tree, 48^2 images, batch 4 in two views, f32.

Both start from the same seeded parameters and batch and are handed the
same presence Gumbel sample (the two packages' random streams differ;
stochastic depth is off).  The JAX side runs its XLA head composition, the
same function as its fused head.  Gradients are read from Adam's first
moment after the step (mu = 0.1 g for a parameter's first step): within
1e-4 as gradients.  Updated parameters agree within 1e-6 where |g| > 1e-6;
where g is ~0 Adam's first step is lr * sign(g), and the sign of a
rounding-level gradient is arbitrary, so there the bar is 2 lr.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.optimizer as jax_optimizer
import pipnet_tpu.train.step as jax_step
import pipnet_tpu_torch.train as port_train
from torch_port_util import (MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, flagship_configs,
                             roots_from_newick, small_backbones, to_jax)

B, S = 4, 48
# (epoch, pretrain, mask-prune active, align_pf weight, tanh weight)
PHASES = {"train": (20, False, True, 5.0, 2.0),
          "pretrain": (3, True, False, 0.25, 5.0),
          "finetune": (3, False, False, 5.0, 2.0)}


def _models(align_eps=0.01):
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    jcfg, tcfg = flagship_configs(image_size=S, batch_size=B, align_eps=align_eps)
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    params = random_jax_params(tcfg.model, tt, seed=11, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    return jcfg, tcfg, mj, tj, mt, tt, params


def _batch(tree):
    r = np.random.default_rng(12)
    xs = r.standard_normal((2, B, S, S, 3)).astype(np.float32)
    return xs[0], xs[1], r.integers(0, tree.num_classes, B)


def _statics(pkg, cfg, phase_name):
    epoch, pretrain, mask_prune, apf_w, tanh_w = PHASES[phase_name]
    phase = pkg.phase_for_epoch(epoch, cfg.train, pretrain=pretrain)
    return (pkg.StepStatics(phase=phase, mask_prune_active=mask_prune, eta_min_net=5e-6),
            dict(net_t=3.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=apf_w,
                 tanh_weight=tanh_w))


def _presence_noise(rng, P):
    """The presence Gumbel sample the JAX step draws from its state's key."""
    _, _, loss_rng, _ = jax.random.split(rng, 4)
    return np.asarray(jax.random.gumbel(jax.random.fold_in(loss_rng, 1), (P, 2), jnp.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_Jax = types.SimpleNamespace(
    phase_for_epoch=jax_optimizer.phase_for_epoch, adam_init=jax_optimizer.adam_init,
    **{n: getattr(jax_step, n) for n in ("Scalars", "StepStatics", "TrainState",
                                         "make_train_step")})
_Port = port_train


def _run_jax(mj, tj, jcfg, phase_name, params, xs1, xs2, ys, steps):
    statics, sc = _statics(_Jax, jcfg, phase_name)
    state = _Jax.TrainState(params=to_jax(params), batch_stats={},
                            opt=_Jax.adam_init(to_jax(params)), rng=jax.random.PRNGKey(0))
    out = []
    with small_backbones():
        step = jax.jit(_Jax.make_train_step(mj, tj, jcfg, statics))
        for _ in range(steps):
            noise = _presence_noise(state.rng, tj.num_protos_padded)
            state, metrics = step(state, jnp.asarray(xs1), jnp.asarray(xs2),
                                  jnp.asarray(ys), _Jax.Scalars.make(**sc))
            out.append((noise, _np(state.params), _np(state.opt), _np(metrics)))
    return out


def _run_port(mt, tt, tcfg, phase_name, xs1, xs2, ys, noise, state=None, **kw):
    statics, sc = _statics(_Port, tcfg, phase_name)
    step = _Port.make_train_step(mt, tt, tcfg, statics, **kw)
    state = state or _Port.init_train_state(mt, seed=0)
    return step(state, torch.from_numpy(xs1), torch.from_numpy(xs2), torch.from_numpy(ys),
                _Port.Scalars(**sc), presence_noise=torch.tensor(noise))


@pytest.fixture(scope="module")
def runs():
    """Per phase: the JAX package's first step (two steps in 'train'), and the
    port's first step from the same start."""
    jcfg, tcfg, mj, tj, mt, tt, params = _models()
    xs1, xs2, ys = _batch(tt)
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    out = {}
    for name in PHASES:
        jax_steps = _run_jax(mj, tj, jcfg, name, params, xs1, xs2, ys,
                             steps=2 if name == "train" else 1)
        mt.load_state_dict(initial)
        state, metrics = _run_port(mt, tt, tcfg, name, xs1, xs2, ys, jax_steps[0][0])
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in state.params.items()}
        out[name] = dict(jax=jax_steps, state=state, metrics=metrics, grads=grads,
                         params={k: v.clone() for k, v in mt.state_dict().items()})
    return dict(out, cfgs=(jcfg, tcfg), models=(mt, tt), batch=(xs1, xs2, ys),
                initial=initial)


def _check_metrics(mt, mj):
    assert set(mt) == set(mj), set(mt) ^ set(mj)
    for k, v in mj.items():
        got = mt[k].numpy()
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=k)


def _check_update(params_t, opt_t, jparams, jopt, g_jax, lr_max):
    from pipnet_tpu_torch.models import opt_state_from_jax, params_from_jax
    want_p = params_from_jax(jparams)
    want_opt = opt_state_from_jax(jopt)
    assert opt_t.count == want_opt.count
    for name, want in want_p.items():
        np.testing.assert_allclose(opt_t.mu[name].numpy(), want_opt.mu[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"mu {name}")
        diff = (params_t[name] - want).abs().numpy()
        big = np.abs(g_jax[name]) > 1e-6
        assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
        assert (diff <= 2 * lr_max + 1e-6).all(), (name, diff.max())


@pytest.mark.parametrize("phase_name", sorted(PHASES))
def test_first_step_matches_jax(runs, phase_name):
    """Loss, every loss/* and per-node metric, accuracy counts, the global
    gradient norm, gradients (Adam's first moment) and updated parameters."""
    from pipnet_tpu_torch.models import params_from_jax
    r = runs[phase_name]
    _, jparams, jopt, jmetrics = r["jax"][0]
    _check_metrics(r["metrics"], jmetrics)
    g_jax = {n: m.numpy() / 0.1 for n, m in params_from_jax(jopt.mu).items()}
    _check_update(r["params"], r["state"].opt, jparams, jopt, g_jax, lr_max=1e-3)
    assert np.isfinite(float(r["metrics"]["loss"]))


@pytest.mark.parametrize("phase_name", sorted(PHASES))
def test_frozen_groups_get_no_gradient(runs, phase_name):
    """Groups that do not train in the phase are cut out of autograd: their
    .grad stays None.  In the train phase every trainable parameter gets one
    (elsewhere some, such as the presence logits in finetune, feed no loss)."""
    from pipnet_tpu_torch.train import group_trainable, label_params
    r = runs[phase_name]
    _, tcfg = runs["cfgs"]
    phase = _statics(_Port, tcfg, phase_name)[0].phase
    labels = label_params(r["grads"], tcfg.model.backbone)
    for name, g in r["grads"].items():
        if not group_trainable(labels[name], phase):
            assert g is None, name
        elif phase_name == "train":
            assert g is not None, name
    assert r["grads"]["backbone.stem_conv.weight"] is None
    if phase_name == "train":     # unfrozen: the backward reaches down2, no further
        assert r["grads"]["backbone.down2_conv.weight"] is not None
        assert r["grads"]["backbone.stage1_block0.mlp_in.weight"] is None


def test_second_step_from_jax_state_matches_jax(runs):
    """The port continues from the JAX package's parameters and Adam state
    after one step (counts 1) and matches its second step."""
    from pipnet_tpu_torch.models import opt_state_from_jax, params_from_jax
    _, tcfg = runs["cfgs"]
    mt, tt = runs["models"]
    xs1, xs2, ys = runs["batch"]
    (_, p1, o1, _), (noise, p2, o2, m2) = runs["train"]["jax"]
    mt.load_state_dict(params_from_jax(p1))
    state = _Port.init_train_state(mt, seed=0)
    state = dataclasses.replace(state, opt=opt_state_from_jax(o1))
    assert set(state.opt.count.values()) == {0, 1}
    state, metrics = _run_port(mt, tt, tcfg, "train", xs1, xs2, ys, noise, state=state)
    _check_metrics(metrics, m2)
    mu1, mu2 = params_from_jax(o1.mu), params_from_jax(o2.mu)
    g2 = {n: (mu2[n] - 0.9 * mu1[n]).numpy() / 0.1 for n in mu2}
    _check_update(dict(mt.state_dict()), state.opt, p2, o2, g2, lr_max=1e-3)


def test_path_b_equals_path_a():
    """With align_eps unset, the step through K2 (fuse_align_pf) gives the
    loss and the add-on kernel update of the step that materialises pf
    (f32, plain versions on the CPU)."""
    _, tcfg, _, _, mt, tt, _ = _models(align_eps=None)
    xs1, xs2, ys = _batch(tt)
    noise = np.random.default_rng(13).gumbel(size=(tt.num_protos_padded, 2)).astype(np.float32)
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    results = []
    for fuse in (False, True):
        mt.load_state_dict(initial)
        _, metrics = _run_port(mt, tt, tcfg, "train", xs1, xs2, ys, noise, fuse_align_pf=fuse)
        results.append((metrics, mt.head.add_on_kernel.detach().clone()))
    (ma, ka), (mb, kb) = results
    assert "loss/align_pf" in mb
    for k in ("loss", "loss/align_pf", "loss/tanh", "grad_norm"):
        assert float(mb[k]) == pytest.approx(float(ma[k]), rel=1e-5), k
    torch.testing.assert_close(kb, ka, atol=1e-5, rtol=0)


def test_fuse_align_pf_refuses_configs_it_cannot_run(runs):
    """An explicit fuse_align_pf=True is never ignored: with align_eps set,
    or in a finetune phase, the port raises (the JAX package silently falls
    back to materialising pf)."""
    _, tcfg = runs["cfgs"]
    mt, tt = runs["models"]
    assert tcfg.train.loss.align_eps is not None
    with pytest.raises(ValueError, match="align_eps"):
        _Port.make_train_step(mt, tt, tcfg, _statics(_Port, tcfg, "train")[0],
                              fuse_align_pf=True)
    cfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, loss=dataclasses.replace(tcfg.train.loss, align_eps=None)))
    with pytest.raises(ValueError, match="finetune"):
        _Port.make_train_step(mt, tt, cfg, _statics(_Port, cfg, "finetune")[0],
                              fuse_align_pf=True)


def test_uint8_input_raises(runs):
    """A uint8 batch is one shared view a sample, augmented on the device
    (``tests/test_torch_data_step.py``): with a second view, or smaller than
    the image size, the step raises."""
    _, tcfg = runs["cfgs"]
    mt, tt = runs["models"]
    step = _Port.make_train_step(mt, tt, tcfg, _statics(_Port, tcfg, "train")[0])
    x = torch.zeros((B, S + 4, S + 4, 3), dtype=torch.uint8)
    args = (torch.zeros(B, dtype=torch.long), _Port.Scalars(0.0, 1.0, 0.0, 5.0, 2.0))
    with pytest.raises(ValueError, match="uint8"):
        step(_Port.init_train_state(mt), x, x, *args)
    with pytest.raises(ValueError, match="smaller than the image size"):
        step(_Port.init_train_state(mt), x[:, :S - 1, :S - 1], None, *args)
