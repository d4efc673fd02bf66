"""One train step per backbone and phase in the port against the JAX
package's ``make_train_step`` (the backbones, sizes and seeded weights of
``tests/test_torch_backbones.py``), and path B against path A.

Bars as ``tests/test_torch_train_step.py`` checks the ConvNeXt's step:
loss and every metric within 1e-5, gradients from Adam's first moment
within 1e-4, updated parameters within 1e-6 where the gradient is not ~0;
BatchNorm buffers after the step within 1e-5.

One stated exception: on the Bottleneck stack a pre-activation of the last
block lies within f32 rounding of zero, so the two packages' ReLUs disagree
on it and one sample's contribution moves a few gradients by up to 9% of
their largest (the port's f32 gradients agree with the float64 ones to
4e-6 there, the JAX package's do not).  There the step's gradients are held
in norm (1e-2 relative), the global gradient norm to 1e-3 and the updated
parameters in count (at most 2% of those with a gradient off by more than
1e-6), and ``test_torch_backbones.py::test_backbone_gradients_equal_jax_in_float64``
holds both packages' backbones, forward and gradients, equal in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.optimizer as jax_optimizer
import pipnet_tpu.train.step as jax_step
import pipnet_tpu_torch.train as port_train
from test_torch_backbones import B, SIZES, _images, _models, _np
from torch_port_util import small_zoo, to_jax

PHASES = {"train": (20, False, True, 5.0, 2.0),
          "pretrain": (3, True, False, 0.25, 5.0),
          "finetune": (3, False, False, 5.0, 2.0)}


def _statics(optimizer, step, cfg, phase_name):
    epoch, pretrain, mask_prune, apf_w, tanh_w = PHASES[phase_name]
    phase = optimizer.phase_for_epoch(epoch, cfg.train, pretrain=pretrain)
    return (step.StepStatics(phase=phase, mask_prune_active=mask_prune, eta_min_net=5e-6),
            dict(net_t=3.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=apf_w,
                 tanh_weight=tanh_w))


def _presence_noise(rng, P):
    _, _, loss_rng, _ = jax.random.split(rng, 4)
    return np.asarray(jax.random.gumbel(jax.random.fold_in(loss_rng, 1), (P, 2), jnp.float32))


@pytest.fixture(scope="module", params=sorted(SIZES))
def stepped(request):
    """Per phase: the JAX package's first step and the port's from the
    same parameters, statistics and batch."""
    backbone = request.param
    jcfg, tcfg, mj, tj, mt, tt, variables = _models(backbone, align_eps=0.01)
    S = SIZES[backbone]
    xs = _images(2 * B, S, 12)
    ys = np.random.default_rng(13).integers(0, tt.num_classes, B)
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    out = {}
    for name in PHASES:
        statics, sc = _statics(jax_optimizer, jax_step, jcfg, name)
        state = jax_step.TrainState(params=to_jax(variables["params"]),
                                    batch_stats=to_jax(variables["batch_stats"]),
                                    opt=jax_optimizer.adam_init(to_jax(variables["params"])),
                                    rng=jax.random.PRNGKey(0))
        noise = _presence_noise(state.rng, tj.num_protos_padded)
        with small_zoo():
            step = jax.jit(jax_step.make_train_step(mj, tj, jcfg, statics))
            new, metrics = step(state, jnp.asarray(xs[:B]), jnp.asarray(xs[B:]),
                                jnp.asarray(ys), jax_step.Scalars.make(**sc))
        mt.load_state_dict(initial)
        pstatics, _ = _statics(port_train, port_train, tcfg, name)
        pstep = port_train.make_train_step(mt, tt, tcfg, pstatics)
        pstate = port_train.init_train_state(mt, seed=0)
        pstate, pmetrics = pstep(pstate, torch.from_numpy(xs[:B]), torch.from_numpy(xs[B:]),
                                 torch.from_numpy(ys), port_train.Scalars(**sc),
                                 presence_noise=torch.tensor(noise))
        out[name] = dict(params=_np(new.params), stats=_np(new.batch_stats), opt=_np(new.opt),
                         metrics=_np(metrics), state=pstate, port_metrics=pmetrics,
                         port={k: v.clone() for k, v in mt.state_dict().items()},
                         initial=initial)
    return backbone, tcfg, out


@pytest.mark.parametrize("phase_name", sorted(PHASES))
def test_train_step_matches_jax(stepped, phase_name):
    """Loss, every metric, gradients (Adam's first moment), the updated
    parameters and the BatchNorm running statistics after the step."""
    from pipnet_tpu_torch.models import opt_state_from_jax, params_from_jax
    backbone, _, out = stepped
    r = out[phase_name]
    kink = backbone == "resnet50"          # see the module docstring
    jm, tm = r["metrics"], r["port_metrics"]
    assert set(tm) == set(jm), set(tm) ^ set(jm)
    for k, v in jm.items():
        got = tm[k].numpy()
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            rtol = 1e-3 if kink and k == "grad_norm" else 1e-5
            np.testing.assert_allclose(got, v, rtol=rtol, atol=1e-5, err_msg=k)
    want_p = params_from_jax(r["params"], batch_stats=r["stats"])
    want_opt = opt_state_from_jax(r["opt"])
    assert r["state"].opt.count == want_opt.count
    g_jax = {n: m.numpy() / 0.1 for n, m in want_opt.mu.items()}
    for name, want in want_p.items():
        got = r["port"][name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
            continue
        mu_t, mu_j = r["state"].opt.mu[name].numpy(), want_opt.mu[name].numpy()
        diff = (got - want).abs().numpy()
        big = np.abs(g_jax[name]) > 1e-6
        if kink:
            assert np.linalg.norm(mu_t - mu_j) <= 1e-2 * np.linalg.norm(mu_j) + 1e-7, name
            assert (diff[big] > 1e-6).sum() <= 0.02 * big.sum(), name
        else:
            np.testing.assert_allclose(mu_t, mu_j, atol=1e-5, rtol=0, err_msg=f"mu {name}")
            assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
        assert (diff <= 2e-3 + 1e-6).all(), (name, diff.max())
    if backbone.startswith("resnet"):
        # every statistic moved, the frozen stem's and layer1's too
        for n in want_p:
            if n.endswith("running_mean"):
                assert not torch.equal(r["port"][n], r["initial"][n]), n


@pytest.mark.parametrize("backbone", ["resnet18", "dinov2_vits14"])
def test_path_b_equals_path_a(backbone):
    """With align_eps unset, the step through K2's plain version
    (``fuse_align_pf``) gives path A's loss, gradient norm, add-on update
    and BatchNorm statistics on these backbones too (f32, the CPU)."""
    _, tcfg, _, _, mt, tt, _ = _models(backbone, align_eps=None)
    xs = torch.from_numpy(_images(2 * B, SIZES[backbone], 15))
    ys = torch.from_numpy(np.random.default_rng(16).integers(0, tt.num_classes, B))
    noise = torch.from_numpy(np.random.default_rng(17).gumbel(
        size=(tt.num_protos_padded, 2)).astype(np.float32))
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    results = []
    for fuse in (False, True):
        mt.load_state_dict(initial)
        statics, sc = _statics(port_train, port_train, tcfg, "train")
        step = port_train.make_train_step(mt, tt, tcfg, statics, fuse_align_pf=fuse)
        _, m = step(port_train.init_train_state(mt, seed=0), xs[:B], xs[B:], ys,
                    port_train.Scalars(**sc), presence_noise=noise)
        results.append((m, {k: v.clone() for k, v in mt.state_dict().items()}))
    (ma, sa), (mb, sb) = results
    for k in ("loss", "loss/align_pf", "loss/tanh", "grad_norm"):
        assert float(mb[k]) == pytest.approx(float(ma[k]), rel=1e-5), k
    torch.testing.assert_close(sb["head.add_on_kernel"], sa["head.add_on_kernel"],
                               atol=1e-5, rtol=0)
    for k, v in sa.items():
        if "running_" in k:
            torch.testing.assert_close(sb[k], v, atol=1e-6, rtol=0)
