"""BYOL in the port against the JAX package's: ``PatchMLP`` (train and
inference mode, running statistics), ``byol_tau_schedule``, ``ema_update``,
the regression loss, and one BYOL train step on a narrow ConvNeXt
(``tests/torch_port_util.py::small_backbones``) at 48^2, batch 4 in two
views, f32, in the pretraining and the joint phase (the setup of
``tests/test_train.py::TestBYOL::test_byol_step`` on the flagship's loss set:
the port refuses the align loss that test adds).

Bars as ``tests/test_torch_train_step.py``'s (forward 1e-5, gradients 1e-4
through Adam's first moment, updated parameters 1e-6 where the gradient is
not ~0); the EMA target after the step within 1e-6 (one multiply-add of
values within 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.optimizer as jax_optimizer
import pipnet_tpu.train.step as jax_step
import pipnet_tpu_torch.train as port_train
from torch_port_util import (MULTI_NEWICK, SMALL_DIMS, flagship_configs, roots_from_newick,
                             small_backbones, to_jax)

B, S = 4, 48
PHASES = {"pretrain": (3, True, False, 0.25, 5.0), "train": (20, False, True, 5.0, 2.0)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_patch_mlp_matches_jax():
    """D -> 3072 -> D with BatchNorm and ReLU over every patch: the output
    in train mode twice (batch statistics, running ones updated), then in
    inference mode."""
    from pipnet_tpu.models.byol import PatchMLP as JaxMLP
    from pipnet_tpu_torch.models import PatchMLP
    from pipnet_tpu_torch.models.convert import _PATCH_MLP, _map_module, _map_stats, _tensor
    D = 16
    r = np.random.default_rng(0)
    xs = [r.standard_normal((3, 4, 5, D)).astype(np.float32) for _ in range(3)]
    jm = JaxMLP(D)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(xs[0])))
    v["params"]["bn"]["scale"] = (1 + 0.1 * r.standard_normal(3072)).astype(np.float32)
    tm = PatchMLP(D)
    sd = {}
    _map_module("m", v["params"], _PATCH_MLP, {}, sd, _tensor)
    _map_stats("m", v["batch_stats"], sd, _tensor)
    tm.load_state_dict({k[2:]: t for k, t in sd.items()})
    stats = v["batch_stats"]
    for x, train in zip(xs, (True, True, False)):
        if train:
            want, upd = jm.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
            stats = upd["batch_stats"]
        else:
            want = jm.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x))
        got = tm(torch.from_numpy(x), train=train).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(stats["bn"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(stats["bn"]["var"]),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("step,total", [(0, 100), (37.5, 100), (100, 100), (3, 0), (250, 100)])
@pytest.mark.parametrize("base,top", [(0.9995, 1.0), (0.9, 0.99)])
def test_tau_schedule_matches_jax(step, total, base, top):
    from pipnet_tpu.models.byol import byol_tau_schedule as jax_tau
    from pipnet_tpu_torch.models import byol_tau_schedule
    want = float(jax_tau(jnp.float32(step), jnp.float32(total), base, top))
    assert byol_tau_schedule(step, total, base, top) == pytest.approx(want, abs=1e-7)


def test_ema_update_matches_jax():
    from pipnet_tpu.models.byol import ema_update as jax_ema
    from pipnet_tpu_torch.models import ema_update
    r = np.random.default_rng(2)
    t = {"a": r.standard_normal((3, 4)).astype(np.float32),
         "b": r.standard_normal(5).astype(np.float32)}
    o = {k: r.standard_normal(v.shape).astype(np.float32) for k, v in t.items()}
    want = _np(jax_ema(to_jax(t), to_jax(o), jnp.float32(0.9)))
    target = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    ema_update(target, {k: torch.from_numpy(v) for k, v in o.items()}, 0.9)
    for k in t:
        np.testing.assert_allclose(target[k].numpy(), want[k], atol=1e-6, rtol=0)


def test_regression_loss_matches_jax_and_stops_the_target_gradient():
    from pipnet_tpu.losses.catalog import byol_regression_loss as jax_loss
    from pipnet_tpu_torch.losses.catalog import byol_regression_loss
    r = np.random.default_rng(3)
    on, tg = (r.standard_normal((4, 3, 3, 8)).astype(np.float32) for _ in range(2))
    tg[1, 0, 0] = 0.0                              # a zero patch: the norm's eps
    want, (g_on, g_tg) = jax.value_and_grad(
        lambda a, b: jax_loss(a, b), argnums=(0, 1))(jnp.asarray(on), jnp.asarray(tg))
    o, t = torch.tensor(on, requires_grad=True), torch.tensor(tg, requires_grad=True)
    got = byol_regression_loss(o, t)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(g_on), atol=1e-6, rtol=0)
    assert t.grad is None and not np.asarray(g_tg).any()


def _models():
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, random_jax_variables, state_dict_from_jax
    out = []
    for cfg in flagship_configs(image_size=S, batch_size=B, byol=True, align_eps=0.01):
        out.append(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_byol=True)))
    jcfg, tcfg = out
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    variables = random_jax_variables(tcfg.model, tt, seed=21, backbone=mt.backbone)
    mt.load_state_dict(state_dict_from_jax(variables))
    return jcfg, tcfg, mj, tj, mt, tt, variables


@pytest.fixture(scope="module")
def byol_runs():
    """Per phase: the JAX package's BYOL step and the port's from the same
    weights, target (a copy of the online branch moved off it, so the target
    projection is not the online one) and batch; also each side's target
    projection of the batch before the step."""
    from pipnet_tpu.models.pipnet import PIPNet as JaxPIPNet
    from pipnet_tpu_torch.models import byol_state_from_jax
    jcfg, tcfg, mj, tj, mt, tt, variables = _models()
    r = np.random.default_rng(22)
    params = variables["params"]
    target = {"target_backbone": jax.tree_util.tree_map(
                  lambda a: (a + 0.01 * r.standard_normal(a.shape)).astype(np.float32),
                  params["backbone"]),
              "target_projector": jax.tree_util.tree_map(
                  lambda a: (a + 0.01 * r.standard_normal(a.shape)).astype(np.float32),
                  params["projector"])}
    xs = r.standard_normal((2 * B, S, S, 3)).astype(np.float32)
    ys = r.integers(0, tt.num_classes, B)
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    out = {}
    for name, (epoch, pretrain, mask_prune, apf_w, tanh_w) in PHASES.items():
        sc = dict(net_t=30.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=apf_w,
                  tanh_weight=tanh_w)
        state = jax_step.TrainState(
            params=to_jax(params), batch_stats=to_jax(variables["batch_stats"]),
            opt=jax_optimizer.adam_init(to_jax(params)), rng=jax.random.PRNGKey(0),
            byol=to_jax(target))
        _, _, loss_rng, _ = jax.random.split(state.rng, 4)
        noise = np.asarray(jax.random.gumbel(jax.random.fold_in(loss_rng, 1),
                                             (tj.num_protos_padded, 2), jnp.float32))
        statics = jax_step.StepStatics(
            phase=jax_optimizer.phase_for_epoch(epoch, jcfg.train, pretrain=pretrain),
            mask_prune_active=mask_prune, eta_min_net=5e-6)
        with small_backbones():
            tvars = {"params": {**state.params, "backbone": state.byol["target_backbone"],
                                "projector": state.byol["target_projector"]},
                     "batch_stats": state.batch_stats}
            jproj = np.asarray(mj.apply(tvars, jnp.asarray(xs),
                                        method=JaxPIPNet.byol_target_projection))
            jonline = mj.apply({"params": state.params, "batch_stats": state.batch_stats},
                               jnp.asarray(xs), train=True, with_byol=True,
                               mutable=["batch_stats"])[0]["byol_online"]
            step = jax.jit(jax_step.make_train_step(mj, tj, jcfg, statics))
            new, metrics = step(state, jnp.asarray(xs[:B]), jnp.asarray(xs[B:]),
                                jnp.asarray(ys), jax_step.Scalars.make(**sc))
        mt.load_state_dict(initial)
        pstate = port_train.init_train_state(mt, seed=0)
        pstate.byol = byol_state_from_jax(target)
        tproj = mt.byol_target_projection(torch.from_numpy(xs), pstate.byol)
        with torch.no_grad():
            tonline = mt(torch.from_numpy(xs), train=True, with_byol=True)["byol_online"]
        mt.load_state_dict(initial)
        pstatics = port_train.StepStatics(
            phase=port_train.phase_for_epoch(epoch, tcfg.train, pretrain=pretrain),
            mask_prune_active=mask_prune, eta_min_net=5e-6)
        pstep = port_train.make_train_step(mt, tt, tcfg, pstatics)
        pstate, pmetrics = pstep(pstate, torch.from_numpy(xs[:B]), torch.from_numpy(xs[B:]),
                                 torch.from_numpy(ys), port_train.Scalars(**sc),
                                 presence_noise=torch.tensor(noise))
        out[name] = dict(jax=(jproj, np.asarray(jonline), _np(new), _np(metrics)),
                         port=(tproj.numpy(), tonline.numpy(), pstate, pmetrics,
                               {k: v.clone() for k, v in mt.state_dict().items()}))
    return out


@pytest.mark.parametrize("phase_name", sorted(PHASES))
def test_byol_branches_match_jax(byol_runs, phase_name):
    """The target projection (EMA weights, online running statistics,
    inference mode) and the online predictor output, (2B, H, W, D)."""
    (jproj, jonline, _, _), (tproj, tonline, *_) = byol_runs[phase_name].values()
    assert tproj.shape == jproj.shape and tproj.shape[-1] == SMALL_DIMS[-1]
    np.testing.assert_allclose(tproj, jproj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tonline, jonline, atol=1e-5, rtol=0)


@pytest.mark.parametrize("phase_name", sorted(PHASES))
def test_byol_step_matches_jax(byol_runs, phase_name):
    """loss/byol and every metric, gradients (Adam's first moment), the
    updated parameters and running statistics (the projector's and
    predictor's BatchNorm), and the EMA target after the step."""
    from pipnet_tpu_torch.models import byol_state_from_jax, opt_state_from_jax, params_from_jax
    (_, _, jnew, jmetrics), (_, _, pstate, pmetrics, port_sd) = byol_runs[phase_name].values()
    assert "loss/byol" in pmetrics and np.isfinite(float(pmetrics["loss/byol"]))
    assert set(pmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        got = pmetrics[k].numpy()
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=k)
    want_p = params_from_jax(jnew.params, batch_stats=jnew.batch_stats)
    want_opt = opt_state_from_jax(jnew.opt)
    assert set(want_p) == set(port_sd)
    g = {n: m.numpy() / 0.1 for n, m in want_opt.mu.items()}
    for name, want in want_p.items():
        got = port_sd[name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0, err_msg=name)
            continue
        np.testing.assert_allclose(pstate.opt.mu[name].numpy(), want_opt.mu[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"mu {name}")
        diff = (got - want).abs().numpy()
        assert (diff[np.abs(g[name]) > 1e-6] <= 1e-6).all(), name
        assert (diff <= 2e-3 + 1e-6).all(), name
    # the predictor and projector train (their gradients reach them)
    assert np.abs(g["predictor.fc_out.weight"]).max() > 0
    want_t = byol_state_from_jax(jnew.byol)
    assert set(want_t) == set(pstate.byol)
    for name, want in want_t.items():
        np.testing.assert_allclose(pstate.byol[name].numpy(), want.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
