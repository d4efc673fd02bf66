"""One train step on two gloo ranks of the port against the JAX package's
step on ``data_mesh(2)`` of the host devices (``tests/conftest.py`` forces
eight), from the same parameters (``params_from_jax``), batch and presence
sample: the setup of ``tests/test_torch_train_step.py`` (the flagship's
loss set, a narrow ConvNeXt without stochastic depth, the multi-bucket
tree, 48^2, batch 4 in two views, f32) at its bars."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_util as U
from torch_port_util import (MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, budget,
                             flagship_configs, roots_from_newick, small_backbones, to_jax)

B, S = 4, 48
EPOCH, SCALARS = 20, dict(net_t=3.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=5.0,
                          tanh_weight=2.0)


def _jax_step(jcfg, mj, tj, params, xs1, xs2, ys, n_model=1):
    """The JAX package's step on a data mesh of two host devices (by
    ``n_model`` model devices: ``dp_mp_mesh(2, n_model)``); returns the
    presence sample it drew, its parameters, Adam state and metrics."""
    from pipnet_tpu.runtime.mesh import data_mesh, dp_mp_mesh, state_shardings
    from pipnet_tpu.train.optimizer import adam_init, phase_for_epoch
    from pipnet_tpu.train.step import Scalars, StepStatics, TrainState, make_train_step
    mesh = data_mesh(2) if n_model == 1 else dp_mp_mesh(2, n_model)
    state = TrainState(params=to_jax(params), batch_stats={}, opt=adam_init(to_jax(params)),
                       rng=jax.random.PRNGKey(0))
    _, _, loss_rng, _ = jax.random.split(state.rng, 4)
    noise = np.asarray(jax.random.gumbel(jax.random.fold_in(loss_rng, 1),
                                         (tj.num_protos_padded, 2), jnp.float32))
    state = jax.device_put(state, state_shardings(mesh, state))
    statics = StepStatics(phase=phase_for_epoch(EPOCH, jcfg.train, pretrain=False),
                          mask_prune_active=True, eta_min_net=5e-6)
    bsh = NamedSharding(mesh, P("data"))
    with small_backbones():
        step = jax.jit(make_train_step(mj, tj, jcfg, statics))
        state, metrics = step(state, *(jax.device_put(a, bsh) for a in (xs1, xs2, ys)),
                              Scalars.make(**SCALARS))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return noise, as_np(state.params), as_np(state.opt), as_np(metrics)


def test_two_rank_step_matches_the_jax_mesh_step(tmp_path):
    check_against_jax(tmp_path, world=2, n_model=1)


def check_against_jax(tmp_path, world, n_model, doubled=()):
    """One port step on ``world`` gloo ranks (``n_model`` of them a model
    axis) against the JAX step on ``dp_mp_mesh(2, n_model)``.  ``doubled``:
    the leaves whose gradient the JAX step doubles (a fault of its 2-D
    mesh, ``test_torch_mesh_model_jax.py``): there the JAX first moment is
    held to twice the port's, and the JAX gradient norm to the port's with
    those gradients doubled."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import opt_state_from_jax, params_from_jax, random_jax_params
    jcfg, tcfg = flagship_configs(image_size=S, batch_size=B, align_eps=0.01)
    rj, _ = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(budget(rj, 10), jcfg.model, weighted=True)
    run = dict(name="jax", newick=MULTI_NEWICK, per_child=10, cfg=tcfg,
               backbone=("convnext", 0.0), state_dict=None)
    _, tt = U.build(run)
    params = random_jax_params(tcfg.model, tt, seed=11, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    r = np.random.default_rng(12)
    xs = r.standard_normal((2, B, S, S, 3)).astype(np.float32)
    ys = r.integers(0, tj.num_classes, B)
    noise, jparams, jopt, jmetrics = _jax_step(jcfg, mj, tj, params, xs[0], xs[1], ys, n_model)

    run.update(state_dict=params_from_jax(params),
               steps=[dict(phase=(EPOCH, False, True), scalars=SCALARS, xs1=xs[0],
                           xs2=xs[1], ys=ys, noise=noise)])
    got = U.run_ranks([run], world, tmp_path, n_model=n_model)[0]["jax"]

    # loss, every loss/* and per-node term, accuracy counts, the gradient norm
    metrics = dict(got["metrics"][0])
    if doubled:
        sq = sum(float(((got["mu"][n] / 0.1).astype(np.float64) ** 2).sum()) for n in doubled)
        metrics["grad_norm"] = np.float32(np.sqrt(metrics["grad_norm"] ** 2 + 3.0 * sq))
    U.check_metrics(metrics, jmetrics)
    # gradients as Adam's first moment (mu = 0.1 g after one step), and the
    # updated parameters: within 1e-6 where g is not ~0, else 2 lr
    want_p, want_opt = params_from_jax(jparams), opt_state_from_jax(jopt)
    assert got["count"] == want_opt.count
    for name, want in want_p.items():
        g = want_opt.mu[name].numpy() / 0.1
        scale = 2.0 if name in doubled else 1.0
        np.testing.assert_allclose(scale * got["mu"][name], want_opt.mu[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"mu {name}")
        diff = np.abs(got["weights"][name] - want.numpy())
        big = np.abs(g) > 1e-6
        assert (diff[big] <= 1e-6).all(), (name, diff[big].max())
        assert (diff <= 2e-3 + 1e-6).all(), (name, diff.max())
