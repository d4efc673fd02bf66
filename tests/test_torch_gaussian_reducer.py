"""The Gaussian multiplier (``--basic_cnext_gaussian_multiplier``) and the
stage-4 reducer (``--stage4_reducer_net``) in the port against the JAX
package, on a narrow ConvNeXt at 48^2 in f32, from the same seeded
weights.

- ``gaussian_window`` within 1e-7;
- the model with the multiplier on stages 3 and 4 and a two-layer reducer
  (the head then reads the reducer's width, 16): features, pf, pooled and
  logits within 1e-5;
- one joint-phase train step: loss, parts and updated parameters (the
  multiplied depthwise kernels get no gradient in either package);
- the fused-backbone configuration with the multiplier runs no fused block,
  as the JAX package's does not;
- ``random_jax_params`` gives the JAX package's ``model.init`` layout with
  the reducer, the add-on bias and the classifier bias;
- a run directory of such a model loads through ``load_run`` (what
  ``Predictor``, ``evaluate`` and ``--explain`` read) and gives the JAX
  forward's logits.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, flagship_configs,
                             roots_from_newick, small_backbones, to_jax)

B, S = 3, 48
OPTIONS = dict(gaussian_stages=(3, 4), gaussian_sigma=1.3, gaussian_factor=30.0,
               stage4_reducer=((64, 24, True), (24, 16, False)))


def _cfgs(**model):
    jcfg, tcfg = flagship_configs(image_size=S, batch_size=B)
    return tuple(dataclasses.replace(c, model=dataclasses.replace(c.model, **model))
                 for c in (jcfg, tcfg))


@pytest.fixture(scope="module")
def pair():
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    jcfg, tcfg = _cfgs(**OPTIONS)
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    params = random_jax_params(tcfg.model, tt, seed=31, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    xs = np.random.default_rng(32).standard_normal((2, B, S, S, 3)).astype(np.float32)
    return jcfg, tcfg, mj, tj, mt, tt, params, xs


def test_gaussian_window_matches_jax():
    from pipnet_tpu.models.convnext import gaussian_window as jax_window
    from pipnet_tpu_torch.models.convnext import gaussian_window
    for sigma in (0.5, 1.0, 2.5):
        np.testing.assert_allclose(gaussian_window(7, sigma).numpy(),
                                   np.asarray(jax_window(7, sigma)), atol=1e-7, rtol=0)


def test_forward_matches_jax(pair):
    jcfg, tcfg, mj, tj, mt, tt, params, xs = pair
    assert mt.head.add_on_kernel.shape[0] == 16
    with small_backbones():
        oj = mj.apply({"params": to_jax(params)}, jnp.asarray(xs[0]), inference=True)
    with torch.no_grad():
        ot = mt(torch.from_numpy(xs[0]), inference=True)
    for k in ("features", "proto_features", "pooled", "logits"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert ot["features"].shape[-1] == 16


def test_train_step_matches_jax(pair):
    """The joint phase at epoch 20 (backbone unfrozen, mask-prune on)."""
    import pipnet_tpu.train.optimizer as jax_optimizer
    import pipnet_tpu.train.step as jax_step
    import pipnet_tpu_torch.train as port_train
    from pipnet_tpu_torch.models import opt_state_from_jax, params_from_jax
    jcfg, tcfg, mj, tj, mt, tt, params, xs = pair
    ys = np.random.default_rng(33).integers(0, tt.num_classes, B)
    sc = dict(net_t=3.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=5.0, tanh_weight=2.0)
    phase = jax_optimizer.phase_for_epoch(20, jcfg.train, pretrain=False)
    state = jax_step.TrainState(params=to_jax(params), batch_stats={},
                                opt=jax_optimizer.adam_init(to_jax(params)),
                                rng=jax.random.PRNGKey(0))
    _, _, loss_rng, _ = jax.random.split(state.rng, 4)
    noise = np.array(jax.random.gumbel(jax.random.fold_in(loss_rng, 1),
                                       (tt.num_protos_padded, 2), jnp.float32))
    with small_backbones():
        statics = jax_step.StepStatics(phase=phase, mask_prune_active=True, eta_min_net=5e-6)
        state_j, mj_out = jax.jit(jax_step.make_train_step(mj, tj, jcfg, statics))(
            state, jnp.asarray(xs[0]), jnp.asarray(xs[1]), jnp.asarray(ys),
            jax_step.Scalars.make(**sc))
    initial = {k: v.clone() for k, v in mt.state_dict().items()}
    tphase = port_train.phase_for_epoch(20, tcfg.train, pretrain=False)
    step = port_train.make_train_step(mt, tt, tcfg, port_train.StepStatics(
        phase=tphase, mask_prune_active=True, eta_min_net=5e-6))
    tstate, mt_out = step(port_train.init_train_state(mt, seed=0), torch.from_numpy(xs[0]),
                          torch.from_numpy(xs[1]), torch.from_numpy(ys),
                          port_train.Scalars(**sc), presence_noise=torch.from_numpy(noise))
    grads = {n: p.grad for n, p in tstate.params.items()}
    after = {k: v.clone() for k, v in mt.state_dict().items()}
    mt.load_state_dict(initial)
    assert set(mt_out) == set(mj_out), set(mt_out) ^ set(mj_out)
    for k, v in mj_out.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(mt_out[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(mt_out[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)
    # the multiplied depthwise kernels and their biases feed no gradient
    for stage in (2, 3):
        assert grads[f"backbone.stage{stage}_block0.dwconv.weight"] is None
        assert grads[f"backbone.stage{stage}_block0.dwconv.bias"] is None
    assert grads["reducer.reducer0.weight"] is not None
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params))
    mu = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, state_j.opt)).mu
    for name, p in after.items():
        g = mu[name].numpy() / 0.1
        diff = (p - want[name]).abs().numpy()
        assert (diff[np.abs(g) > 1e-6] <= 1e-6).all(), name
        assert (diff <= 2e-3 + 1e-6).all(), name


def test_fused_backbone_with_the_multiplier_fuses_no_block():
    from pipnet_tpu_torch.models import build_pipnet
    _, tcfg = _cfgs(use_pallas_backbone=True, gaussian_stages=(4,))
    _, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mt, _ = build_pipnet(rt, tcfg.model, device="cpu")
    blocks = [m for n, m in mt.backbone.named_children() if "_block" in n]
    assert blocks and not any(b.fused for b in blocks)
    assert [b.gaussian for b in blocks] == [n.startswith("stage3") for n, _ in
                                            mt.backbone.named_children() if "_block" in n]
    _, plain = _cfgs(use_pallas_backbone=True)
    with small_backbones():
        mt, _ = build_pipnet(rt, plain.model, device="cpu")
    assert all(m.fused for n, m in mt.backbone.named_children() if "_block" in n)


def test_random_params_have_the_jax_init_layout():
    """With the reducer, the add-on bias and the classifier bias."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, random_jax_params
    head = dict(add_on_bias=True, classifier_bias=True)
    jcfg, tcfg = _cfgs(**OPTIONS)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, head=dataclasses.replace(jcfg.model.head, **head)))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, head=dataclasses.replace(tcfg.model.head, **head)))
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, _ = jax_build(rj, jcfg.model)
        shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, S, S, 3)))["params"]
        mt, tt = build_pipnet(rt, tcfg.model, device="cpu")
    ours = random_jax_params(tcfg.model, tt, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(ours) == flat(shapes)
    from pipnet_tpu_torch.models import params_from_jax
    mt.load_state_dict(params_from_jax(ours))       # every leaf has its place


def test_run_dir_serves_with_jax_logits(pair, tmp_path):
    """``load_run`` rebuilds the model from the run's config (multiplier,
    reducer and a focal head with the add-on bias), and its inference
    forward gives the JAX forward's logits on the same images."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import (assign_prototype_budgets, params_from_jax,
                                         random_jax_params)
    from pipnet_tpu_torch.run_io import load_run
    from pipnet_tpu_torch.tree import compile_tree
    jcfg, tcfg = _cfgs(**OPTIONS)
    head = dict(focal=True, add_on_bias=True)
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, head=dataclasses.replace(c.model.head, **head))) for c in (jcfg, tcfg))
    rj, rt = roots_from_newick(MULTI_NEWICK)
    classes = sorted(leaf.name for leaf in rt.leaves())
    (tmp_path / "metadata").mkdir()
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "metadata" / "config.json").write_text(json.dumps(dataclasses.asdict(tcfg)))
    (tmp_path / "metadata" / "classes.json").write_text(json.dumps(classes))
    (tmp_path / "metadata" / "tree.json").write_text(json.dumps(rt.to_dict()))
    assign_prototype_budgets(rt, tcfg.model)
    tt = compile_tree(rt, class_names=classes, protopool=tcfg.model.head.protopool,
                      weighted=tcfg.train.loss.weighted_ce)
    params = random_jax_params(tcfg.model, tt, seed=34, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    torch.save(params_from_jax(params), tmp_path / "checkpoints" / "net_trained_last.pt")
    xs = np.random.default_rng(35).standard_normal((2, S, S, 3)).astype(np.float32)
    with small_backbones():
        bundle = load_run(str(tmp_path), device="cpu")
        mj, _ = jax_build(rj, jcfg.model, weighted=True, class_names=classes)
        oj = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)
    assert not bundle.model.head.fused and bundle.model.cfg.stage4_reducer
    with torch.no_grad():
        ot = bundle.model(torch.from_numpy(xs), inference=True)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), atol=1e-5,
                               rtol=0)
