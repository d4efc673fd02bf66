"""OOD training in the port (``--OOD_dataset``) against the JAX package.

- the losses: ``ood_bce_loss`` (the one a total reads), ``ood_entropy_loss``
  and ``entropy_loss`` (catalog functions only, in both packages) on rows
  with label -1: values and per-node values within 1e-5, gradients within
  1e-4;
- ``compute_total_loss`` with OOD rows present: the OOD BCE term at weight
  0.2 outside pretraining and none in it; ``ood_ent`` changes nothing in
  either package;
- one train step on a batch with OOD rows (``StepStatics.has_ood``) from
  the same weights, batch and presence sample: loss, parts and updated
  parameters as in ``tests/test_torch_train_step.py``;
- the Trainer's OOD stream (``_ood_chunks``): fixed-size chunks cycling
  through the OOD loader's epochs, equal to the JAX package's.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.losses as jax_losses
import pipnet_tpu.losses.catalog as JC
import pipnet_tpu_torch.losses as port_losses
import pipnet_tpu_torch.losses.catalog as TC
from torch_port_util import (MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, compiled_pair,
                             flagship_configs, roots_from_newick, small_backbones, to_jax)


@pytest.fixture(scope="module")
def case():
    tj, tt = compiled_pair(MULTI_NEWICK, 10, 0, weighted=True)
    r = np.random.default_rng(0)
    P, C, L = tt.num_protos_padded, tt.num_children_total, tt.num_classes
    ys = np.r_[r.integers(0, L, 5), -1, -1]
    pooled = r.uniform(0.0, 1.0, (2 * len(ys), P)).astype(np.float32)
    w_eff = (np.maximum(np.where(tt.child_block_mask > 0, 1.0 + 0.1 * r.standard_normal(
        (C, P)), -0.5), 0) * tt.child_block_mask).astype(np.float32)
    logits = (pooled @ w_eff.T / 4.0).astype(np.float32)
    return tj, tt, dict(ys=np.r_[ys, ys], logits=logits, pooled=pooled, w_eff=w_eff,
                        probs=r.dirichlet(np.ones(6), 9).astype(np.float32))


CATALOG = {
    "ood_bce": lambda C, tc, x: C.ood_bce_loss(tc, x["logits"], x["ys"], 2.0),
    "ood_entropy": lambda C, tc, x: C.ood_entropy_loss(tc, x["logits"], x["ys"], 2.0),
}


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_ood_loss_matches_jax(case, name):
    tj, tt, x = case
    fn = CATALOG[name]

    def jax_fn(logits):
        return fn(JC, JC.make_tree_consts(tj), {**x, "logits": logits})

    (vj, pnj), gj = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x["logits"]))
    lt = torch.from_numpy(x["logits"]).requires_grad_(True)
    vt, pnt = fn(TC, TC.make_tree_consts(tt), {**x, "ys": torch.from_numpy(x["ys"]),
                                                 "logits": lt})
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    np.testing.assert_allclose(pnt.detach().numpy(), np.asarray(pnj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), atol=1e-4, rtol=0)
    assert float(vj) > 0


def test_entropy_loss_matches_jax(case):
    _, _, x = case
    vj, gj = jax.value_and_grad(JC.entropy_loss)(jnp.asarray(x["probs"]))
    p = torch.from_numpy(x["probs"]).requires_grad_(True)
    vt = TC.entropy_loss(p)
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("phase,ood_ent", [("train", False), ("train", True),
                                           ("pretrain", False), ("finetune", True)])
def test_total_loss_with_ood_rows_matches_jax(case, phase, ood_ent):
    tj, tt, x = case
    jcfg, tcfg = flagship_configs(align_pf=False, ood_loss=True, ood_ent=ood_ent)
    pretrain, finetune = phase == "pretrain", phase == "finetune"
    w = dict(align_pf=5.0, byol=0.5, tanh=5.0 if pretrain else 2.0, cl=0.0 if pretrain else 2.0,
             ood=0.0 if pretrain else 0.2)

    def jfn(logits, pooled):
        out = {"pooled": pooled, "logits": logits}
        return jax_losses.compute_total_loss(
            JC.make_tree_consts(tj), out, jnp.asarray(x["ys"]), jnp.asarray(x["w_eff"]),
            jnp.zeros((4, tt.num_protos_padded)), jnp.zeros((tt.num_protos_padded, 2)),
            jnp.asarray(2.0), jcfg.train.loss, jax_losses.LossWeights(**w), tree=tj,
            pretrain=pretrain, finetune=finetune, ood_present=True)

    (vj, auxj), (glj, gpj) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["logits"]), jnp.asarray(x["pooled"]))
    lt = torch.from_numpy(x["logits"]).requires_grad_(True)
    pt = torch.from_numpy(x["pooled"]).requires_grad_(True)
    vt, auxt = port_losses.compute_total_loss(
        TC.make_tree_consts(tt), {"pooled": pt, "logits": lt}, torch.from_numpy(x["ys"]),
        torch.from_numpy(x["w_eff"]), torch.zeros((4, tt.num_protos_padded)),
        torch.zeros((tt.num_protos_padded, 2)), torch.tensor(2.0), tcfg.train.loss,
        port_losses.LossWeights(**w), tree=tt, pretrain=pretrain, finetune=finetune,
        ood_present=True)
    vt.backward()
    assert set(auxt) == set(auxj)
    assert ("ood_bce" in auxt) == (not pretrain)
    for k in auxj:
        np.testing.assert_allclose(auxt[k].detach().numpy(), np.asarray(auxj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    for got, want in ((lt.grad, glj), (pt.grad, gpj)):
        got = np.zeros(np.shape(want), np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    if ood_ent:      # the flag is read by neither total
        off = dataclasses.replace(tcfg.train.loss, ood_ent=False)
        v_off, _ = port_losses.compute_total_loss(
            TC.make_tree_consts(tt), {"pooled": pt, "logits": lt}, torch.from_numpy(x["ys"]),
            torch.from_numpy(x["w_eff"]), torch.zeros((4, tt.num_protos_padded)),
            torch.zeros((tt.num_protos_padded, 2)), torch.tensor(2.0), off,
            port_losses.LossWeights(**w), tree=tt, pretrain=pretrain, finetune=finetune,
            ood_present=True)
        assert float(v_off.detach()) == float(vt.detach())


# -- one train step with OOD rows --------------------------------------------

B, S = 4, 48


def test_train_step_with_ood_rows_matches_jax():
    """The joint phase's step (mask-prune on) on 3 labelled rows and 1 OOD
    row in two views, ``has_ood`` on in both packages."""
    import pipnet_tpu.train.optimizer as jax_optimizer
    import pipnet_tpu.train.step as jax_step
    import pipnet_tpu_torch.train as port_train
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import (build_pipnet, opt_state_from_jax, params_from_jax,
                                         random_jax_params)
    jcfg, tcfg = flagship_configs(image_size=S, batch_size=B, ood_loss=True)
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_backbones():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    params = random_jax_params(tcfg.model, tt, seed=21, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    r = np.random.default_rng(22)
    xs = r.standard_normal((2, B, S, S, 3)).astype(np.float32)
    ys = np.r_[r.integers(0, tt.num_classes, B - 1), -1]
    sc = dict(net_t=3.0, net_T=100.0, epoch_frac=0.5, align_pf_weight=5.0, tanh_weight=2.0)

    phase = jax_optimizer.phase_for_epoch(20, jcfg.train, pretrain=False)
    statics = jax_step.StepStatics(phase=phase, mask_prune_active=True, has_ood=True,
                                   eta_min_net=5e-6)
    state = jax_step.TrainState(params=to_jax(params), batch_stats={},
                                opt=jax_optimizer.adam_init(to_jax(params)),
                                rng=jax.random.PRNGKey(0))
    _, _, loss_rng, _ = jax.random.split(state.rng, 4)
    noise = np.array(jax.random.gumbel(jax.random.fold_in(loss_rng, 1),
                                         (tt.num_protos_padded, 2), jnp.float32))
    with small_backbones():
        state_j, mj_out = jax.jit(jax_step.make_train_step(mj, tj, jcfg, statics))(
            state, jnp.asarray(xs[0]), jnp.asarray(xs[1]), jnp.asarray(ys),
            jax_step.Scalars.make(**sc))

    tphase = port_train.phase_for_epoch(20, tcfg.train, pretrain=False)
    tstatics = port_train.StepStatics(phase=tphase, mask_prune_active=True, has_ood=True,
                                      eta_min_net=5e-6)
    step = port_train.make_train_step(mt, tt, tcfg, tstatics)
    _, mt_out = step(port_train.init_train_state(mt, seed=0), torch.from_numpy(xs[0]),
                     torch.from_numpy(xs[1]), torch.from_numpy(ys), port_train.Scalars(**sc),
                     presence_noise=torch.from_numpy(noise))
    assert "loss/ood_bce" in mt_out and float(mt_out["loss/ood_bce"]) > 0
    assert set(mt_out) == set(mj_out), set(mt_out) ^ set(mj_out)
    for k, v in mj_out.items():
        v = np.asarray(v)
        got = mt_out[k].numpy()
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5, err_msg=k)
    assert int(mt_out["n_fine"]) == 2 * (B - 1)        # OOD rows count for no accuracy
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params))
    mu = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, state_j.opt)).mu
    for name, p in mt.state_dict().items():
        g = mu[name].numpy() / 0.1
        diff = (p - want[name]).abs().numpy()
        assert (diff[np.abs(g) > 1e-6] <= 1e-6).all(), name
        assert (diff <= 2e-3 + 1e-6).all(), name


# -- the OOD stream ----------------------------------------------------------

class _FakeLoader:
    """Batches of 3 rows (the last of an epoch 2) whose values name their
    epoch and row, with or without a second view."""

    def __init__(self, n=8, two_views=True):
        self.n, self.two_views, self.batch_size = n, two_views, 3

    def epoch(self, ep):
        rows = np.arange(self.n) + 100 * ep
        for i in range(0, self.n, 3):
            x = rows[i:i + 3].astype(np.float32)[:, None]
            yield types.SimpleNamespace(xs1=x, xs2=-x if self.two_views else None,
                                        ys=np.zeros(len(x), np.int64))


@pytest.mark.parametrize("two_views", [True, False])
def test_ood_chunks_cycle_as_jax(two_views):
    from pipnet_tpu.train.trainer import _ood_chunks as jax_chunks
    from pipnet_tpu_torch.train.trainer import _ood_chunks as port_chunks
    loader = _FakeLoader(two_views=two_views)
    got = [c for c, _ in zip(port_chunks(loader, 4, 5), range(6))]
    want = [c for c, _ in zip(jax_chunks(loader, 4, 5), range(6))]
    for (a1, a2), (b1, b2) in zip(got, want):
        np.testing.assert_array_equal(a1, b1)
        assert (a2 is None) == (b2 is None) == (not two_views)
        if two_views:
            np.testing.assert_array_equal(a2, b2)
    flat = np.concatenate([c[0][:, 0] for c in got])
    assert all(len(c[0]) == 5 for c in got)
    # epochs 4, 5, 6, 7 of 8 rows each, in order, restarted with the next epoch
    np.testing.assert_array_equal(flat[:30], np.concatenate(
        [np.arange(8) + 100 * ep for ep in range(4, 8)])[:30])
