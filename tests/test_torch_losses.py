"""The port's loss catalog and ``compute_total_loss`` against the JAX
package's, on the same seeded inputs over the multi-bucket tree (class
weights on, prototypes partitioned among children): each value to 1e-5
and its gradients for every float input within 1e-4 (f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.losses as jax_losses
import pipnet_tpu.losses.catalog as JC
import pipnet_tpu_torch.losses as port_losses
import pipnet_tpu_torch.losses.catalog as TC
from torch_port_util import MULTI_NEWICK, compiled_pair, flagship_configs

B, H, W, D = 4, 3, 3, 16


@pytest.fixture(scope="module")
def case():
    """Both trees and one set of numpy inputs: two views of softmaxed maps
    pf, their pooled maxima, logits through the effective classifier, an
    add-on kernel and presence logits; one label is -1 (an OOD row)."""
    from pipnet_tpu.ops import segment_softmax
    tj, tt = compiled_pair(MULTI_NEWICK, 10, 0, weighted=True)
    r = np.random.default_rng(0)
    P, C, L = tt.num_protos_padded, tt.num_children_total, tt.num_classes
    ys = r.integers(0, L, B)
    z = 2.0 * r.standard_normal((2 * B, H, W, P)).astype(np.float32)
    pf = np.asarray(segment_softmax(jnp.asarray(z), tj))
    w = np.where(tt.child_block_mask > 0, 1.0 + 0.1 * r.standard_normal((C, P)), -0.5)
    w[r.random((C, P)) < 0.2] = 1e-4                 # below the relevance cuts
    w_eff = (np.maximum(w, 0) * tt.child_block_mask).astype(np.float32)
    pooled = pf.max(axis=(1, 2))
    x = dict(pf=pf, pooled=pooled, logits=(pooled @ w_eff.T).astype(np.float32),
             w_eff=w_eff, ys=np.r_[ys, ys], ys_ood=np.r_[ys[:-1], -1, ys[:-1], -1],
             kernel=(0.3 * r.standard_normal((D, P))).astype(np.float32),
             presence_logits=r.standard_normal((P, 2)).astype(np.float32),
             presence=r.uniform(0.05, 0.95, P).astype(np.float32),
             logsum=(-30 + r.standard_normal((B, tt.num_nodes))).astype(np.float32),
             features=np.zeros((2 * B, H, W, D), np.float32))
    return tj, tt, x


# name -> (fn(catalog, tree consts, tree, inputs) -> (total, per_node), inputs
# differentiated)
LOSSES = {
    "align_pf": (lambda C, tc, t, x: C.align_pf_loss(tc, x["pf"], x["ys"]), ["pf"]),
    "align_pf_eps": (lambda C, tc, t, x: C.align_pf_loss(tc, x["pf"], x["ys"], eps=0.01),
                     ["pf"]),
    "align_pf_from_logsum": (lambda C, tc, t, x: C.align_pf_from_logsum(
        tc, x["logsum"], x["ys"], H * W), ["logsum"]),
    "tanh": (lambda C, tc, t, x: C.tanh_loss(tc, x["pooled"], x["ys"], eps=1e-12),
             ["pooled"]),
    "tanh_ood_row": (lambda C, tc, t, x: C.tanh_loss(tc, x["pooled"], x["ys_ood"]),
                     ["pooled"]),
    "tanh_desc": (lambda C, tc, t, x: C.tanh_desc_loss(tc, x["pooled"], x["ys"], x["w_eff"],
                                                       eps=0.01), ["pooled"]),
    "class": (lambda C, tc, t, x: C.classification_loss(tc, x["logits"], x["ys"], 2.0),
              ["logits"]),
    "class_plain": (lambda C, tc, t, x: C.classification_loss(
        tc, x["logits"], x["ys_ood"], 2.0, pipnet_sparsity=False, weighted=False,
        focal_gamma=2.0), ["logits"]),
    "kernel_orth": (lambda C, tc, t, x: C.kernel_orth_loss(t, tc, x["kernel"], x["w_eff"]),
                    ["kernel"]),
    "kernel_orth_cap": (lambda C, tc, t, x: C.kernel_orth_loss(t, tc, x["kernel"],
                                                               x["w_eff"], cap=8.0),
                        ["kernel"]),
    "overspecificity": (lambda C, tc, t, x: _os(C.overspecificity_losses(
        tc, x["pooled"], x["ys"], x["w_eff"], x["presence"], boost=1.1)),
        ["pooled", "presence"]),
    "overspecificity_geometric": (lambda C, tc, t, x: _os(C.overspecificity_losses(
        tc, x["pooled"], x["ys_ood"], x["w_eff"], x["presence"], geometric_mean=True,
        sg_score=False)), ["pooled", "presence"]),
    "min_contrast": (lambda C, tc, t, x: C.min_contrast_loss(tc, x["pooled"], x["ys"],
                                                             x["w_eff"]), ["pooled"]),
    "min_contrast_top2": (lambda C, tc, t, x: C.min_contrast_loss(
        tc, x["pooled"], x["ys_ood"], x["w_eff"], topk=2), ["pooled"]),
}


def _os(d):
    return d["overspecificity"] + d["mask_l1"], d["overspecificity_per_node"]


def _jax_run(fn, tree, x, wrt):
    tc = JC.make_tree_consts(tree)
    xj = {k: jnp.asarray(v) for k, v in x.items()}

    def total(*args):
        t, pn = fn(JC, tc, tree, {**xj, **dict(zip(wrt, args))})
        return t, pn

    (t, pn), g = jax.value_and_grad(total, argnums=tuple(range(len(wrt))), has_aux=True)(
        *[xj[k] for k in wrt])
    return float(t), np.asarray(pn), [np.asarray(a) for a in g]


def _port_run(fn, tree, x, wrt):
    tc = TC.make_tree_consts(tree)
    xt = {k: torch.tensor(v) for k, v in x.items()}
    for k in wrt:
        xt[k].requires_grad_()
    t, pn = fn(TC, tc, tree, xt)
    t.backward()
    return float(t.detach()), pn.detach().numpy(), [
        np.zeros_like(x[k]) if xt[k].grad is None else xt[k].grad.numpy() for k in wrt]


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(case, name):
    tj, tt, x = case
    fn, wrt = LOSSES[name]
    vj, pnj, gj = _jax_run(fn, tj, x, wrt)
    vt, pnt, gt = _port_run(fn, tt, x, wrt)
    assert vt == pytest.approx(vj, rel=1e-5, abs=1e-6), (vt, vj)
    np.testing.assert_allclose(pnt, pnj, rtol=1e-5, atol=1e-6)
    for k, a, b in zip(wrt, gt, gj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5, err_msg=k)
    assert vj != 0.0


def test_kernel_orth_cap_binds(case):
    """The capped case above has nodes on both sides of the cap."""
    _, tt, x = case
    _, pn, _ = _port_run(LOSSES["kernel_orth"][0], tt, x, ["kernel"])
    assert (pn > 8.0).any() and (pn < 8.0).any()


TOTALS = {
    # phase, flagship loss overrides, outputs carry the no-pf head's logsum
    "train": ("train", {}, False),
    "train_ref_eps_no_cap": ("train", dict(align_eps=None, kernel_orth_cap=None,
                                           tanh_eps=None), False),
    "train_logsum": ("train", dict(align_eps=None), True),
    "pretrain": ("pretrain", {}, False),
    "finetune": ("finetune", {}, False),
}


@pytest.mark.parametrize("name", sorted(TOTALS))
def test_compute_total_loss_matches_jax(case, name):
    """The total, every part, and gradients for pf (or logsum), pooled,
    logits, the add-on kernel and the presence logits.  Mask-pruning is on
    outside pretrain; both packages use the Gumbel sample the JAX package
    draws from ``fold_in(rng, 1)``."""
    tj, tt, x = case
    phase, overrides, fused = TOTALS[name]
    jcfg, tcfg = flagship_configs(**overrides)
    pretrain, finetune = phase == "pretrain", phase == "finetune"
    mask = dict(mask_prune_overspecific=not pretrain, mask_prune_start_epoch=0)
    lj = dataclasses.replace(jcfg.train.loss, **mask)
    lt = dataclasses.replace(tcfg.train.loss, **mask)
    w_kw = dict(align_pf=0.25 if pretrain else 5.0, byol=0.5, tanh=5.0 if pretrain else 2.0,
                cl=0.0 if pretrain else 2.0)
    rng = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.gumbel(jax.random.fold_in(rng, 1),
                                         x["presence_logits"].shape, jnp.float32))
    wrt = ["logsum" if fused else "pf", "pooled", "logits", "kernel", "presence_logits"]

    def outputs(v):
        out = {"pooled": v["pooled"], "logits": v["logits"], "features": v["features"]}
        out["align_pf_logsum" if fused else "proto_features"] = v[wrt[0]]
        return out

    def jax_total(*args):
        v = {**{k: jnp.asarray(a) for k, a in x.items()}, **dict(zip(wrt, args))}
        return jax_losses.compute_total_loss(
            JC.make_tree_consts(tj), outputs(v), v["ys"], v["w_eff"], v["kernel"],
            v["presence_logits"], jnp.asarray(2.0), lj, jax_losses.LossWeights(**w_kw),
            tree=tj, pretrain=pretrain, finetune=finetune, rng=rng)

    (vj, auxj), gj = jax.value_and_grad(jax_total, argnums=tuple(range(len(wrt))),
                                        has_aux=True)(*[jnp.asarray(x[k]) for k in wrt])
    v = {k: torch.tensor(a) for k, a in x.items()}
    for k in wrt:
        v[k].requires_grad_()
    vt, auxt = port_losses.compute_total_loss(
        TC.make_tree_consts(tt), outputs(v), v["ys"], v["w_eff"], v["kernel"],
        v["presence_logits"], torch.tensor(2.0), lt, port_losses.LossWeights(**w_kw),
        tree=tt, pretrain=pretrain, finetune=finetune, presence_noise=torch.tensor(noise))
    vt.backward()
    assert set(auxt) == set(auxj)
    for k in auxj:
        np.testing.assert_allclose(auxt[k].detach().numpy(), np.asarray(auxj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    for k, g in zip(wrt, gj):
        got = v[k].grad
        got = np.zeros_like(x[k]) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=1e-4, rtol=1e-5, err_msg=k)
    if not pretrain and not finetune:
        assert "overspecificity" in auxt and "min_contrast" in auxt


def test_resolve_tanh_eps():
    _, tcfg = flagship_configs()
    loss = tcfg.train.loss
    assert port_losses.resolve_tanh_eps(loss, True) == 0.01
    ref = dataclasses.replace(loss, tanh_eps=None)
    assert port_losses.resolve_tanh_eps(ref, True) == 1e-12
    assert port_losses.resolve_tanh_eps(ref, False) == 1e-8


def test_unported_losses_raise(case):
    _, tt, x = case
    _, tcfg = flagship_configs()
    v = {k: torch.tensor(a) for k, a in x.items()}
    out = {"pooled": v["pooled"], "logits": v["logits"], "proto_features": v["pf"]}
    for change in (dict(align=True), dict(ood_loss=True)):
        cfg = dataclasses.replace(tcfg.train.loss, **change)
        with pytest.raises(NotImplementedError):
            port_losses.compute_total_loss(
                TC.make_tree_consts(tt), out, v["ys"], v["w_eff"], v["kernel"],
                v["presence_logits"], torch.tensor(2.0), cfg,
                port_losses.LossWeights(align_pf=5.0, byol=2.0), tree=tt,
                pretrain=False, finetune=False)
