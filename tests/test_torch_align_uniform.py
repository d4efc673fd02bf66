"""The CLI's default feature losses (``--align y --uni y``) in the port
against the JAX package's ``losses/catalog.py``.

f32: the alignment and uniformity losses and their combination within
1e-5, their gradients for the features within 1e-4 of the largest.  The
uniformity loss sums over every pair of a view's patch rows by row blocks
(``_UniformPairSum``, whose backward recomputes each block): checked at a
row count that is not a multiple of the block, against autograd of the
unblocked form in float64 (1e-10), and through ``compute_total_loss``.
Two identical views give alignment 0 and finite gradients.  bf16: the
port accumulates the pair sum in f32 where the JAX package carries it in
bf16, so the bf16 loss is held to the exact (float64) value of the same
bf16 inputs, within 1e-3 (each pair's bf16 product x_i . x_j of unit rows
is rounded by up to 2^-8, which moves its exp(-2 d2) by up to ~1.6%; the
roundings have either sign and the mean over the 44,850 pairs of 300 rows
averages them to ~1e-5 measured, so 1e-3 is two decades above it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.losses.catalog as JC
import pipnet_tpu_torch.losses.catalog as TC
from torch_port_util import MULTI_NEWICK, compiled_pair, flagship_configs

V, H, W, D = 4, 5, 6, 16          # 4 images a view: 120 patch rows a view


def _features(seed=0, same_views=False, scale=1.0):
    r = np.random.default_rng(seed)
    f = (scale * r.standard_normal((2 * V, H, W, D))).astype(np.float32)
    if same_views:
        f[V:] = f[:V]
    return f


def _rows(seed=1, n=120):
    x = np.random.default_rng(seed).standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n,block", [(120, 32), (120, 2048), (97, 16), (64, 64)])
def test_uniform_loss_matches_jax(n, block):
    """A ragged last block (120 rows in blocks of 32, 97 in 16), one block,
    and blocks that tile the rows exactly."""
    x = _rows(n=n)
    vj, gj = jax.value_and_grad(lambda a: JC.uniform_loss(a, block=block))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    vt = TC.uniform_loss(xt, block=block)
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    g = np.asarray(gj)
    np.testing.assert_allclose(xt.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0)


def test_blocked_backward_equals_autograd_of_the_unblocked_form():
    """float64: the blocked sum with its recomputing backward against
    autograd through the whole (n, n) distance matrix."""
    x0 = torch.from_numpy(_rows(seed=2, n=150)).double()
    x = x0.clone().requires_grad_(True)
    TC.uniform_loss(x, block=40).backward()
    y = x0.clone().requires_grad_(True)
    sq = (y ** 2).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2 * y @ y.T).clamp(min=0)
    iu = torch.triu_indices(150, 150, 1)
    want = torch.log(torch.exp(-2 * d2[iu[0], iu[1]]).mean() + 1e-10)
    want.backward()
    assert float(TC.uniform_loss(x0, block=40)) == pytest.approx(float(want.detach()), abs=1e-12)
    torch.testing.assert_close(x.grad, y.grad, atol=1e-10, rtol=0)


@pytest.mark.parametrize("parts,block", [(2, 16), (4, 2048), (3, 7)])
def test_rank_shares_of_the_pair_sum_add_up(parts, block):
    """float64: a mesh rank's share of the pair sum (``_UniformRowPairs``,
    its rows against every row) over ``parts`` rows blocks adds up to the
    whole pair sum, and each share's gradient is the whole sum's for its
    rows (1e-12)."""
    x0 = torch.from_numpy(_rows(seed=7, n=96)).double()
    x = x0.clone().requires_grad_(True)
    whole = TC._UniformPairSum.apply(x, 2.0, 40)
    whole.backward()
    shares, grads, b = [], [], 96 // parts
    for r in range(parts):
        xr = x0[r * b:(r + 1) * b].clone().requires_grad_(True)
        share = TC._UniformRowPairs.apply(xr, x0, r * b, 2.0, block)
        share.backward()
        shares.append(float(share.detach()))
        grads.append(xr.grad)
    assert sum(shares) == pytest.approx(float(whole.detach()), rel=1e-12)
    torch.testing.assert_close(torch.cat(grads), x.grad, atol=1e-12, rtol=0)


def test_align_loss_matches_jax():
    x, y = _rows(seed=3), _rows(seed=4)
    vj, (gx, gy) = jax.value_and_grad(JC.align_loss_unit_space, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    vt = TC.align_loss_unit_space(xt, yt)
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    for got, want in ((xt.grad, gx), (yt.grad, gy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("align,uni,same", [(True, True, False), (True, False, False),
                                            (True, True, True)])
def test_align_and_uniform_matches_jax(align, uni, same):
    """Both views' flattened, l2-normalised patches: the two losses and the
    features' gradient of their sum.  With identical views the alignment is
    exactly 0 and every gradient finite (the sum of squares, not the norm)."""
    f = _features(seed=5, same_views=same, scale=3.0)

    def jax_sum(a):
        al, un = JC.align_and_uniform(a, align=align, uni=uni)
        return al + un, (al, un)

    (_, (aj, uj)), gj = jax.value_and_grad(jax_sum, has_aux=True)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    at, ut = TC.align_and_uniform(ft, align=align, uni=uni)
    (at + ut).backward()
    assert float(at.detach()) == pytest.approx(float(aj), rel=1e-5, abs=1e-12)
    assert float(ut.detach()) == pytest.approx(float(uj), rel=1e-5, abs=1e-12)
    g = np.asarray(gj)
    assert np.isfinite(ft.grad.numpy()).all() and np.isfinite(g).all()
    np.testing.assert_allclose(ft.grad.numpy(), g, atol=1e-4 * max(np.abs(g).max(), 1e-6),
                               rtol=0)
    if same:
        assert float(at.detach()) == 0.0


def test_l2_normalize_and_flatten_match_jax():
    f = _features(seed=6)
    f[0, 0, 0] = 0.0                               # a zero row: the eps floor
    np.testing.assert_allclose(
        TC.l2_normalize(TC.flatten_patches(torch.from_numpy(f))).numpy(),
        np.asarray(JC.l2_normalize(JC.flatten_patches(jnp.asarray(f)))), atol=1e-7, rtol=0)


def test_bf16_uniform_loss_within_its_bar_of_the_exact_value():
    """The port's bf16 loss (products in bf16, pair sum in f32) against the
    float64 value of the same bf16-rounded rows, and its gradient finite."""
    x = torch.from_numpy(_rows(seed=7, n=300)).bfloat16().requires_grad_(True)
    v = TC.uniform_loss(x, block=64)
    v.backward()
    x64 = x.detach().double()
    sq = (x64 ** 2).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2 * x64 @ x64.T).clamp(min=0)
    iu = torch.triu_indices(300, 300, 1)
    exact = torch.log(torch.exp(-2 * d2[iu[0], iu[1]]).mean() + 1e-10)
    assert v.dtype == torch.float32
    assert abs(float(v.detach()) - float(exact)) < 1e-3
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()


@pytest.mark.parametrize("phase", ["pretrain", "train"])
def test_total_loss_with_align_and_uni_matches_jax(phase):
    """``compute_total_loss`` with the CLI's defaults ``align`` and ``uni``
    on (weights 0.5 and 3.0): the total, its parts, and the features'
    gradient; ``uni`` without ``align`` raises in both packages."""
    from pipnet_tpu.losses import LossWeights as JW, compute_total_loss as jax_total
    from pipnet_tpu_torch.losses import LossWeights as TW, compute_total_loss as port_total
    tj, tt = compiled_pair(MULTI_NEWICK, 10, 0, weighted=True)
    jcfg, tcfg = flagship_configs(align=True, uni=True)
    pretrain = phase == "pretrain"
    r = np.random.default_rng(8)
    P, C = tt.num_protos_padded, tt.num_children_total
    f = _features(seed=9, scale=2.0)
    pf = r.uniform(0.0, 0.3, (2 * V, H, W, P)).astype(np.float32)
    pooled = pf.max(axis=(1, 2))
    w_eff = (np.maximum(np.where(tt.child_block_mask > 0, 1.0, -0.5), 0)
             * tt.child_block_mask).astype(np.float32)
    logits = (pooled @ w_eff.T).astype(np.float32)
    ys = np.tile(r.integers(0, tt.num_classes, V), 2)
    kernel = (0.3 * r.standard_normal((D, P))).astype(np.float32)
    presence = r.standard_normal((P, 2)).astype(np.float32)
    w = dict(align_pf=0.25 if pretrain else 5.0, byol=0.5, tanh=5.0 if pretrain else 2.0,
             cl=0.0 if pretrain else 2.0)

    def jfn(fj):
        out = {"features": fj, "proto_features": jnp.asarray(pf), "pooled": jnp.asarray(pooled),
               "logits": jnp.asarray(logits)}
        return jax_total(JC.make_tree_consts(tj), out, jnp.asarray(ys), jnp.asarray(w_eff),
                         jnp.asarray(kernel), jnp.asarray(presence), jnp.asarray(2.0),
                         jcfg.train.loss, JW(**w), tree=tj, pretrain=pretrain,
                         finetune=False)

    (vj, auxj), gj = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    out = {"features": ft, "proto_features": torch.from_numpy(pf),
           "pooled": torch.from_numpy(pooled), "logits": torch.from_numpy(logits)}
    vt, auxt = port_total(TC.make_tree_consts(tt), out, torch.from_numpy(ys),
                          torch.from_numpy(w_eff), torch.from_numpy(kernel),
                          torch.from_numpy(presence), torch.tensor(2.0), tcfg.train.loss,
                          TW(**w), tree=tt, pretrain=pretrain, finetune=False)
    vt.backward()
    assert {"align", "uniform"} <= set(auxt) and set(auxt) == set(auxj)
    for k in auxj:
        np.testing.assert_allclose(auxt[k].detach().numpy(), np.asarray(auxj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    g = np.asarray(gj)
    np.testing.assert_allclose(ft.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0)
    bad = dataclasses.replace(tcfg.train.loss, align=False, uni=True)
    jbad = dataclasses.replace(jcfg.train.loss, align=False, uni=True)
    with pytest.raises(ValueError, match="together"):
        port_total(TC.make_tree_consts(tt), out, torch.from_numpy(ys),
                   torch.from_numpy(w_eff), torch.from_numpy(kernel),
                   torch.from_numpy(presence), torch.tensor(2.0), bad, TW(**w), tree=tt,
                   pretrain=pretrain, finetune=False)
    with pytest.raises(ValueError, match="together"):
        jax_total(JC.make_tree_consts(tj), {k: jnp.asarray(v.detach().numpy())
                                            for k, v in out.items()},
                  jnp.asarray(ys), jnp.asarray(w_eff), jnp.asarray(kernel),
                  jnp.asarray(presence), jnp.asarray(2.0), jbad, JW(**w), tree=tj,
                  pretrain=pretrain, finetune=False)
