"""The head variants in the port against the JAX package's head.

Every head that is not the flagship's (the unit, project and l2 add-ons,
the add-on bias, ``softmax_tau=None``, the spatial, Gumbel and
cosine-multiplied softmaxes, focal pooling) runs the composed operations of
``ops/segment.py`` in the port, as the JAX head runs its XLA path; the
flagship's runs K1 (its plain version here).  On the multi-bucket tree at
small widths, from the same numpy weights and features, f32: the forward's
pf, pooled and logits within 1e-5, and the gradients of a random linear
function of them with respect to the features and every head parameter
within 1e-4 of their largest.  The routing: the port's
``head_supports_fusion`` equals the JAX package's on every combination of
the options, and the head calls K1 exactly where it holds.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MULTI_NEWICK, compiled_pair

B, H, W, D = 2, 3, 4, 12

# name -> HeadConfig changes from the default (conv add-on, tau 1)
VARIANTS = {
    "unit": dict(add_on_type="unit"),
    "unit_bias": dict(add_on_type="unit", add_on_bias=True),
    "project": dict(add_on_type="project"),
    "project_bias": dict(add_on_type="project", add_on_bias=True),
    "l2": dict(add_on_type="l2"),
    "conv_bias": dict(add_on_bias=True),
    "no_softmax": dict(softmax_tau=None),
    "gumbel": dict(softmax_tau=None, gumbel_softmax=True, gumbel_tau=0.5),
    "gumbel_noise": dict(softmax_tau=None, gumbel_softmax=True, gumbel_tau=0.5),
    "spatial": dict(softmax_over_channel=True),
    "cosine": dict(multiply_cs_softmax=True),
    "focal": dict(focal=True),
    "focal_bias_cls": dict(focal=True, classifier_bias=True, softmax_tau=0.5),
    "fused_tau": dict(softmax_tau=0.5),
}


@pytest.fixture(scope="module")
def trees():
    return compiled_pair(MULTI_NEWICK, 2, 3)


def _configs(changes):
    from pipnet_tpu.config import HeadConfig as JaxHead
    from pipnet_tpu_torch.config import HeadConfig
    return JaxHead(**changes), HeadConfig(**changes)


def _params(tree, cfg, seed):
    r = np.random.default_rng(seed)
    P, C = tree.num_protos_padded, tree.num_children_total
    p = {"add_on_kernel": (0.5 * r.standard_normal((D, P))).astype(np.float32),
         "cls_weight": (1.0 + 0.1 * r.standard_normal((C, P))).astype(np.float32),
         "proto_presence": r.standard_normal((P, 2)).astype(np.float32),
         "multiplier": np.full((1,), 2.0, np.float32)}
    if cfg.add_on_bias:
        p["add_on_bias"] = (0.3 * r.standard_normal(P)).astype(np.float32)
    if cfg.classifier_bias:
        p["cls_bias"] = (0.1 * r.standard_normal(C)).astype(np.float32)
    return p


def _jax_head(tree, cfg, params, f, noise_key):
    from pipnet_tpu.models.heads import PrototypeHead
    head = PrototypeHead(tree=tree, cfg=cfg, in_channels=D, use_pallas=False)

    def run(params, f):
        return head.apply({"params": params}, f, gumbel_rng=noise_key)
    return run


def _port_head(tree, cfg, params):
    from pipnet_tpu_torch.models.heads import PrototypeHead
    head = PrototypeHead(tree, cfg, D)
    head.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    return head


def _cotangents(tree, seed):
    r = np.random.default_rng(seed)
    return {"proto_features": r.standard_normal((B, H, W, tree.num_protos_padded)),
            "pooled": r.standard_normal((B, tree.num_protos_padded)),
            "logits": r.standard_normal((B, tree.num_children_total))}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_and_gradients_match_jax(trees, name):
    tj, tt = trees
    jcfg, tcfg = _configs(VARIANTS[name])
    params = _params(tt, tcfg, seed=1)
    f = np.random.default_rng(2).standard_normal((B, H, W, D)).astype(np.float32)
    key = jax.random.PRNGKey(3) if name == "gumbel_noise" else None
    noise = (torch.from_numpy(np.array(jax.random.gumbel(
        key, (B, H, W, tt.num_protos_padded), jnp.float32))) if key is not None else None)
    cot = {k: v.astype(np.float32) for k, v in _cotangents(tt, seed=4).items()}

    run = _jax_head(tj, jcfg, params, f, key)
    out_j = run(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(f))

    def scalar(params, f):
        out = run(params, f)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot)
    g_params_j, g_f_j = jax.grad(scalar, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(f))

    head = _port_head(tt, tcfg, params)
    assert head.fused == (name == "fused_tau")
    ft = torch.from_numpy(f).requires_grad_(True)
    out_t = head(ft, gumbel_noise=noise)
    for k in cot:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    sum((out_t[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    grads = {"features": (ft.grad, g_f_j)}
    for k, p in head.named_parameters():
        grads[k] = (p.grad, g_params_j[k])
    for k, (got, want) in grads.items():
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=k)


def test_gumbel_head_without_noise_is_the_tau1_softmax(trees):
    """No training or serving path hands the Gumbel head a sample (the JAX
    step never passes ``gumbel_rng``): it then computes the plain per-node
    softmax at temperature 1, and ``gumbel_tau`` is not read."""
    _, tt = trees
    _, gumbel = _configs(VARIANTS["gumbel"])
    _, conv = _configs(dict(softmax_tau=1.0, add_on_bias=True))
    params = _params(tt, dataclasses.replace(gumbel, add_on_bias=True), seed=5)
    f = torch.from_numpy(np.random.default_rng(6).standard_normal((B, H, W, D))
                         .astype(np.float32))
    head_g = _port_head(tt, dataclasses.replace(gumbel, add_on_bias=True), params)
    head_c = _port_head(tt, conv, params)
    torch.testing.assert_close(head_g(f)["proto_features"], head_c(f)["proto_features"],
                               atol=0, rtol=0)


FLAGS = dict(add_on_type=("conv", "unit", "project", "l2"), add_on_bias=(False, True),
             softmax_tau=(1.0, None), softmax_over_channel=(False, True),
             multiply_cs_softmax=(False, True), gumbel_softmax=(False, True),
             focal=(False, True))


def test_routing_predicate_equals_jax_on_every_combination(trees, monkeypatch):
    """``head_supports_fusion`` equals the JAX package's (configuration
    only) on all 256 combinations, and the head calls the fused head (K1)
    exactly where it holds."""
    import pipnet_tpu_torch.models.heads as heads
    from pipnet_tpu.ops.pallas_head import head_supports_fusion as jax_predicate
    _, tt = trees
    calls = []
    real = heads.fused_head
    monkeypatch.setattr(heads, "fused_head", lambda *a, **k: calls.append(1) or real(*a, **k))
    f = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 2, 2, D))
                         .astype(np.float32))
    n_fused = 0
    for values in itertools.product(*FLAGS.values()):
        changes = dict(zip(FLAGS, values))
        jcfg, tcfg = _configs(changes)
        want = jax_predicate(jcfg)
        assert heads.head_supports_fusion(tcfg) == want, changes
        head = _port_head(tt, tcfg, _params(tt, tcfg, seed=8))
        calls.clear()
        with torch.no_grad():
            head(f)
        assert len(calls) == int(want), changes
        n_fused += want
    assert n_fused == 1


def test_fuse_align_pf_refuses_a_variant_head(trees):
    """K2 computes the conv add-on's per-node softmax only: a variant head
    asked for it raises."""
    _, tt = trees
    _, tcfg = _configs(VARIANTS["focal"])
    head = _port_head(tt, tcfg, _params(tt, tcfg, seed=9))
    with pytest.raises(ValueError, match="variant"):
        head(torch.zeros((2, H, W, D)), fuse_align_pf=True)


SEGMENT_CASES = [("multi_bucket", False), ("multi_bucket", True), ("flat300", True)]


@pytest.mark.parametrize("tree_name,noise", SEGMENT_CASES)
def test_segment_softmax_noise_matches_jax(tree_name, noise):
    """``segment_softmax`` with and without a Gumbel sample (the JAX package
    draws it from the key the port is handed it from), on a tree with
    several bucket widths and a padded tail and on a node of 300: values
    within 1e-6 and gradients within 1e-5, the padded slots 0."""
    from pipnet_tpu.ops.segment import segment_softmax as jax_softmax
    from pipnet_tpu_torch.ops.segment import segment_softmax
    from torch_port_util import flat_pair
    tj, tt = compiled_pair(MULTI_NEWICK, 2, 3) if tree_name == "multi_bucket" else \
        flat_pair(200, 300)
    r = np.random.default_rng(10)
    x = (2.0 * r.standard_normal((2, 3, 4, tt.num_protos_padded))).astype(np.float32)
    cot = r.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(11) if noise else None
    kw = dict(gumbel_tau=0.5) if noise else dict(tau=0.7)

    def jfn(a):
        return jax_softmax(a, tj, gumbel_rng=key, **kw)
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(cot))
    g = (torch.from_numpy(np.array(jax.random.gumbel(key, x.shape, jnp.float32)))
         if noise else None)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = segment_softmax(xt, tt, noise=g, **kw)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_want), atol=1e-5, rtol=0)
    assert (got.detach().numpy()[..., ~tt.proto_valid] == 0).all()


def test_spatial_softmax_matches_jax():
    from pipnet_tpu.ops.segment import spatial_softmax as jax_spatial
    from pipnet_tpu_torch.ops.segment import spatial_softmax
    x = np.random.default_rng(12).standard_normal((2, 3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(spatial_softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_spatial(jnp.asarray(x))), atol=1e-7, rtol=0)
