"""The whole port model against the JAX package's ``PIPNet`` (fused head,
inference) on the same seeded parameters and images: pooled, logits and the
joint leaf decode in f32 to 1e-5; and the parameter converter's coverage."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torch_port_util import (SMALL_DEPTHS, SMALL_DIMS, budget, roots_from_newick,
                             small_backbones, to_jax)


def _cfgs(compute_dtype="float32", protopool=False):
    from pipnet_tpu.config import HeadConfig as JH, ModelConfig as JM
    from pipnet_tpu_torch.config import HeadConfig as TH, ModelConfig as TM
    kw = dict(backbone="convnext_tiny_26", image_size=64, num_protos_per_child=10,
              compute_dtype=compute_dtype, use_pallas_head=True, fast_gelu=True)
    return (JM(head=JH(protopool=protopool), **kw),
            TM(head=TH(protopool=protopool), **kw))


@pytest.fixture(scope="module")
def pair(tiny_newick):
    """(jax model, jax tree, port model, port tree, params, images)."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    cj, ct = _cfgs()
    rj, rt = roots_from_newick(tiny_newick)
    with small_backbones():
        mj, tj = jax_build(rj, cj)
        mt, tt = build_pipnet(rt, ct, device="cpu")
    params = random_jax_params(ct, tt, seed=7, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    xs = np.random.default_rng(8).standard_normal((3, 64, 64, 3)).astype(np.float32)
    return mj, tj, mt, tt, params, xs


@pytest.fixture(scope="module")
def outputs(pair):
    mj, tj, mt, tt, params, xs = pair
    with small_backbones():
        oj = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)
    with torch.no_grad():
        ot = mt(torch.from_numpy(xs), inference=True)
    return oj, ot


@pytest.mark.parametrize("key", ["features", "pooled", "logits", "proto_features"])
def test_forward_matches_jax(outputs, key):
    oj, ot = outputs
    np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]), atol=1e-5, rtol=0)


def test_inference_threshold_is_exercised(outputs):
    """The seeded weights put pooled values on both sides of 0.1, so the
    threshold and the classifier both matter in the comparison."""
    _, ot = outputs
    pooled = ot["pooled"].numpy()
    assert (pooled == 0).any() and (pooled > 0.1).any()
    assert np.ptp(ot["logits"].numpy()) > 0.1


@pytest.mark.parametrize("case", ["plain", "leave_out", "degenerate"])
def test_joint_leaf_decode_matches_jax(pair, outputs, case):
    from pipnet_tpu.models.pipnet import joint_leaf_log_distribution as jdec
    from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution as tdec
    _, tj, _, tt, _, _ = pair
    oj, ot = outputs
    kw = {}
    if case == "leave_out":
        kw["leave_out_idx"] = [2]          # cub_003: a direct leaf child
    elif case == "degenerate":
        kw["degenerate_nodes"] = np.arange(tt.num_nodes) % 3 == 0
    want = np.asarray(jdec(oj["logits"], tj, softmax_tau=0.5, **kw))
    got = tdec(ot["logits"], tt, softmax_tau=0.5, **kw).numpy()
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], atol=1e-5, rtol=0)
    if case == "plain":
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_random_params_have_the_jax_init_layout(tiny_newick):
    """``random_jax_params`` gives exactly the tree of leaves and shapes that
    the JAX package's ``model.init`` gives."""
    import jax
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import random_jax_params
    cj, ct = _cfgs()
    rj, rt = roots_from_newick(tiny_newick)
    from pipnet_tpu_torch.tree import compile_tree
    tt = compile_tree(budget(rt, 10), protopool=False)
    with small_backbones():
        mj, _ = jax_build(rj, cj)
        shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))["params"]
    ours = random_jax_params(ct, tt, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    flat_j = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_leaves_with_path(shapes)}
    flat_t = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
              jax.tree_util.tree_leaves_with_path(ours)}
    assert flat_t == flat_j


def test_params_from_jax_maps_every_leaf_once(pair):
    from pipnet_tpu_torch.models import params_from_jax
    _, _, mt, _, params, _ = pair
    state = params_from_jax(params)
    n_leaves = sum(len(m) for m in params["backbone"].values()) + len(params["head"])
    assert len(state) == n_leaves
    assert set(state) == set(mt.state_dict())
    assert sum(v.numel() for v in state.values()) == sum(
        v.size for m in params["backbone"].values() for v in m.values()) + sum(
        v.size for v in params["head"].values())
    # conv kernels are transposed HWIO -> OIHW, dense kernels (in,out) -> (out,in)
    k = params["backbone"]["stem_conv"]["kernel"]
    np.testing.assert_array_equal(state["backbone.stem_conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    w = params["backbone"]["stage0_block0"]["mlp_in_kernel"]
    np.testing.assert_array_equal(state["backbone.stage0_block0.mlp_in.weight"].numpy(), w.T)


@pytest.mark.parametrize("edit", ["unknown_leaf", "missing_leaf", "unknown_module"])
def test_params_from_jax_rejects_unmapped_or_missing(pair, edit):
    import copy
    from pipnet_tpu_torch.models import params_from_jax
    params = copy.deepcopy(pair[4])
    if edit == "unknown_leaf":
        params["head"]["add_on_scale"] = np.zeros(3, np.float32)
    elif edit == "missing_leaf":
        del params["backbone"]["stage2_block1"]["layer_scale"]
    else:
        params["backbone"]["reducer0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        params_from_jax(params)


def test_unported_options_raise(tiny_newick):
    """The options that once raised "not ported" (the head variants, the
    stage-4 reducer, the Gaussian multiplier) build; what still raises is
    what the JAX package refuses too: the multiplier on a backbone that is
    not a ConvNeXt (and BYOL with a reducer, whose EMA target the JAX
    package does not hold)."""
    import dataclasses
    from pipnet_tpu_torch.models import build_pipnet
    _, ct = _cfgs()
    for cfg in (dataclasses.replace(ct, head=dataclasses.replace(ct.head, focal=True)),
                dataclasses.replace(ct, stage4_reducer=((64, 32, True),)),
                dataclasses.replace(ct, gaussian_stages=(3,))):
        _, rt = roots_from_newick(tiny_newick)
        with small_backbones():
            model, _ = build_pipnet(rt, cfg, device="cpu")
        assert model.head.fused == (not cfg.head.focal)
    for cfg, match in ((dataclasses.replace(ct, backbone="resnet18", gaussian_stages=(3,)),
                        "ConvNeXt-only"),
                       (dataclasses.replace(ct, use_byol=True, stage4_reducer=((64, 32, True),)),
                        "reducer")):
        _, rt = roots_from_newick(tiny_newick)
        with pytest.raises(ValueError, match=match):
            build_pipnet(rt, cfg, device="cpu")


def test_build_pipnet_defaults_to_cuda(tiny_newick):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from pipnet_tpu_torch.models import build_pipnet
    _, ct = _cfgs()
    _, rt = roots_from_newick(tiny_newick)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipnet(rt, ct)
