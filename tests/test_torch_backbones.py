"""The port's ResNet and DINOv2 backbones against the JAX package's, on the
same seeded weights (``random_jax_variables``, converted by
``params_from_jax``) and images made with numpy, in f32.

Backbones: ResNet-18 (BasicBlock) at 32^2, a stack of one Bottleneck per
layer under resnet50's name at 32^2, and a narrow DINOv2 (dim 32, depth 2,
4 heads, pretrain grid 5) at 42^2, so its 3x3 grid resizes the position
embedding (``tests/torch_port_util.py::small_zoo``).  One train step per
backbone and phase is ``tests/test_torch_backbone_steps.py``.

Bars: features and logits within 1e-5 of the largest value (f32; the two
BatchNorms normalise with variances computed in another order, Welford's
against E[x^2] - E[x]^2, which moves a normalised value by a few f32 ulps
of the largest); running statistics within 1e-5; in float64 both
backbones, forward and gradients, within 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.optimizer as jax_optimizer
from torch_port_util import (MULTI_NEWICK, ZOO_VIT, flagship_configs, port_tree,
                             roots_from_newick, small_zoo, to_jax)

B = 4
SIZES = {"resnet18": 32, "resnet50": 32, "dinov2_vits14": 42}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), (what, err, np.abs(want).max())


def _configs(backbone, **loss):
    jcfg, tcfg = flagship_configs(image_size=SIZES[backbone], batch_size=B, **loss)
    return tuple(dataclasses.replace(c, model=dataclasses.replace(c.model, backbone=backbone))
                 for c in (jcfg, tcfg))


def _models(backbone, seed=11, **loss):
    """(jax cfg, port cfg, jax model, jax tree, port model, port tree,
    variables) on the multi-bucket tree."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, random_jax_variables, state_dict_from_jax
    jcfg, tcfg = _configs(backbone, **loss)
    rj, rt = roots_from_newick(MULTI_NEWICK)
    with small_zoo():
        mj, tj = jax_build(rj, jcfg.model, weighted=True)
        mt, tt = build_pipnet(rt, tcfg.model, weighted=True, device="cpu")
    variables = random_jax_variables(tcfg.model, tt, seed=seed, backbone=mt.backbone)
    mt.load_state_dict(state_dict_from_jax(variables))
    return jcfg, tcfg, mj, tj, mt, tt, variables


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _jax_vars(variables):
    out = {"params": to_jax(variables["params"])}
    if variables["batch_stats"]:
        out["batch_stats"] = to_jax(variables["batch_stats"])
    return out


# ---------------------------------------------------------------------------
# layout, features, BatchNorm, position embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", sorted(SIZES))
def test_random_variables_have_the_jax_init_layout(backbone):
    """``random_jax_variables`` gives exactly the leaves and shapes of the
    JAX package's ``model.init``, params and batch statistics, and the
    port's model takes them all (``load_state_dict`` is strict)."""
    jcfg, tcfg, mj, _, mt, _, variables = _models(backbone)
    with small_zoo():
        shapes = jax.eval_shape(mj.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZES[backbone], SIZES[backbone], 3)))

    def flat(tree):
        return {jax.tree_util.keystr(p): tuple(np.shape(v))
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(variables["params"]) == flat(shapes["params"])
    assert flat(variables["batch_stats"]) == flat(shapes.get("batch_stats", {}))
    assert bool(variables["batch_stats"]) == backbone.startswith("resnet")


@pytest.mark.parametrize("backbone", sorted(SIZES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_features_match_jax(backbone, train):
    """Backbone features in inference mode (running statistics) and in
    train mode (batch statistics)."""
    _, _, mj, _, mt, _, variables = _models(backbone)
    xs = _images(B, SIZES[backbone], 1)
    with small_zoo():
        want = mj.apply(_jax_vars(variables), jnp.asarray(xs), train=train,
                        mutable=["batch_stats"] if train else False,
                        method=lambda m, x, train: m.features(x, train=train))
    want = want[0] if train else want
    with torch.no_grad():
        got = mt.features(torch.from_numpy(xs), train=train)
    assert got.shape == want.shape and got.is_contiguous()
    _close(got.numpy(), want, what=backbone)


def test_batchnorm_two_train_steps_match_flax():
    """One BatchNorm layer, two train-mode calls: outputs, then the running
    mean and the biased running variance flax keeps (momentum 0.9), in f32
    and with bf16 inputs (statistics in f32, output cast back)."""
    from flax import linen as nn
    from pipnet_tpu_torch.models.resnet import BatchNorm
    r = np.random.default_rng(0)
    C = 8
    xs = [r.standard_normal((4, 5, 5, C)).astype(np.float32) * 2 + 1,
          r.standard_normal((4, 5, 5, C)).astype(np.float32) * 0.5]
    scale, bias = 1 + 0.1 * r.standard_normal(C), 0.1 * r.standard_normal(C)
    for jdt, tdt, bar in ((jnp.float32, torch.float32, 1e-5),
                          (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)):
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
        params = {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)}
        stats = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))["batch_stats"]
        tbn = BatchNorm(C)
        with torch.no_grad():
            tbn.weight.copy_(torch.from_numpy(scale))
            tbn.bias.copy_(torch.from_numpy(bias))
        for x in xs:
            want, upd = bn.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x, jdt), mutable=["batch_stats"])
            stats = upd["batch_stats"]
            got = tbn(torch.from_numpy(x).to(tdt), train=True)
            assert got.dtype == tdt
            _close(got.detach().float().numpy(), np.asarray(want, np.float32), rel=bar)
        np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]),
                                   atol=1e-5, rtol=0)
        assert tbn.running_var.dtype == torch.float32
    # the unbiased variance torch.nn.BatchNorm2d would keep is not it
    n = xs[1].size // C
    assert np.abs(tbn.running_var.numpy() * n / (n - 1) - tbn.running_var.numpy()).max() > 1e-3


def test_frozen_resnet_still_updates_its_statistics():
    """Parameters that take no gradient (a frozen stem) still move their
    BatchNorm statistics in a train forward, and an inference forward moves
    none."""
    _, _, _, _, mt, _, _ = _models("resnet18")
    for p in mt.parameters():
        p.requires_grad_(False)
    before = {k: v.clone() for k, v in mt.backbone.named_buffers()}
    xs = torch.from_numpy(_images(B, 32, 2))
    mt.features(xs, train=False)
    assert all(torch.equal(v, before[k]) for k, v in mt.backbone.named_buffers())
    mt.features(xs, train=True)
    assert all(not torch.equal(v, before[k]) for k, v in mt.backbone.named_buffers())


@pytest.mark.parametrize("backbone", sorted(SIZES))
def test_backbone_gradients_equal_jax_in_float64(backbone):
    """In float64 (both modules built for it) the two backbones are one
    function: train-mode features and the gradients of a random linear
    form of them agree to 1e-10 of their largest value."""
    from pipnet_tpu.models import resnet as jr, vit as jv
    from pipnet_tpu_torch.models import resnet as tr, vit as tv
    _, _, _, _, mt, _, variables = _models(backbone)
    if backbone == "resnet18":
        jm, tm = jr.resnet18_features(jnp.float64), tr.resnet18_features(torch.float64)
    elif backbone == "resnet50":
        jm = jr.ResNetFeatures(block=jr.Bottleneck, layers=(1, 1, 1, 1), dtype=jnp.float64)
        tm = tr.ResNetFeatures(tr.Bottleneck, (1, 1, 1, 1), dtype=torch.float64)
    else:
        jm, tm = jv.DinoV2ViT(dtype=jnp.float64, **ZOO_VIT), tv.DinoV2ViT(dtype=torch.float64,
                                                                             **ZOO_VIT)
    tm.load_state_dict({k[len("backbone."):]: v for k, v in mt.state_dict().items()
                        if k.startswith("backbone.")})
    tm.double()
    xs = _images(B, SIZES[backbone], 4).astype(np.float64)
    f = tm(torch.from_numpy(xs), train=True)
    w = np.random.default_rng(6).standard_normal(tuple(f.shape))
    (f * torch.from_numpy(w)).sum().backward()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["params"]["backbone"])
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["batch_stats"].get("backbone", {}))

        def loss(p):
            v = {"params": p, **({"batch_stats": s64} if s64 else {})}
            out = jm.apply(v, jnp.asarray(xs), train=True,
                           mutable=["batch_stats"] if s64 else False)
            out = out[0] if s64 else out
            return jnp.sum(out * jnp.asarray(w)), out
        (_, fj), g = jax.value_and_grad(loss, has_aux=True)(p64)
        fj = np.asarray(fj)
        from pipnet_tpu_torch.models.convert import _map_backbone
        gj = {}
        _map_backbone("backbone", jax.tree_util.tree_map(np.asarray, g), gj,
                      lambda v, fn: np.asarray(v) if fn is None else fn(np.asarray(v)))
    _close(f.detach().numpy(), fj, rel=1e-10)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), gj[f"backbone.{name}"], rel=1e-10, what=name)


@pytest.mark.parametrize("grid,out", [(37, 16), (37, 3), (37, 40), (5, 3)])
def test_pos_embed_resize_matches_jax_image_resize(grid, out):
    """DINOv2's position embedding resized as ``jax.image.resize(...,
    "bicubic")`` (antialiased Keys cubic, a = -0.5) down (37 -> 16 at 224^2)
    and up."""
    from pipnet_tpu_torch.models.vit import resize_pos_embed
    x = np.random.default_rng(grid + out).standard_normal((1, grid, grid, 24)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, out, out, 24), "bicubic"))
    got = resize_pos_embed(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", sorted(SIZES))
def test_pipnet_logits_match_jax(backbone):
    """PIPNet's pooled and logits (inference thresholding on) on the same
    weights, statistics and images."""
    _, _, mj, _, mt, _, variables = _models(backbone)
    xs = _images(3, SIZES[backbone], 3)
    with small_zoo():
        oj = mj.apply(_jax_vars(variables), jnp.asarray(xs), inference=True)
    with torch.no_grad():
        ot = mt(torch.from_numpy(xs), inference=True)
    for key in ("pooled", "logits"):
        _close(ot[key].numpy(), oj[key], what=key)
    assert (ot["pooled"].numpy() > 0.1).any()


def test_latent_shape_of_every_backbone():
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models import BACKBONES, latent_shape
    import pipnet_tpu.models.pipnet as jp
    from pipnet_tpu.config import ModelConfig as JM
    assert set(BACKBONES) == set(jp.BACKBONES)
    assert {k: v[1] for k, v in BACKBONES.items()} == {k: v[1] for k, v in jp.BACKBONES.items()}
    for name in BACKBONES:
        assert latent_shape(ModelConfig(backbone=name, image_size=224)) == \
            jp.latent_shape(JM(backbone=name, image_size=224))
    assert latent_shape(ModelConfig(backbone="resnet50", image_size=224)) == (28, 28)
    assert latent_shape(ModelConfig(backbone="dinov2_vits14", image_size=224)) == (16, 16)


def test_full_width_backbones_build_at_their_depth():
    """Every name of the table builds its full-width module (no weights
    are run): the depths and widths the card trains."""
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models import BACKBONES
    from pipnet_tpu_torch.models.convert import _arch
    counts = {"resnet18": 11176512, "resnet34": 21284672, "resnet50": 23508032,
              "resnet101": 42500160, "resnet152": 58143808}
    for name, (ctor, channels) in BACKBONES.items():
        m = ctor()
        assert m.out_channels == channels
        assert _arch(ModelConfig(backbone=name), m) == _arch(ModelConfig(backbone=name))
        if name in counts:
            assert sum(p.numel() for p in m.parameters()) == counts[name], name
    vit = BACKBONES["dinov2_vits14"][0]()
    assert (vit.depth, vit.pretrain_grid, vit.pos_embed.shape[1]) == (12, 37, 37 * 37 + 1)


def test_use_pallas_backbone_needs_a_convnext():
    from pipnet_tpu_torch.models import build_pipnet
    _, tcfg = _configs("resnet18")
    cfg = dataclasses.replace(tcfg.model, use_pallas_backbone=True)
    _, rt = roots_from_newick(MULTI_NEWICK)
    with pytest.raises(ValueError, match="ConvNeXt"):
        build_pipnet(rt, cfg, device="cpu")


# ---------------------------------------------------------------------------
# group labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50", "resnet50_inat",
                                      "resnet101", "resnet152", "dinov2_vits14"])
def test_label_params_match_jax(backbone):
    """The port's group of every parameter equals the JAX package's label
    of the same leaf, at full depth (resnet50's stem and layer1 'frozen',
    the others' 'backbone'; the ViT's last block and norm 'train')."""
    from pipnet_tpu.config import ModelConfig as JM
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models import params_from_jax, random_jax_params
    from pipnet_tpu_torch.train import label_params
    tree = port_tree(MULTI_NEWICK)
    cfg = ModelConfig(backbone=backbone, use_byol=True)
    params = random_jax_params(cfg, tree)
    jl = jax_optimizer.label_params(params, JM(backbone=backbone).backbone)
    want = params_from_jax(jl, lambda v, fn: v)
    got = label_params(list(want), backbone)
    assert got == want
    assert got["projector.fc_in.weight"] == got["predictor.bn.weight"] == "train"
    if backbone.startswith("resnet"):
        early = "frozen" if "resnet50" in backbone else "backbone"
        assert got["backbone.conv1.weight"] == got["backbone.layer1_block0.bn1.weight"] == early


# ---------------------------------------------------------------------------
# one train step per backbone and phase
# ---------------------------------------------------------------------------
