"""Shared helpers for the PyTorch port's parity tests.

The same inputs, made from a seed with numpy, go through the JAX package
(the reference) and its counterpart in ``pipnet_tpu_torch``; arrays cross
between the two as numpy.
"""

import contextlib
import functools
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_META = os.path.join(REPO, "artifacts", "lou_190_s2", "metadata")

# a tree whose internal nodes have 2, 3 and 4 children, so per-child budgets
# give several bucket widths
MULTI_NEWICK = (
    "((cub_001_A:1,cub_002_B:1,cub_003_C:1):1,"
    "((cub_004_D:1,cub_005_E:1):1,cub_006_F:1,cub_007_G:1,cub_008_H:1):1,"
    "(cub_009_I:1,cub_010_J:1):1);"
)

# a tree mixing a narrow bucket (two nodes of 3 children) with a node of 30
# children: at 10 prototypes a child, 300 columns starting at column 60 (off
# an 8-column boundary), wider than every head kernel's column tile and
# than K1b's window in both dtypes
MIXED_NEWICK = ("((" + ",".join(f"cub_{i:03d}_W:1" for i in range(1, 31)) + "):1,"
                "(cub_031_A:1,cub_032_B:1,cub_033_C:1):1,cub_034_D:1);")

SMALL_DEPTHS = (1, 1, 2, 1)
SMALL_DIMS = (8, 16, 32, 64)
# stride thresholds that give the small widths the 26 / 13 / 7 surgery
SMALL_THRESHOLDS = {"convnext_tiny_26": 10, "convnext_tiny_13": 20,
                    "convnext_tiny_7": None}


def budget(root, per_child=10, per_desc=0):
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=per_desc,
                            num_protos_per_child=per_child,
                            min_protos=0, split_protos=True)
    return root


def roots_from_newick(newick):
    """(JAX-package root, port root) parsed from the same Newick string."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    out = []
    for mod in (jt, tt):
        root = mod.construct_phylo_tree(phylo=mod.Phylogeny(newick=newick))
        root.assign_all_descendents()
        out.append(root)
    return tuple(out)


def flagship_roots():
    """(JAX-package root, port root, classes) of the flagship 190-class tree."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    with open(os.path.join(FLAGSHIP_META, "tree.json")) as f:
        d = json.load(f)
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        classes = json.load(f)
    return jt.Node.from_dict(d), tt.Node.from_dict(d), classes


def compiled_pair(newick, per_child=10, per_desc=0, protopool=False,
                  weighted=False, class_names=None):
    """The same budgeted tree compiled by both packages."""
    from pipnet_tpu.tree import compile_tree as jax_compile
    from pipnet_tpu_torch.tree import compile_tree as torch_compile
    rj, rt = roots_from_newick(newick)
    kw = dict(class_names=class_names, protopool=protopool, weighted=weighted)
    return (jax_compile(budget(rj, per_child, per_desc), **kw),
            torch_compile(budget(rt, per_child, per_desc), **kw))


def port_tree(newick, per_child=10, per_desc=0):
    """The port's compiled tree of ``newick`` alone, budgeted as ``budget``
    does (no JAX package: the card's host runs this)."""
    import pipnet_tpu_torch.tree as tt
    root = tt.construct_phylo_tree(phylo=tt.Phylogeny(newick=newick))
    root.assign_all_descendents()
    return tt.compile_tree(budget(root, per_child, per_desc), protopool=False)


def flat_classes(n):
    """Generated class names of a flat run (no dataset needed)."""
    return [f"cub_{i:03d}" for i in range(1, n + 1)]


def flat_root(module, num_classes, num_protos):
    """The original flat PIP-Net tree of ``module`` (either package's
    ``tree``): one node of ``num_protos`` prototypes over every class,
    budgeted as ``build_pipnet`` does with ``num_features`` set and no
    per-child budget."""
    root = module.flat_tree(flat_classes(num_classes), num_protos)
    root.set_num_protos(num_protos_per_descendant=0, num_protos_per_child=0,
                        min_protos=num_protos, split_protos=True)
    return root


def flat_pair(num_classes, num_protos):
    """The flat tree compiled by both packages."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    return tuple(mod.compile_tree(flat_root(mod, num_classes, num_protos), protopool=False)
                 for mod in (jt, tt))


def flat_tree_port(num_classes, num_protos):
    """The port's compiled flat tree alone (the card's host has no JAX)."""
    import pipnet_tpu_torch.tree as tt
    return tt.compile_tree(flat_root(tt, num_classes, num_protos), protopool=False)


@contextlib.contextmanager
def small_backbones():
    """Both packages' ``BACKBONES`` tables point at narrow ConvNeXts
    (SMALL_DEPTHS / SMALL_DIMS) with the same stride surgery as the
    full-width names, for the duration of the block.  Stochastic depth is
    off: the two packages' random streams differ."""
    import pipnet_tpu.models.pipnet as jp
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu.models.convnext import ConvNeXtTiny as JaxConvNeXt
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny as TorchConvNeXt
    with pytest.MonkeyPatch.context() as mp:
        for name, thr in SMALL_THRESHOLDS.items():
            for table, ctor in ((jp.BACKBONES, JaxConvNeXt),
                                (tp.BACKBONES, TorchConvNeXt)):
                mp.setitem(table, name, (functools.partial(
                    ctor, stride_threshold=thr, depths=SMALL_DEPTHS,
                    dims=SMALL_DIMS, stochastic_depth_prob=0.0), SMALL_DIMS[-1]))
        yield


# the small backbone zoo of the backbone and BYOL tests: ResNet-18 at full
# width, resnet50's name on a stack of one Bottleneck per layer (so its
# frozen-stem labels apply) and a narrow DINOv2 whose 5x5 pretrain grid
# differs from a 42^2 image's 3x3
ZOO_BOTTLENECK_LAYERS = (1, 1, 1, 1)
ZOO_VIT = dict(dim=32, depth=2, num_heads=4, pretrain_grid=5)


@contextlib.contextmanager
def small_zoo():
    """Both packages' ``BACKBONES`` tables give ``resnet50`` the Bottleneck
    stack ``ZOO_BOTTLENECK_LAYERS`` and ``dinov2_vits14`` the ViT ``ZOO_VIT``
    for the duration of the block (``resnet18`` stays as it is)."""
    import pipnet_tpu.models.pipnet as jp
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu.models import resnet as jr, vit as jv
    from pipnet_tpu_torch.models import resnet as tr, vit as tv
    with pytest.MonkeyPatch.context() as mp:
        for table, r, v in ((jp.BACKBONES, jr, jv), (tp.BACKBONES, tr, tv)):
            mp.setitem(table, "resnet50", (functools.partial(
                r.ResNetFeatures, block=r.Bottleneck, layers=ZOO_BOTTLENECK_LAYERS), 2048))
            mp.setitem(table, "dinov2_vits14", (functools.partial(
                v.DinoV2ViT, **ZOO_VIT), ZOO_VIT["dim"]))
        yield


def flagship_configs(image_size=48, batch_size=4, **loss_overrides):
    """(JAX-package RunConfig, port RunConfig) of the flagship run
    (``artifacts/lou_190_s2``) in f32 at a small image size and batch, with
    ``loss_overrides`` applied to both.  The JAX side runs its XLA head
    composition (``use_pallas_head=False``), so it needs no interpret-mode
    kernel."""
    import dataclasses
    from pipnet_tpu.run_io import load_run_config as jax_load
    from pipnet_tpu_torch.run_io import load_run_config as torch_load
    out = []
    for load in (jax_load, torch_load):
        cfg = load(os.path.dirname(FLAGSHIP_META))
        model = dataclasses.replace(cfg.model, image_size=image_size,
                                    compute_dtype="float32", use_pallas_head=False)
        train = dataclasses.replace(
            cfg.train, batch_size=batch_size,
            loss=dataclasses.replace(cfg.train.loss, **loss_overrides))
        out.append(dataclasses.replace(cfg, model=model, train=train))
    return tuple(out)


def to_jax(tree):
    """Nested dicts of numpy arrays -> nested dicts of jnp arrays."""
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(a, dtype=None):
    import torch
    t = torch.from_numpy(np.asarray(a).copy())
    return t if dtype is None else t.to(dtype)


def jax_geometric_draws(key, batch, size):
    """The draws the JAX package's ``transform1_batch(x, key, ...)`` makes,
    split from ``key`` as it splits them, as the port's ``GeometricDraws``."""
    import jax
    import torch
    from pipnet_tpu.ops import device_geometric as jg
    from pipnet_tpu_torch.ops.device_geometric import GeometricDraws
    r_ta, r_rrc = jax.random.split(key)
    op, mag = jg.sample_geometric(r_ta, batch)
    r_flip, r_box = jax.random.split(r_rrc)
    box = jg.sample_rrc_box(r_box, batch, size)
    flip = jax.random.bernoulli(r_flip, 0.5, (batch,))
    return GeometricDraws(_torch(op, torch.long), _torch(mag),
                          *(_torch(v, torch.long) for v in box), _torch(flip))


def jax_view_draws(key, batch, size, out_size, cars=False):
    """The draws the JAX package's ``two_view_transform2(x, key, out_size)``
    makes on a ``size``^2 batch, as the port's two ``ViewDraws``."""
    import jax
    import torch
    from pipnet_tpu.ops import device_augment as ja
    from pipnet_tpu_torch.ops.device_augment import ViewDraws
    r1, r2, c1, c2 = jax.random.split(key, 4)
    views = []
    for r, c in ((r1, c1), (r2, c2)):
        op, mag = ja.sample_photometric(r, batch, cars)
        ry, rx = jax.random.split(c)
        y, x = (jax.random.randint(k, (batch,), 0, size - out_size + 1) for k in (ry, rx))
        views.append(ViewDraws(_torch(op, torch.long), _torch(mag),
                               _torch(y, torch.long), _torch(x, torch.long)))
    return tuple(views)


def jax_step_augment_draws(state_key, batch, size, image_size, cars=False):
    """The device augmentation draws of the JAX package's train step on a
    uint8 batch (its ``aug_rng`` split from the state's key), as the port's
    ``AugmentDraws``."""
    import jax
    from pipnet_tpu_torch.train import AugmentDraws
    _, _, _, aug = jax.random.split(state_key, 4)
    geometric = None
    if size > image_size + 4:
        aug, geo = jax.random.split(aug)
        geometric = jax_geometric_draws(geo, batch, size)
        size = image_size + 4
    return AugmentDraws(geometric, jax_view_draws(aug, batch, size, image_size, cars))
