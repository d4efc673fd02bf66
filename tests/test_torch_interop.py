"""Torch checkpoint import and export in the port against the JAX package's.

* ``convert_*`` on synthetic torchvision- and torch.hub-named state dicts
  (seeded values, torchvision's names and shapes, ``num_batches_tracked``
  included) equal, entry for entry and bit for bit, the JAX package's
  ``convert_*`` taken through ``params_from_jax``: ConvNeXt-tiny, ResNet-18,
  a Bottleneck ResNet with the BBN iNaturalist names (``cb_block``,
  ``rb_block``), and a narrow DINOv2;
* ``export_reference_pipnet`` equals the JAX package's export of the same
  weights key for key and bit for bit (ConvNeXt-tiny and ResNet-50 at full
  depth), and ``convert_reference_pipnet`` reads it back to the same
  ``state_dict``;
* the chain that carries a JAX run into the port: the JAX package's
  ``torch_export.run`` on its orbax run directory, then the port's
  ``convert_reference_pipnet``, gives the JAX run's logits (f32, 1e-5 of
  the largest);
* the port's export CLI on a port run directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.models.torch_export as jax_export
import pipnet_tpu.models.torch_import as jax_import
import pipnet_tpu_torch.models.torch_export as port_export
import pipnet_tpu_torch.models.torch_import as port_import
from torch_port_util import MULTI_NEWICK, ZOO_VIT, port_tree, roots_from_newick, to_jax


def _variables(backbone, arch=None, seed=0, use_byol=False):
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models.convert import _arch, _random_variables
    cfg = ModelConfig(backbone=backbone, use_byol=use_byol)
    return _random_variables(cfg, port_tree(MULTI_NEWICK), seed, arch or _arch(cfg))


def _torch_dict(np_dict, batches_tracked=True):
    """numpy entries -> tensors, with torchvision's ``num_batches_tracked``
    beside every BatchNorm."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in np_dict.items()}
    if batches_tracked:
        for k in list(sd):
            if k.endswith(".running_mean"):
                sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    return sd


def _port_state(params, stats=None):
    from pipnet_tpu_torch.models import params_from_jax
    return params_from_jax(params, batch_stats=stats)


def _equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def _hub_dinov2(params):
    """torch.hub ``dinov2_vits14`` names for a flax DinoV2ViT tree."""
    sd = {"patch_embed.proj.weight": params["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
          "patch_embed.proj.bias": params["patch_embed"]["bias"],
          "cls_token": params["cls_token"], "pos_embed": params["pos_embed"],
          "norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"],
          "mask_token": np.zeros((1, params["cls_token"].shape[-1]), np.float32)}
    i = 0
    while f"block{i}" in params:
        b, t = params[f"block{i}"], f"blocks.{i}."
        for src, dst in (("norm1", "norm1"), ("norm2", "norm2")):
            sd[t + dst + ".weight"], sd[t + dst + ".bias"] = b[src]["scale"], b[src]["bias"]
        for src, dst in ((b["attn"]["qkv"], "attn.qkv"), (b["attn"]["proj"], "attn.proj"),
                         (b["mlp_in"], "mlp.fc1"), (b["mlp_out"], "mlp.fc2")):
            sd[t + dst + ".weight"], sd[t + dst + ".bias"] = src["kernel"].T, src["bias"]
        sd[t + "ls1.gamma"], sd[t + "ls2.gamma"] = b["ls1"], b["ls2"]
        i += 1
    return sd


@pytest.mark.parametrize("case", ["convnext_tiny", "resnet18", "bottleneck_inat", "dinov2"])
def test_convert_matches_jax(case):
    """The port's converter and the JAX package's on one torch-named dict."""
    if case == "convnext_tiny":
        v = _variables("convnext_tiny_26")
        sd = _torch_dict(jax_export.export_convnext_tiny(v["params"]["backbone"], prefix=""))
        got = port_import.convert_convnext_tiny(sd)
        want = _port_state({"backbone": jax_import.convert_convnext_tiny(sd),
                            "head": v["params"]["head"]})
    elif case == "resnet18":
        v = _variables("resnet18")
        sd = _torch_dict(jax_export.export_resnet(v["params"]["backbone"],
                                                  v["batch_stats"]["backbone"],
                                                  (2, 2, 2, 2), False, prefix=""))
        got = port_import.convert_backbone("resnet18", sd)
        p, s = jax_import.convert_backbone("resnet18", sd)
        want = _port_state({"backbone": p, "head": v["params"]["head"]}, {"backbone": s})
    elif case == "bottleneck_inat":
        layers = (1, 1, 1, 3)
        v = _variables("resnet50", ("resnet", True, layers))
        tv = _torch_dict(jax_export.export_resnet(v["params"]["backbone"],
                                                  v["batch_stats"]["backbone"],
                                                  layers, True, prefix=""))
        # BBN iNaturalist names: layer4's third block as cb_block, and an
        # rb_block that maps to a layer4.3 no ResNet-50 has
        sd = {k.replace("layer4.2.", "cb_block."): t for k, t in tv.items()}
        sd.update({k.replace("layer4.2.", "rb_block."): t + 1 for k, t in tv.items()
                   if k.startswith("layer4.2.")})
        got = port_import.convert_resnet(sd, layers, True)
        p, s = jax_import.convert_resnet(sd, layers, True)
        want = _port_state({"backbone": p, "head": v["params"]["head"]}, {"backbone": s})
        np.testing.assert_array_equal(got["backbone.layer4_block2.conv1.weight"].numpy(),
                                      tv["layer4.2.conv1.weight"].numpy())
    else:
        v = _variables("dinov2_vits14", ("vit", ZOO_VIT["dim"], ZOO_VIT["depth"], 14,
                                         ZOO_VIT["pretrain_grid"]))
        sd = _torch_dict(_hub_dinov2(v["params"]["backbone"]))
        got = port_import.convert_backbone("dinov2_vits14", sd)
        p, _ = jax_import.convert_backbone("dinov2_vits14", sd)
        want = _port_state({"backbone": p, "head": v["params"]["head"]})
    want = {k: t for k, t in want.items() if k.startswith("backbone.")}
    _equal(got, {k: t.numpy() for k, t in want.items()})


@pytest.mark.parametrize("arch", ["convnext_tiny_26", "resnet50"])
@pytest.mark.parametrize("module_prefix", [False, True], ids=["bare", "module"])
def test_export_equals_jax_and_reads_back(arch, module_prefix, tmp_path):
    """The port's export of a state_dict equals the JAX package's export of
    the same weights key for key and bit for bit (no
    ``num_batches_tracked``), survives ``save_torch`` / ``load_torch_state_dict``,
    and ``convert_reference_pipnet`` gives the state_dict back (padding
    slots of the head as zeros, off-block classifier weights -0.5)."""
    from pipnet_tpu_torch.config import ModelConfig
    from pipnet_tpu_torch.models.convert import _arch, _random_variables
    tree = port_tree(MULTI_NEWICK)
    v = _random_variables(ModelConfig(backbone=arch), tree, 5, _arch(ModelConfig(backbone=arch)))
    want = jax_export.export_reference_pipnet(v["params"], v["batch_stats"], tree, arch,
                                              module_prefix=module_prefix)
    state = _port_state(v["params"], v["batch_stats"])
    got = port_export.export_reference_pipnet(state, tree, arch, module_prefix=module_prefix)
    assert list(got) == list(want)
    _equal(got, want)
    assert not any(k.endswith("num_batches_tracked") for k in got)
    path = str(tmp_path / "net.pth")
    port_export.save_torch(got, path)
    back = port_import.convert_reference_pipnet(port_import.load_torch_state_dict(path), tree, arch)
    assert set(back) == set(state)
    valid = torch.from_numpy(tree.proto_valid)
    block = torch.zeros(tree.num_children_total, tree.num_protos_padded, dtype=torch.bool)
    for ni in range(tree.num_nodes):
        block[tree.node_child_slice(ni), tree.node_proto_slice(ni)] = True
    for k, t in state.items():
        if k == "head.add_on_kernel":
            assert torch.equal(back[k][:, valid], t[:, valid]) and not back[k][:, ~valid].any()
        elif k == "head.proto_presence":
            assert torch.equal(back[k][valid], t[valid])
        elif k == "head.cls_weight":
            assert torch.equal(back[k][block], t[block]) and (back[k][~block] == -0.5).all()
        else:
            assert torch.equal(back[k], t), k


def test_dinov2_export_raises():
    tree = port_tree(MULTI_NEWICK)
    with pytest.raises(ValueError, match="DINOv2"):
        port_export.export_reference_pipnet({}, tree, "dinov2_vits14")


@pytest.fixture(scope="module")
def jax_resnet_run(tmp_path_factory):
    """A JAX package run directory (orbax ``checkpoints/net_trained_last``)
    of a full ResNet-18 PIPNet on seeded weights and statistics, its
    metadata written by the port's RunLog."""
    import dataclasses
    from pipnet_tpu.train.checkpoint import save_checkpoint as jax_save
    from pipnet_tpu.train.optimizer import adam_init
    from pipnet_tpu.train.step import TrainState as JaxState
    from pipnet_tpu_torch.runtime.log import RunLog
    from torch_port_util import flagship_configs
    _, tcfg = flagship_configs(image_size=48)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, backbone="resnet18",
                                                               num_protos_per_child=10))
    from pipnet_tpu_torch.models import build_pipnet, random_jax_variables
    _, rt = roots_from_newick(MULTI_NEWICK)
    _, tt = build_pipnet(rt, tcfg.model, weighted=tcfg.train.loss.weighted_ce, device="cpu")
    v = random_jax_variables(tcfg.model, tt, seed=9)
    run = tmp_path_factory.mktemp("jax_resnet_run")
    log = RunLog(str(run))
    log.save_config(tcfg)
    log.save_classes(list(tt.class_names))
    log.save_tree(rt)
    jax_save(os.path.join(str(run), "checkpoints"), "net_trained_last",
             JaxState(params=to_jax(v["params"]), batch_stats=to_jax(v["batch_stats"]),
                      opt=adam_init(to_jax(v["params"])), rng=jax.random.PRNGKey(0)),
             epoch=4, phase="train")
    return str(run), v


def test_jax_run_carries_into_the_port(jax_resnet_run, tmp_path):
    """JAX ``torch_export.run`` on the orbax run -> ``.pth`` -> the port's
    ``convert_reference_pipnet`` -> the port's model: its logits are the
    JAX run's, and its BatchNorm buffers the run's ``batch_stats``."""
    import json
    from pipnet_tpu.run_io import load_run as jax_load_run
    from pipnet_tpu_torch.models import build_pipnet, state_dict_from_jax
    from pipnet_tpu_torch.run_io import load_run_config
    from pipnet_tpu_torch.tree import Node
    run, v = jax_resnet_run
    out = str(tmp_path / "net.pth")
    assert jax_export.run(["--run_dir", run, "--out", out]) == 0
    sd = port_import.load_torch_state_dict(out)
    bundle = jax_load_run(run)
    cfg = load_run_config(run)
    with open(os.path.join(run, "metadata", "tree.json")) as f:
        root = Node.from_dict(json.load(f))
    with open(os.path.join(run, "metadata", "classes.json")) as f:
        classes = json.load(f)
    mt, tt = build_pipnet(root, cfg.model, weighted=cfg.train.loss.weighted_ce,
                          class_names=classes, device="cpu")
    state = port_import.convert_reference_pipnet(sd, tt, "resnet18")
    mt.load_state_dict(state)
    for k, t in state_dict_from_jax(v).items():
        if "running_" in k:
            assert torch.equal(mt.state_dict()[k], t), k
    xs = np.random.default_rng(3).standard_normal((3, 48, 48, 3)).astype(np.float32)
    variables = {"params": bundle.state.params, "batch_stats": bundle.state.batch_stats}
    want = np.asarray(bundle.model.apply(variables, jnp.asarray(xs), inference=True)["logits"])
    with torch.no_grad():
        got = mt(torch.from_numpy(xs), inference=True)["logits"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    assert np.abs(want).max() > 0


def test_export_cli_on_a_port_run(jax_resnet_run, tmp_path):
    """``python -m pipnet_tpu_torch.models.torch_export`` on a port run
    directory writes the reference checkpoint of its weights, which
    ``convert_reference_pipnet`` reads back into the same model."""
    import shutil
    from pipnet_tpu_torch.models import state_dict_from_jax
    from pipnet_tpu_torch.run_io import load_run
    src, v = jax_resnet_run
    run = str(tmp_path / "port_run")
    shutil.copytree(os.path.join(src, "metadata"), os.path.join(run, "metadata"))
    os.makedirs(os.path.join(run, "checkpoints"))
    torch.save(state_dict_from_jax(v), os.path.join(run, "checkpoints", "net_trained_last.pt"))
    out = str(tmp_path / "net.pth")
    assert port_export.run(["--run_dir", run, "--out", out, "--module_prefix"]) == 0
    sd = port_import.load_torch_state_dict(out)
    assert all(k.startswith("module.") for k in sd)
    bundle = load_run(run, device="cpu")
    back = port_import.convert_reference_pipnet(sd, bundle.tree, "resnet18")
    bundle.model.load_state_dict(back)
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 48, 48, 3))
                          .astype(np.float32))
    with torch.no_grad():
        got = bundle.model(xs, inference=True)["logits"]
        again = load_run(run, device="cpu").model(xs, inference=True)["logits"]
    assert torch.equal(got, again)
