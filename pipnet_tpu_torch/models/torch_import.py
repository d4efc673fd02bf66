"""Torch checkpoints -> the port's ``state_dict``.

Counterpart of the JAX package's ``models/torch_import.py``.  The reference
initialises backbones from torchvision ImageNet weights
(``features/resnet_features.py:231-327``, ``features/convnext_features.py:18-42``)
and loads full-model and backbone-only torch checkpoints
(``main.py:289-388``).  This module maps those state dicts onto the port's
names:

* torchvision ``convnext_tiny`` ``features.<i>...`` keys -> ``ConvNeXtTiny``;
* torchvision ``resnet{18,34,50,101,152}`` keys -> ``ResNetFeatures``, the
  BatchNorm running statistics included (the BBN iNaturalist remap
  ``cb_block``/``rb_block`` -> ``layer4.2``/``layer4.3``, ref
  features/resnet_features.py:281-297);
* torch.hub ``dinov2_vits14`` keys -> ``DinoV2ViT``;
* reference PIPNet full checkpoints (``module._net.*``,
  ``module._<node>_add_on.*``, ``module._<node>_classification.*``) -> the
  stacked head.

Every function returns ``state_dict`` entries of the port's ``PIPNet``
(``backbone.*``, ``head.*``): float32 CPU tensors for
``model.load_state_dict``.  torch layouts are the port's (conv OIHW, linear
(out, in)), so only names change, and shapes where the port stores a
vector (ConvNeXt's layer scale) or a stacked head.  The running variance
is taken as the checkpoint holds it, as the JAX package takes it into
``batch_stats['var']``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from ..tree.compile import TreeArrays
from .resnet import RESNET_SPECS

Tensors = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone().contiguous()


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """The state dict in a torch checkpoint file: its ``model_state_dict``
    or ``state_dict`` entry when it has one (the reference's
    ``torch.save({'model_state_dict': ...})``), else the file's dict.  Read
    with ``weights_only=True``: tensors, numbers, strings and containers."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            return ckpt[key]
    return ckpt


def convert_convnext_tiny(sd: Mapping[str, Any], prefix: str = "") -> Tensors:
    """torchvision ``convnext_tiny`` ``features.*`` -> ``backbone.*``."""
    p, out = prefix, {}

    def pair(dst: str, src: str) -> None:
        out[f"backbone.{dst}.weight"] = _t(sd[f"{p}{src}.weight"])
        out[f"backbone.{dst}.bias"] = _t(sd[f"{p}{src}.bias"])

    pair("stem_conv", "features.0.0")
    pair("stem_norm", "features.0.1")
    for stage, depth in enumerate((3, 3, 9, 3)):
        feat = 1 + 2 * stage                   # blocks at features.1/3/5/7
        if stage > 0:
            pair(f"down{stage}_norm", f"features.{2 * stage}.0")
            pair(f"down{stage}_conv", f"features.{2 * stage}.1")
        for blk in range(depth):
            # torchvision CNBlock: 0 = dwconv, 2 = LayerNorm, 3 / 5 = Linear
            b, dst = f"features.{feat}.{blk}", f"stage{stage}_block{blk}"
            pair(f"{dst}.dwconv", f"{b}.block.0")
            out[f"backbone.{dst}.norm_scale"] = _t(sd[f"{p}{b}.block.2.weight"])
            out[f"backbone.{dst}.norm_bias"] = _t(sd[f"{p}{b}.block.2.bias"])
            pair(f"{dst}.mlp_in", f"{b}.block.3")
            pair(f"{dst}.mlp_out", f"{b}.block.5")
            out[f"backbone.{dst}.layer_scale"] = _t(sd[f"{p}{b}.layer_scale"]).reshape(-1)
    return out


def _bn(sd: Mapping[str, Any], src: str, dst: str, out: Tensors) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])


def convert_resnet(sd: Mapping[str, Any], layers: Tuple[int, ...], bottleneck: bool,
                   prefix: str = "") -> Tensors:
    """torchvision ResNet keys -> ``backbone.*``, BatchNorm buffers
    included (``num_batches_tracked`` is not kept)."""
    sd = dict(sd)
    # BBN iNaturalist checkpoint remap (ref features/resnet_features.py:281-297)
    for k in list(sd):
        if "cb_block" in k or "rb_block" in k:
            sd[k.replace("cb_block", "layer4.2").replace("rb_block", "layer4.3")] = sd[k]
    p = prefix
    out: Tensors = {"backbone.conv1.weight": _t(sd[p + "conv1.weight"])}
    _bn(sd, p + "bn1", "backbone.bn1", out)
    n_convs = 3 if bottleneck else 2
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            src, dst = f"{p}layer{li + 1}.{bi}", f"backbone.layer{li + 1}_block{bi}"
            for ci in range(1, n_convs + 1):
                out[f"{dst}.conv{ci}.weight"] = _t(sd[f"{src}.conv{ci}.weight"])
                _bn(sd, f"{src}.bn{ci}", f"{dst}.bn{ci}", out)
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.down_conv.weight"] = _t(sd[f"{src}.downsample.0.weight"])
                _bn(sd, f"{src}.downsample.1", f"{dst}.down_bn", out)
    return out


def convert_dinov2_vits14(sd: Mapping[str, Any], prefix: str = "") -> Tensors:
    """torch.hub ``dinov2_vits14`` keys -> ``backbone.*`` (the backbone
    the reference pulls at pipnet/pipnet.py:1125)."""
    p = prefix
    out: Tensors = {"backbone.cls_token": _t(sd[p + "cls_token"]),
                    "backbone.pos_embed": _t(sd[p + "pos_embed"])}
    renames = {"patch_embed.proj": "patch_embed", "norm": "norm"}
    i = 0
    while f"{p}blocks.{i}.norm1.weight" in sd:
        renames.update({f"blocks.{i}.{src}": f"block{i}.{dst}" for src, dst in (
            ("norm1", "norm1"), ("attn.qkv", "attn.qkv"), ("attn.proj", "attn.proj"),
            ("norm2", "norm2"), ("mlp.fc1", "mlp_in"), ("mlp.fc2", "mlp_out"))})
        for ls in ("ls1", "ls2"):
            out[f"backbone.block{i}.{ls}"] = _t(sd[f"{p}blocks.{i}.{ls}.gamma"])
        i += 1
    for src, dst in renames.items():
        for leaf in ("weight", "bias"):
            out[f"backbone.{dst}.{leaf}"] = _t(sd[f"{p}{src}.{leaf}"])
    return out


def convert_backbone(arch: str, sd: Mapping[str, Any], prefix: str = "") -> Tensors:
    """The ``backbone.*`` entries of the named backbone."""
    if arch.startswith("convnext"):
        return convert_convnext_tiny(sd, prefix)
    if arch in RESNET_SPECS:
        return convert_resnet(sd, *RESNET_SPECS[arch], prefix)
    if arch.startswith("dinov2"):
        return convert_dinov2_vits14(sd, prefix)
    raise ValueError(f"unknown backbone arch {arch}")


def convert_reference_pipnet(sd: Mapping[str, Any], tree: TreeArrays, arch: str) -> Tensors:
    """A reference HComP-Net checkpoint (per-node ``_<node>_add_on`` conv
    weights and ``_<node>_classification`` NonNegLinear weights,
    pipnet/pipnet.py:73-98; with or without ``module.``) -> the port's
    whole ``state_dict``: the backbone's entries and the stacked head
    (``add_on_kernel`` (D, P), ``cls_weight`` (C, P) at -0.5 off the
    nodes' blocks, ``proto_presence`` (P, 2), ``multiplier``, ``cls_bias``
    when the checkpoint has classifier biases).  Padding slots hold zeros.
    Add-on biases raise: the port's head has none (ROADMAP item 11)."""
    pref = "module._net." if any(k.startswith("module._net.") for k in sd) else "_net."
    mpre = "module." if pref.startswith("module.") else ""
    out = convert_backbone(arch, sd, pref)
    if f"{mpre}_{tree.node_names[0]}_add_on.bias" in sd:
        raise NotImplementedError("add-on biases are not ported yet (ROADMAP item 11)")
    P, C = tree.num_protos_padded, tree.num_children_total
    add_on = presence = cls_b = None
    cls_w = torch.full((C, P), -0.5)
    for ni, name in enumerate(tree.node_names):
        w = _t(sd[f"{mpre}_{name}_add_on.weight"])[:, :, 0, 0]      # (P_n, D)
        if add_on is None:
            add_on = torch.zeros((w.shape[1], P))
            presence = torch.zeros((P, 2))
        sl, cs = tree.node_proto_slice(ni), tree.node_child_slice(ni)
        add_on[:, sl] = w.t()
        cls_w[cs, sl] = _t(sd[f"{mpre}_{name}_classification.weight"])
        bias = f"{mpre}_{name}_classification.bias"
        if bias in sd:
            if cls_b is None:
                cls_b = torch.zeros(C)
            cls_b[cs] = _t(sd[bias])
        pres = f"{mpre}_{name}_proto_presence"
        if pres in sd:
            presence[sl] = _t(sd[pres])
    out.update({"head.add_on_kernel": add_on, "head.cls_weight": cls_w,
                "head.proto_presence": presence,
                "head.multiplier": _t(sd.get(f"{mpre}_multiplier", [2.0])).reshape(1)})
    if cls_b is not None:
        out["head.cls_bias"] = cls_b
    return out
