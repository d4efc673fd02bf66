"""Export a port run as a reference-named torch state_dict: the inverse of
``torch_import.convert_reference_pipnet``.

Counterpart of the JAX package's ``models/torch_export.py``: a model trained
by the port loads into the original PyTorch code (``pipnet/pipnet.py:73-98``
per-node modules, torchvision backbone names), and
``convert_reference_pipnet(export_reference_pipnet(...))`` gives the model
back.  The keys and values are the JAX package's export of the same
weights: torchvision names without ``num_batches_tracked``, BatchNorm
running statistics as the model holds them.

CLI (it reads the checkpoint on the host; no computation runs)::

    python -m pipnet_tpu_torch.models.torch_export --run_dir runs/x --out net.pth

Not exported (no reference counterpart or no fixed reference naming): BYOL's
heads and target, optimizer state, DINOv2 backbones (the reference loads
those from torch hub, not its checkpoints).
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Tuple

import torch

from ..tree.compile import TreeArrays
from .resnet import RESNET_SPECS

Tensors = Dict[str, torch.Tensor]


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu").clone().contiguous()


def export_convnext_tiny(backbone: Mapping[str, torch.Tensor], prefix: str = "_net.") -> Tensors:
    """The port's ConvNeXt backbone entries (names relative to the
    backbone) -> torchvision ``features.*`` names."""
    p, sd = prefix, {}

    def pair(src: str, dst: str) -> None:
        sd[f"{p}{dst}.weight"] = _t(backbone[f"{src}.weight"])
        sd[f"{p}{dst}.bias"] = _t(backbone[f"{src}.bias"])

    pair("stem_conv", "features.0.0")
    pair("stem_norm", "features.0.1")
    for stage, depth in enumerate((3, 3, 9, 3)):
        feat = 1 + 2 * stage
        if stage > 0:
            pair(f"down{stage}_norm", f"features.{2 * stage}.0")
            pair(f"down{stage}_conv", f"features.{2 * stage}.1")
        for blk in range(depth):
            src, b = f"stage{stage}_block{blk}", f"features.{feat}.{blk}"
            pair(f"{src}.dwconv", f"{b}.block.0")
            sd[f"{p}{b}.block.2.weight"] = _t(backbone[f"{src}.norm_scale"])
            sd[f"{p}{b}.block.2.bias"] = _t(backbone[f"{src}.norm_bias"])
            pair(f"{src}.mlp_in", f"{b}.block.3")
            pair(f"{src}.mlp_out", f"{b}.block.5")
            # torchvision stores layer_scale as (C, 1, 1)
            sd[f"{p}{b}.layer_scale"] = _t(backbone[f"{src}.layer_scale"]).reshape(-1, 1, 1)
    return sd


def _bn_out(sd: Tensors, dst: str, backbone: Mapping[str, torch.Tensor], src: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{dst}.{leaf}"] = _t(backbone[f"{src}.{leaf}"])


def export_resnet(backbone: Mapping[str, torch.Tensor], layers: Tuple[int, ...],
                  bottleneck: bool, prefix: str = "_net.") -> Tensors:
    """The port's ResNet backbone entries (names relative to the backbone,
    BatchNorm buffers included) -> torchvision names."""
    p = prefix
    sd: Tensors = {p + "conv1.weight": _t(backbone["conv1.weight"])}
    _bn_out(sd, p + "bn1", backbone, "bn1")
    n_convs = 3 if bottleneck else 2
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            src, dst = f"layer{li + 1}_block{bi}", f"{p}layer{li + 1}.{bi}"
            for ci in range(1, n_convs + 1):
                sd[f"{dst}.conv{ci}.weight"] = _t(backbone[f"{src}.conv{ci}.weight"])
                _bn_out(sd, f"{dst}.bn{ci}", backbone, f"{src}.bn{ci}")
            if f"{src}.down_conv.weight" in backbone:
                sd[f"{dst}.downsample.0.weight"] = _t(backbone[f"{src}.down_conv.weight"])
                _bn_out(sd, f"{dst}.downsample.1", backbone, f"{src}.down_bn")
    return sd


def export_reference_pipnet(state: Mapping[str, torch.Tensor], tree: TreeArrays, arch: str,
                            module_prefix: bool = False) -> Tensors:
    """The port's ``state_dict`` -> the reference's per-node state_dict.
    ``module_prefix`` gives ``module.*`` names (the reference saves through
    ``nn.DataParallel``, pipnet/pipnet.py:1170); without it the names are
    bare, which ``convert_reference_pipnet`` also reads."""
    mp = "module." if module_prefix else ""
    pref = mp + "_net."
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    if arch.startswith("convnext_tiny"):
        sd = export_convnext_tiny(backbone, pref)
    elif arch in RESNET_SPECS:
        sd = export_resnet(backbone, *RESNET_SPECS[arch], pref)
    else:
        raise ValueError(f"no reference export for backbone {arch!r} (DINOv2 lives on "
                         "torch hub, not in reference checkpoints)")
    add_on, cls_w = state["head.add_on_kernel"], state["head.cls_weight"]
    presence = state["head.proto_presence"]
    for ni, name in enumerate(tree.node_names):
        sl, cs = tree.node_proto_slice(ni), tree.node_child_slice(ni)
        # (D, P_n) -> torch conv1x1 (P_n, D, 1, 1)
        sd[f"{mp}_{name}_add_on.weight"] = _t(add_on[:, sl].t()[:, :, None, None])
        sd[f"{mp}_{name}_classification.weight"] = _t(cls_w[cs, sl])
        sd[f"{mp}_{name}_proto_presence"] = _t(presence[sl])
        if "head.cls_bias" in state:
            sd[f"{mp}_{name}_classification.bias"] = _t(state["head.cls_bias"][cs])
    sd[f"{mp}_multiplier"] = _t(state["head.multiplier"]).reshape(1)
    return sd


def save_torch(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write as a torch ``model_state_dict`` checkpoint (the reference's
    ``torch.save({'model_state_dict': ...})``, main.py:706-714)."""
    torch.save({"model_state_dict": {k: _t(v) for k, v in sd.items()}}, path)


def run(argv=None) -> int:
    p = argparse.ArgumentParser("Export a pipnet_tpu_torch run as a reference torch checkpoint")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default="net_trained_last")
    p.add_argument("--out", required=True)
    p.add_argument("--module_prefix", action="store_true",
                   help="emit DataParallel-style module.* names")
    args = p.parse_args(argv)

    from ..run_io import load_run
    bundle = load_run(args.run_dir, checkpoint=args.checkpoint, device="cpu")
    sd = export_reference_pipnet(bundle.model.state_dict(), bundle.tree,
                                 bundle.cfg.model.backbone, module_prefix=args.module_prefix)
    save_torch(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(run())
