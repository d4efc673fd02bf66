"""Parameters in the JAX package's layout -> the port's ``state_dict``.

``params_from_jax`` takes the flax ``PIPNet`` parameter tree as nested dicts
of numpy arrays (``{"backbone": {...}, "head": {...}}``, with
``"projector"`` and ``"predictor"`` under BYOL) and, with ``batch_stats``,
the BatchNorm statistics, and returns the port's ``state_dict``.  Module
names are the flax names; only leaves are renamed and re-laid out:

* conv ``kernel`` HWIO -> ``weight`` OIHW; dense ``kernel`` (in, out) ->
  ``weight`` (out, in); ``bias`` as it is;
* norms (LayerNorm, BatchNorm): ``scale``/``bias`` -> ``weight``/``bias``;
  BatchNorm statistics ``mean``/``var`` -> the buffers
  ``running_mean``/``running_var`` (flax's biased variance, which the
  port's ``BatchNorm`` keeps too);
* ConvNeXt blocks: ``dwconv_kernel`` (7,7,1,C) -> ``dwconv.weight``
  (C,1,7,7); ``mlp_{in,out}_kernel`` -> ``mlp_{in,out}.weight``; the
  biases, ``norm_scale``, ``norm_bias`` and ``layer_scale`` as they are;
* DINOv2: ``cls_token``, ``pos_embed`` and the blocks' ``ls1``/``ls2`` as
  they are;
* ``head``: ``add_on_kernel`` (D,P), ``cls_weight`` (C,P), ``proto_presence``
  (P,2), ``multiplier``, and ``add_on_bias`` and ``cls_bias`` when present,
  as they are;
* the stage-4 reducer: ``reducer/reducer{i}`` dense layers -> ``reducer.reducer{i}``.

Any leaf it cannot map, and any leaf a module needs but lacks, raises.
``opt_state_from_jax`` maps the JAX package's Adam state (moments laid out
as the parameters, one step count per leaf) onto the port's names, and
``byol_state_from_jax`` BYOL's EMA target, so a run can continue in the
port mid-way.  ``random_jax_variables`` makes seeded weights (and BatchNorm
statistics) in that same layout for every backbone, from numpy alone, for
runs that need a model without a trained checkpoint.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..tree.compile import TreeArrays
from .convnext import CONVNEXT_TINY_DEPTHS, CONVNEXT_TINY_DIMS

_CONV = {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
         "bias": ("bias", None)}
_DENSE = {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)}
_NORM = {"scale": ("weight", None), "bias": ("bias", None)}
_BLOCK = {"dwconv_kernel": ("dwconv.weight", lambda a: a.transpose(3, 2, 0, 1)),
          "dwconv_bias": ("dwconv.bias", None),
          "norm_scale": ("norm_scale", None),
          "norm_bias": ("norm_bias", None),
          "mlp_in_kernel": ("mlp_in.weight", lambda a: a.T),
          "mlp_in_bias": ("mlp_in.bias", None),
          "mlp_out_kernel": ("mlp_out.weight", lambda a: a.T),
          "mlp_out_bias": ("mlp_out.bias", None),
          "layer_scale": ("layer_scale", None)}
# a ResNet block: a table value that is a dict is a submodule of that name
_RES_CONV = {"kernel": _CONV["kernel"]}
_RES_BLOCK = {"conv1": _RES_CONV, "bn1": _NORM, "conv2": _RES_CONV, "bn2": _NORM}
_RES_BLOCK_OPTIONAL = {"conv3": _RES_CONV, "bn3": _NORM, "down_conv": _RES_CONV,
                       "down_bn": _NORM}
_VIT_BLOCK = {"norm1": _NORM, "attn": {"qkv": _DENSE, "proj": _DENSE},
              "ls1": ("ls1", None), "norm2": _NORM, "mlp_in": _DENSE,
              "mlp_out": _DENSE, "ls2": ("ls2", None)}
_PATCH_MLP = {"fc_in": _DENSE, "bn": _NORM, "fc_out": _DENSE}
_HEAD = {name: (name, None) for name in
         ("add_on_kernel", "cls_weight", "proto_presence", "multiplier")}
_HEAD_OPTIONAL = {"cls_bias": ("cls_bias", None), "add_on_bias": ("add_on_bias", None)}
_STATS = {"mean": ("running_mean", None), "var": ("running_var", None)}

# each backbone family: (pattern of its block modules, the modules it needs)
_FAMILIES = ((r"stage\d+_block\d+", ("stem_conv", "stem_norm")),
             (r"layer\d+_block\d+", ("conv1", "bn1")),
             (r"block\d+", ("patch_embed", "cls_token", "pos_embed", "norm")))


# parameters the backbone holds itself (DINOv2's), mapped as they are
_BACKBONE_LEAVES = ("cls_token", "pos_embed")


def _backbone_rule(module: str):
    """(required, optional) tables of backbone module ``module``, or None."""
    for pattern, rule in (
            (r"stem_conv|down\d+_conv|patch_embed", (_CONV, {})),
            (r"stem_norm|down\d+_norm|bn1|norm", (_NORM, {})),
            (r"stage\d+_block\d+", (_BLOCK, {})),
            (r"conv1", (_RES_CONV, {})),
            (r"layer\d+_block\d+", (_RES_BLOCK, _RES_BLOCK_OPTIONAL)),
            (r"block\d+", (_VIT_BLOCK, {}))):
        if re.fullmatch(pattern, module):
            return rule
    return None


def _tensor(value, fn) -> torch.Tensor:
    arr = np.asarray(value, np.float32)
    if fn is not None:
        arr = fn(arr)
    return torch.from_numpy(np.array(arr, order="C"))


def _map_module(prefix: str, leaves: Mapping, required: Dict, optional: Dict,
                out: Dict, leaf: Callable) -> None:
    if not isinstance(leaves, Mapping):
        raise ValueError(f"{prefix}: expected a dict of parameters")
    unknown = sorted(set(leaves) - set(required) - set(optional))
    if unknown:
        raise KeyError(f"unmapped parameters {[f'{prefix}/{k}' for k in unknown]}")
    missing = sorted(set(required) - set(leaves))
    if missing:
        raise KeyError(f"missing parameters {[f'{prefix}/{k}' for k in missing]}")
    for key, value in leaves.items():
        rule = {**required, **optional}[key]
        if isinstance(rule, dict):
            _map_module(f"{prefix}/{key}", value, rule, {}, out, leaf)
        else:
            name, fn = rule
            out[f"{prefix.replace('/', '.')}.{name}"] = leaf(value, fn)


def _map_backbone(prefix: str, backbone: Mapping, out: Dict, leaf: Callable) -> None:
    for module, leaves in backbone.items():
        if module in _BACKBONE_LEAVES:
            out[f"{prefix}.{module}"] = leaf(leaves, None)
            continue
        rule = _backbone_rule(module)
        if rule is None:
            raise KeyError(f"unmapped backbone module {prefix}/{module}")
        _map_module(f"{prefix}/{module}", leaves, *rule, out, leaf)
    for pattern, needs in _FAMILIES:
        if any(re.fullmatch(pattern, m) for m in backbone):
            for needed in needs:
                if needed not in backbone:
                    raise KeyError(f"missing backbone module {prefix}/{needed}")


def _map_stats(prefix: str, stats: Mapping, out: Dict, leaf: Callable) -> None:
    """BatchNorm statistics: every dict of ``mean`` and ``var`` is one
    BatchNorm's, at the same path as its parameters."""
    if set(stats) == set(_STATS):
        _map_module(prefix, stats, _STATS, {}, out, leaf)
        return
    for key, value in stats.items():
        if not isinstance(value, Mapping):
            raise KeyError(f"unmapped statistics {prefix}/{key}")
        _map_stats(f"{prefix}/{key}", value, out, leaf)


def params_from_jax(params: Mapping, leaf: Callable = _tensor, *,
                    batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """flax ``PIPNet`` params (nested dicts of arrays) and, for a backbone
    or BYOL heads with BatchNorm, their ``batch_stats`` -> the port's
    ``state_dict`` (float32 tensors on the CPU).  ``leaf(value, layout_fn)``
    makes each entry."""
    unknown = sorted(set(params) - {"backbone", "head", "reducer", "projector", "predictor"})
    if unknown or "backbone" not in params or "head" not in params:
        raise KeyError(f"expected top-level 'backbone' and 'head' (and the stage-4 "
                       f"'reducer', BYOL's 'projector' and 'predictor'), got {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    _map_backbone("backbone", params["backbone"], out, leaf)
    if "reducer" in params:
        layers = params["reducer"]
        if not layers or any(not re.fullmatch(r"reducer\d+", k) for k in layers):
            raise KeyError(f"unmapped reducer layers {sorted(layers)}")
        _map_module("reducer", layers, {k: _DENSE for k in layers}, {}, out, leaf)
    _map_module("head", params["head"], _HEAD, _HEAD_OPTIONAL, out, leaf)
    for mlp in ("projector", "predictor"):
        if mlp in params:
            _map_module(mlp, params[mlp], _PATCH_MLP, {}, out, leaf)
    if batch_stats:
        for top, stats in batch_stats.items():
            if top not in ("backbone", "projector", "predictor"):
                raise KeyError(f"unmapped statistics {top}")
            _map_stats(top, stats, out, leaf)
    return out


def opt_state_from_jax(opt):
    """The JAX package's ``AdamState`` (``mu``, ``nu`` laid out as the params,
    ``count`` one int per leaf) -> the port's ``train.optimizer.AdamState``
    (CPU tensors under the port's parameter names, counts as ints)."""
    from ..train.optimizer import AdamState
    return AdamState(mu=params_from_jax(opt.mu), nu=params_from_jax(opt.nu),
                     count=params_from_jax(opt.count, lambda v, fn: int(np.asarray(v))))


def byol_state_from_jax(byol: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's BYOL target (``{"target_backbone": ...,
    "target_projector": ...}``) -> the port's target dict (``backbone.*``,
    ``projector.*``, as ``models/byol.py::init_byol_state`` makes it)."""
    if set(byol) != {"target_backbone", "target_projector"}:
        raise KeyError(f"expected target_backbone and target_projector, got {sorted(byol)}")
    out: Dict[str, torch.Tensor] = {}
    _map_backbone("backbone", byol["target_backbone"], out, _tensor)
    _map_module("projector", byol["target_projector"], _PATCH_MLP, {}, out, _tensor)
    return out


# ---------------------------------------------------------------------------
# seeded random weights in the JAX layout
# ---------------------------------------------------------------------------

def _arch(cfg: ModelConfig, backbone=None) -> tuple:
    """The backbone's architecture: ("convnext", depths, dims), ("resnet",
    bottleneck, layers) or ("vit", dim, depth, patch, pretrain_grid), read
    from the port's module ``backbone`` when given, else the full-width
    ``cfg.backbone``."""
    from .convnext import ConvNeXtTiny
    from .resnet import RESNET_SPECS, Bottleneck, ResNetFeatures
    from .vit import DinoV2ViT
    if backbone is None:
        name = cfg.backbone
        if name.startswith("convnext"):
            return ("convnext", CONVNEXT_TINY_DEPTHS, CONVNEXT_TINY_DIMS)
        if name in RESNET_SPECS:
            layers, bottleneck = RESNET_SPECS[name]
            return ("resnet", bottleneck, layers)
        if name.startswith("dinov2"):
            return ("vit", 384, 12, 14, 37)
        raise ValueError(f"unknown backbone {name}")
    if isinstance(backbone, ConvNeXtTiny):
        return ("convnext", backbone.depths, backbone.dims)
    if isinstance(backbone, ResNetFeatures):
        return ("resnet", backbone.block is Bottleneck, backbone.layers)
    if isinstance(backbone, DinoV2ViT):
        return ("vit", backbone.dim, backbone.depth, backbone.patch, backbone.pretrain_grid)
    raise TypeError(f"no random weights for backbone {type(backbone).__name__}")


def random_jax_variables(cfg: ModelConfig, tree: TreeArrays, seed: int = 0,
                         backbone=None) -> Dict[str, Dict]:
    """Seeded random ``{"params": ..., "batch_stats": ...}`` in the JAX
    package's layout for the PIPNet ``cfg`` describes (BYOL's heads with
    ``cfg.use_byol``), made with numpy alone; ``backbone`` (the port's
    module) fixes the backbone's depths and widths, by default the
    full-width ``cfg.backbone``'s.

    Scales follow the JAX initializers (1/sqrt(fan_in) normals for
    kernels, xavier-uniform add-on, N(1, 0.1) in-block classifier with -0.5
    off-block), with small random biases, norm scales near 1, BatchNorm
    running statistics away from their 0/1 start (means N(0, 0.1), variances
    in [0.5, 1.5]), layer scales in [0.05, 0.2] and a position embedding of
    N(0, 0.1), so every leaf carries a value that shows if it is mapped to
    the wrong place and every block contributes to the features."""
    return _random_variables(cfg, tree, seed, _arch(cfg, backbone))


def _random_variables(cfg: ModelConfig, tree: TreeArrays, seed: int, arch: tuple) -> Dict:
    r = np.random.default_rng(seed)

    def normal(shape, std):
        return (r.standard_normal(shape) * std).astype(np.float32)

    def ln(dim):
        return {"scale": 1.0 + normal((dim,), 0.05), "bias": normal((dim,), 0.02)}

    def conv(kh, cin, cout, bias=True):
        p = {"kernel": normal((kh, kh, cin, cout), (kh * kh * cin) ** -0.5)}
        if bias:
            p["bias"] = normal((cout,), 0.02)
        return p

    def dense(cin, cout):
        return {"kernel": normal((cin, cout), cin ** -0.5), "bias": normal((cout,), 0.02)}

    def bn(dim):
        return ln(dim), {"mean": normal((dim,), 0.1),
                         "var": r.uniform(0.5, 1.5, dim).astype(np.float32)}

    def layer_scale(dim):
        return r.uniform(0.05, 0.2, dim).astype(np.float32)

    bb: Dict = {}
    stats: Dict = {}
    if arch[0] == "convnext":
        _, depths, dims = arch
        bb.update(stem_conv=conv(4, 3, dims[0]), stem_norm=ln(dims[0]))
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                bb[f"down{stage}_norm"] = ln(dims[stage - 1])
                bb[f"down{stage}_conv"] = conv(2, dims[stage - 1], dim)
            for blk in range(depth):
                bb[f"stage{stage}_block{blk}"] = {
                    "dwconv_kernel": normal((7, 7, 1, dim), 49 ** -0.5),
                    "dwconv_bias": normal((dim,), 0.02),
                    "norm_scale": 1.0 + normal((dim,), 0.05),
                    "norm_bias": normal((dim,), 0.02),
                    "mlp_in_kernel": normal((dim, 4 * dim), dim ** -0.5),
                    "mlp_in_bias": normal((4 * dim,), 0.02),
                    "mlp_out_kernel": normal((4 * dim, dim), (4 * dim) ** -0.5),
                    "mlp_out_bias": normal((dim,), 0.02),
                    "layer_scale": layer_scale(dim)}
        D = dims[-1]
    elif arch[0] == "resnet":
        _, bottleneck, layers = arch
        expansion = 4 if bottleneck else 1
        bb["conv1"] = conv(7, 3, 64, bias=False)
        bb["bn1"], stats["bn1"] = bn(64)
        inplanes = 64
        for li, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            for bi in range(blocks):
                s = (1, 2, 1, 1)[li] if bi == 0 else 1
                shapes = ([(1, inplanes, planes), (3, planes, planes), (1, planes, planes * 4)]
                          if bottleneck else [(3, inplanes, planes), (3, planes, planes)])
                bp, bs = {}, {}
                for ci, (kh, cin, cout) in enumerate(shapes):
                    bp[f"conv{ci + 1}"] = conv(kh, cin, cout, bias=False)
                    bp[f"bn{ci + 1}"], bs[f"bn{ci + 1}"] = bn(cout)
                if bi == 0 and (s != 1 or inplanes != planes * expansion):
                    bp["down_conv"] = conv(1, inplanes, planes * expansion, bias=False)
                    bp["down_bn"], bs["down_bn"] = bn(planes * expansion)
                bb[f"layer{li + 1}_block{bi}"], stats[f"layer{li + 1}_block{bi}"] = bp, bs
                inplanes = planes * expansion
        D = 512 * expansion
    else:
        _, D, depth, patch, grid = arch
        bb.update(patch_embed=conv(patch, 3, D), cls_token=normal((1, 1, D), 0.02),
                  pos_embed=normal((1, grid * grid + 1, D), 0.1))
        for i in range(depth):
            bb[f"block{i}"] = {"norm1": ln(D),
                               "attn": {"qkv": dense(D, 3 * D), "proj": dense(D, D)},
                               "ls1": layer_scale(D), "norm2": ln(D),
                               "mlp_in": dense(D, 4 * D), "mlp_out": dense(4 * D, D),
                               "ls2": layer_scale(D)}
        bb["norm"] = ln(D)

    D_backbone = D
    if cfg.stage4_reducer:
        D = cfg.stage4_reducer[-1][1]                 # the head reads the reducer's width
    P, C = tree.num_protos_padded, tree.num_children_total
    limit = np.sqrt(6.0 / (D + P))
    mask = tree.class_mask if cfg.head.protopool else tree.child_block_mask
    stds = np.ones(P, np.float32)
    for ni in range(tree.num_nodes):
        stds[tree.node_proto_slice(ni)] = np.sqrt(2.0 / (int(tree.node_num_protos[ni]) + 2))
    head = {"add_on_kernel": r.uniform(-limit, limit, (D, P)).astype(np.float32),
            "cls_weight": np.where(mask > 0, 1.0 + normal((C, P), 0.1),
                                   -0.5).astype(np.float32),
            "proto_presence": normal((P, 2), 1.0) * stds[:, None],
            "multiplier": np.full((1,), 2.0, np.float32)}
    params = {"backbone": bb, "head": head}
    batch_stats = {"backbone": stats} if stats else {}
    if cfg.use_byol:
        from .byol import BYOL_HIDDEN
        for mlp in ("projector", "predictor"):
            norm, norm_stats = bn(BYOL_HIDDEN)
            params[mlp] = {"fc_in": dense(D, BYOL_HIDDEN), "bn": norm,
                           "fc_out": dense(BYOL_HIDDEN, D)}
            batch_stats[mlp] = {"bn": norm_stats}
    if cfg.stage4_reducer:
        params["reducer"] = {f"reducer{i}": dense(cin, cout)
                             for i, (cin, cout, _) in enumerate(cfg.stage4_reducer)}
        if cfg.stage4_reducer[0][0] != D_backbone:
            raise ValueError(f"the reducer takes {cfg.stage4_reducer[0][0]} channels, the "
                             f"backbone gives {D_backbone}")
    if cfg.head.add_on_bias:
        head["add_on_bias"] = normal((P,), 0.02)
    if cfg.head.classifier_bias:
        head["cls_bias"] = normal((C,), 0.02)
    return {"params": params, "batch_stats": batch_stats}


def random_jax_params(cfg: ModelConfig, tree: TreeArrays, seed: int = 0,
                      depths=CONVNEXT_TINY_DEPTHS,
                      dims=CONVNEXT_TINY_DIMS) -> Dict[str, Dict[str, np.ndarray]]:
    """The parameters of ``random_jax_variables`` for a full-width
    ``cfg.backbone``, or for a ConvNeXt of ``depths`` and ``dims``."""
    arch = (("convnext", tuple(depths), tuple(dims)) if cfg.backbone.startswith("convnext")
            else _arch(cfg))
    return _random_variables(cfg, tree, seed, arch)["params"]


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (``random_jax_variables``) ->
    the port's ``state_dict``."""
    return params_from_jax(variables["params"], batch_stats=variables.get("batch_stats"))
