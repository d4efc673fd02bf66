"""Parameters in the JAX package's layout -> the port's ``state_dict``.

``params_from_jax`` takes the flax ``PIPNet`` parameter tree as nested dicts
of numpy arrays (``{"backbone": {...}, "head": {...}}``) and returns the
port's ``state_dict``:

* ``stem_conv`` / ``down{i}_conv``: kernel HWIO -> ``weight`` OIHW, ``bias``
* ``stem_norm`` / ``down{i}_norm``: ``scale``/``bias`` -> ``weight``/``bias``
* ``stage{s}_block{b}``: ``dwconv_kernel`` (7,7,1,C) -> ``dwconv.weight``
  (C,1,7,7); ``mlp_{in,out}_kernel`` (in,out) -> ``mlp_{in,out}.weight``
  (out,in); the biases, ``norm_scale``, ``norm_bias`` and ``layer_scale``
  as they are
* ``head``: ``add_on_kernel`` (D,P), ``cls_weight`` (C,P), ``proto_presence``
  (P,2), ``multiplier``, and ``cls_bias`` when present, as they are

Any leaf it cannot map, and any leaf a module needs but lacks, raises.
``opt_state_from_jax`` maps the JAX package's Adam state (moments laid out
as the parameters, one step count per leaf) onto the port's names, so a run
can continue in the port mid-way.  ``random_jax_params`` makes seeded
weights in that same layout, from numpy alone, for runs that need a model
without a trained checkpoint.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..tree.compile import TreeArrays
from .convnext import CONVNEXT_TINY_DEPTHS, CONVNEXT_TINY_DIMS

_CONV = {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),
         "bias": ("bias", None)}
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
_HEAD = {name: (name, None) for name in
         ("add_on_kernel", "cls_weight", "proto_presence", "multiplier")}
_HEAD_OPTIONAL = {"cls_bias": ("cls_bias", None)}


def _backbone_rules(module: str):
    if re.fullmatch(r"stem_conv|down\d+_conv", module):
        return _CONV, {}
    if re.fullmatch(r"stem_norm|down\d+_norm", module):
        return _NORM, {}
    if re.fullmatch(r"stage\d+_block\d+", module):
        return _BLOCK, {}
    return None


def _tensor(value, fn) -> torch.Tensor:
    arr = np.asarray(value, np.float32)
    if fn is not None:
        arr = fn(arr)
    return torch.from_numpy(np.ascontiguousarray(arr))


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
        name, fn = {**required, **optional}[key]
        out[f"{prefix.replace('/', '.')}.{name}"] = leaf(value, fn)


def params_from_jax(params: Mapping, leaf: Callable = _tensor) -> Dict[str, torch.Tensor]:
    """flax ``PIPNet`` params (nested dicts of arrays) -> the port's
    ``state_dict`` (float32 tensors on the CPU).  ``leaf(value, layout_fn)``
    makes each entry."""
    unknown = sorted(set(params) - {"backbone", "head"})
    if unknown or "backbone" not in params or "head" not in params:
        raise KeyError(f"expected top-level 'backbone' and 'head', got {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    for module, leaves in params["backbone"].items():
        rules = _backbone_rules(module)
        if rules is None:
            raise KeyError(f"unmapped backbone module backbone/{module}")
        _map_module(f"backbone/{module}", leaves, *rules, out, leaf)
    for needed in ("stem_conv", "stem_norm"):
        if needed not in params["backbone"]:
            raise KeyError(f"missing backbone module backbone/{needed}")
    _map_module("head", params["head"], _HEAD, _HEAD_OPTIONAL, out, leaf)
    return out


def opt_state_from_jax(opt):
    """The JAX package's ``AdamState`` (``mu``, ``nu`` laid out as the params,
    ``count`` one int per leaf) -> the port's ``train.optimizer.AdamState``
    (CPU tensors under the port's parameter names, counts as ints)."""
    from ..train.optimizer import AdamState
    return AdamState(mu=params_from_jax(opt.mu), nu=params_from_jax(opt.nu),
                     count=params_from_jax(opt.count, lambda v, fn: int(np.asarray(v))))


def random_jax_params(cfg: ModelConfig, tree: TreeArrays, seed: int = 0,
                      depths=CONVNEXT_TINY_DEPTHS,
                      dims=CONVNEXT_TINY_DIMS) -> Dict[str, Dict[str, np.ndarray]]:
    """Seeded random parameters in the JAX package's layout for a ConvNeXt
    PIPNet, made with numpy alone.

    Scales follow the JAX initializers (1/sqrt(fan_in) normals for
    kernels, xavier-uniform add-on, N(1, 0.1) in-block classifier with -0.5
    off-block), with small random biases, LayerNorm scales near 1 and layer
    scales in [0.05, 0.2], so every leaf carries a value that shows if it is
    mapped to the wrong place and every block contributes to the features."""
    if cfg.head.classifier_bias:
        raise NotImplementedError("random_jax_params makes no classifier bias")
    r = np.random.default_rng(seed)

    def normal(shape, std):
        return (r.standard_normal(shape) * std).astype(np.float32)

    def ln(dim):
        return {"scale": 1.0 + normal((dim,), 0.05), "bias": normal((dim,), 0.02)}

    def conv(kh, cin, cout):
        return {"kernel": normal((kh, kh, cin, cout), (kh * kh * cin) ** -0.5),
                "bias": normal((cout,), 0.02)}

    bb: Dict[str, Dict[str, np.ndarray]] = {
        "stem_conv": conv(4, 3, dims[0]), "stem_norm": ln(dims[0])}
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
                "layer_scale": r.uniform(0.05, 0.2, dim).astype(np.float32)}
    D, P, C = dims[-1], tree.num_protos_padded, tree.num_children_total
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
    return {"backbone": bb, "head": head}
