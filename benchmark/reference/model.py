"""The reference's model, tree and configuration, built from a
configuration file of ``benchmark/configs`` with the frozen copy of the
port's plain path (``pipnet_ref``)."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from .pipnet_ref.config import (HeadConfig, LossConfig, ModelConfig, OptimConfig, RunConfig,
                                TrainConfig)
from .pipnet_ref.models.pipnet import PIPNet, assign_prototype_budgets
from .pipnet_ref.tree.compile import TreeArrays, compile_tree
from .pipnet_ref.tree.node import Node

_SUB = {"head": HeadConfig, "optim": OptimConfig, "loss": LossConfig}


def _from_dict(cls, d: Mapping):
    kw = {}
    for fld in dataclasses.fields(cls):
        if fld.name in d:
            v = d[fld.name]
            if fld.name in _SUB:
                v = _from_dict(_SUB[fld.name], v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[fld.name] = v
    return cls(**kw)


def merged_run_config(config: Mapping, changes: Mapping = None) -> Dict:
    """The configuration file's run config with a traffic mix's changes
    (``{"model": {...}, "train": {"loss": {...}}}``) merged in, as a dict."""
    out = copy.deepcopy(dict(config["run_config"]))

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, Mapping) and isinstance(dst.get(k), Mapping):
                merge(dst[k], v)
            else:
                dst[k] = v
    merge(out, changes or {})
    return out


def run_config(d: Mapping, compute_dtype: str = None) -> RunConfig:
    """A run-config dict as the reference's ``RunConfig``, optionally in
    another compute dtype."""
    model = dict(d["model"])
    if compute_dtype is not None:
        model["compute_dtype"] = compute_dtype
    return RunConfig(model=_from_dict(ModelConfig, model), train=_from_dict(TrainConfig, d["train"]))


def tree_of(config: Mapping, cfg: RunConfig) -> TreeArrays:
    """The configuration's tree, budgeted and compiled by the reference."""
    root = Node.from_dict(config["tree"])
    assign_prototype_budgets(root, cfg.model)
    return compile_tree(root, class_names=config["classes"], protopool=cfg.model.head.protopool,
                        weighted=cfg.train.loss.weighted_ce)


def state_shapes(config: Mapping, cfg: RunConfig) -> Tuple[Dict[str, Tuple[int, ...]], TreeArrays]:
    """The shape of every state_dict leaf of the model, from a copy built on
    the meta device (no memory), and the compiled tree."""
    tree = tree_of(config, cfg)
    with torch.device("meta"):
        model = PIPNet(tree, cfg.model)
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}, tree


def build(config: Mapping, cfg: RunConfig, weights: Mapping[str, torch.Tensor], device
          ) -> Tuple[PIPNet, TreeArrays]:
    """The reference model on ``device`` with ``weights`` loaded."""
    tree = tree_of(config, cfg)
    model = PIPNet(tree, cfg.model).to(device)
    model.load_state_dict(dict(weights))
    return model.eval(), tree
