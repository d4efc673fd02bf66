"""Rebuild a trained run from its artifacts.

A run directory holds ``metadata/config.json`` (the frozen configuration),
``metadata/classes.json`` (class names), ``metadata/tree.json`` (the exact
trained topology) and ``checkpoints/<name>.pt``, the port's ``state_dict``
saved with ``torch.save``.  Reading the JAX package's orbax checkpoints needs
JAX and comes with a later conversion tool; ``models/convert.py`` maps a
flax parameter tree that is already in memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, NamedTuple, Optional, Union

import torch

from .config import (HeadConfig, LossConfig, ModelConfig, OptimConfig,
                     RunConfig, TrainConfig)
from .device import resolve_device
from .models.pipnet import build_pipnet
from .tree.node import Node

_SUBCONFIGS = {"head": HeadConfig, "optim": OptimConfig, "loss": LossConfig,
               "model": ModelConfig, "train": TrainConfig}


def config_from_dict(cls, d: dict):
    """Rebuild a (nested, frozen) config dataclass from its asdict() JSON."""
    kw = {}
    for fld in dataclasses.fields(cls):
        if fld.name in d:
            v = d[fld.name]
            if fld.name in _SUBCONFIGS:
                v = config_from_dict(_SUBCONFIGS[fld.name], v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[fld.name] = v
    return cls(**kw)


def load_run_config(run_dir: str) -> RunConfig:
    with open(os.path.join(run_dir, "metadata", "config.json")) as f:
        saved = json.load(f)
    return RunConfig(
        model=config_from_dict(ModelConfig, saved["model"]),
        train=config_from_dict(TrainConfig, saved["train"]),
        **{k: saved[k] for k in ("log_dir", "dataset", "phylo_config",
                                 "leave_out_classes")
           if saved.get(k) is not None})


def load_classes(run_dir: str) -> Optional[List[str]]:
    """Class names saved at training time (``metadata/classes.json``)."""
    path = os.path.join(run_dir, "metadata", "classes.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


class RunBundle(NamedTuple):
    cfg: RunConfig
    model: object                 # PIPNet, on the requested device, eval mode
    tree: object                  # TreeArrays
    classes: List[str]


def load_run(run_dir: str, checkpoint: str = "net_trained_last",
             classes: Optional[List[str]] = None,
             device: Union[str, torch.device] = "cuda") -> RunBundle:
    """Run directory -> live model on ``device`` (the card unless the caller
    asks for the CPU).  ``classes`` overrides ``metadata/classes.json``; the
    tree is the exact trained topology in ``metadata/tree.json``."""
    dev = resolve_device(device)
    cfg = load_run_config(run_dir)
    classes = classes or load_classes(run_dir)
    if classes is None:
        raise RuntimeError(
            f"run {run_dir!r} has no metadata/classes.json; pass classes= "
            "(resolving the training dataset is not ported)")
    tree_json = os.path.join(run_dir, "metadata", "tree.json")
    if not os.path.exists(tree_json):
        raise RuntimeError(
            f"run {run_dir!r} has no metadata/tree.json (rebuilding the tree "
            "from the run's phylogeny is not ported)")
    with open(tree_json) as f:
        root = Node.from_dict(json.load(f))

    model, tree = build_pipnet(root, cfg.model,
                               weighted=cfg.train.loss.weighted_ce,
                               class_names=classes, device=dev)
    path = os.path.join(run_dir, "checkpoints", f"{checkpoint}.pt")
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state)
    return RunBundle(cfg=cfg, model=model, tree=tree, classes=list(classes))
