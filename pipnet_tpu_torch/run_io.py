"""Rebuild a trained run from its artifacts.

A run directory holds ``metadata/config.json`` (the frozen configuration),
``metadata/classes.json`` (class names), ``metadata/tree.json`` (the exact
trained topology) and ``checkpoints/<name>.pt``, the port's ``state_dict``
saved with ``torch.save``.  A run without the class names or the tree gets
them from its dataset, resolved as in training.  Reading the JAX package's
orbax checkpoints needs JAX and comes with a later conversion tool;
``models/convert.py`` maps a flax parameter tree that is already in memory.
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
             device: Union[str, torch.device] = "cuda",
             dataset: Optional[str] = None,
             phylo_path: Optional[str] = None) -> RunBundle:
    """Run directory -> live model on ``device`` (the card unless the caller
    asks for the CPU).

    Class names come from ``classes``, else ``metadata/classes.json``, else
    the run's dataset (or ``dataset``), resolved (``datasets.resolve_dataset``)
    and its class directories listed.  The tree is the exact trained
    topology in ``metadata/tree.json``; for a run without one it is built
    from ``phylo_path``, the dataset's bundled phylogeny, or the config's
    ``phylo_config``, and with none of these it is the flat tree."""
    from .datasets import resolve_dataset
    from .tree import build_tree_from_config, flat_tree

    dev = resolve_device(device)
    cfg = load_run_config(run_dir)
    classes = classes or load_classes(run_dir)
    tree_json = os.path.join(run_dir, "metadata", "tree.json")
    have_tree = os.path.exists(tree_json) or phylo_path is not None
    # resolve the training dataset only when something is still missing:
    # class names, or the bundled phylogeny of a run that recorded none
    if classes is None or (not have_tree and cfg.phylo_config is None):
        ds = dataset or cfg.dataset
        try:
            train_dir, _, _, dkw = resolve_dataset(ds, seed=cfg.train.seed)
        except (OSError, ValueError) as e:
            missing = ("metadata/classes.json", "class names") if classes is None else \
                ("metadata/tree.json", "the hierarchy")
            raise RuntimeError(
                f"cannot rebuild run {run_dir!r}: it has no {missing[0]}, so "
                f"{missing[1]} must come from the training dataset ({ds!r}), which "
                f"failed to resolve on this host ({e}); pass dataset=, classes= or "
                "phylo_path=") from e
        if classes is None:
            classes = sorted(e.name for e in os.scandir(train_dir) if e.is_dir())
        phylo_path = phylo_path or dkw.get("phylo_path")

    if os.path.exists(tree_json):
        with open(tree_json) as f:
            root = Node.from_dict(json.load(f))
    elif phylo_path and str(phylo_path).endswith((".phy", ".tre")):
        root = build_tree_from_config(phylo_path, None)
    elif cfg.phylo_config:
        root = _tree_from_phylo_config(run_dir, str(cfg.phylo_config))
    else:
        root = flat_tree(classes, cfg.model.num_features or 512)

    model, tree = build_pipnet(root, cfg.model,
                               weighted=cfg.train.loss.weighted_ce,
                               class_names=classes, device=dev)
    path = os.path.join(run_dir, "checkpoints", f"{checkpoint}.pt")
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state)
    return RunBundle(cfg=cfg, model=model, tree=tree, classes=list(classes))


def _tree_from_phylo_config(run_dir: str, phylo_config: str) -> Node:
    """The tree of a run config's ``phylo_config``: a Newick file, or a YAML
    file naming one (``phylogeny_path``, ``$VAR``s expanded) and its
    ``phyloDistances_string``."""
    from .tree import build_tree_from_config
    if not os.path.exists(phylo_config):
        raise RuntimeError(
            f"run {run_dir!r} records phylogeny {phylo_config!r}, which does not "
            "exist on this host; refusing to fall back to a flat tree (the "
            "checkpoint shapes would not match).  Restore that file, or pass "
            "phylo_path=")
    if phylo_config.endswith((".phy", ".tre")):
        return build_tree_from_config(phylo_config, None)
    import yaml
    with open(phylo_config) as f:
        pc = yaml.safe_load(f)
    d = pc.get("phyloDistances_string")
    return build_tree_from_config(os.path.expandvars(pc["phylogeny_path"]),
                                  None if d in ("None", None) else d)
