"""Optimizer, schedules and the phase machine.

Counterpart of the JAX package's ``train/optimizer.py``.  The reference runs
two torch AdamW optimizers with parameter groups at different learning
rates (``util/args.py:447-571``), per-batch cosine schedulers
(``main.py:398,502-507``) and an epoch-level ``requires_grad`` state machine
(``main.py:521-626``).  Here, as in the JAX package, one masked AdamW steps
every parameter group: each parameter has a group label (backbone / freeze
/ train / add_on / classifier / presence / frozen) that gives its base
learning rate, and its own step count, so a parameter not stepped in a
phase keeps its Adam state and bias correction, as a torch parameter with
``requires_grad=False`` does.  Schedules are plain functions of the step
position, and all scalars are Python floats.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..config import OptimConfig, TrainConfig
from ..models.convnext import convnext_param_groups
from ..models.resnet import resnet_param_groups
from ..models.vit import vit_param_groups

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# group labels
# ---------------------------------------------------------------------------

_HEAD_GROUPS = {"add_on_kernel": "add_on", "cls_weight": "classifier",
                "cls_bias": "classifier", "proto_presence": "presence",
                "multiplier": "frozen"}       # frozen at 2.0 (main.py:347,368,387)


def label_params(names, backbone_arch: str) -> Dict[str, str]:
    """Group label of each parameter name of the port's ``PIPNet``
    (``head.<leaf>``, ``backbone.<module>.<...>``, BYOL's ``projector.*``
    and ``predictor.*``), the reference's partition
    (``util/args.py:464-556``).  BYOL's heads train with the net optimizer
    at the backbone tail's rate, as in the JAX package (the reference's
    BYOL optimizer is NotImplemented, util/args.py:453-454)."""
    if backbone_arch.startswith("convnext"):
        groups = convnext_param_groups
    elif backbone_arch.startswith("dinov2"):
        groups = vit_param_groups
    else:
        groups = functools.partial(resnet_param_groups, arch=backbone_arch)
    labels = {}
    for name in names:
        top, module = name.split(".")[:2]
        if top == "head":
            labels[name] = _HEAD_GROUPS.get(module, "frozen")
        elif top in ("projector", "predictor"):
            labels[name] = "train"
        elif top == "backbone":
            labels[name] = groups([module])[module]
        else:
            labels[name] = "frozen"
    return labels


GROUP_TO_OPT = {"backbone": "net", "freeze": "net", "train": "net", "add_on": "net",
                "classifier": "cls", "presence": "cls", "frozen": None}


def base_lrs(cfg: OptimConfig) -> Dict[str, float]:
    return {"backbone": cfg.lr_net, "freeze": cfg.lr_block, "train": cfg.lr_block,
            "add_on": cfg.lr_block * 10.0,       # util/args.py:556
            "classifier": cfg.lr, "presence": cfg.lr,   # util/args.py:562
            "frozen": 0.0}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_annealing(base_lr: float, eta_min: float, t: float, t_max: float) -> float:
    """torch CosineAnnealingLR's value at step t of t_max."""
    frac = min(max(t / max(t_max, 1.0), 0.0), 1.0)
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * frac)) / 2.0


def cosine_warm_restarts(base_lr: float, eta_min: float, epoch_frac: float,
                         t0: float) -> float:
    """torch CosineAnnealingWarmRestarts (T_mult=1) at a fractional epoch."""
    tcur = epoch_frac % t0
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * tcur / t0)) / 2.0


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------

def clip_gradients(grads: Mapping[str, Optional[torch.Tensor]], labels: Mapping[str, str],
                   clip: float, *, per_group: bool = False
                   ) -> Tuple[Dict[str, Optional[torch.Tensor]], torch.Tensor]:
    """Gradient-norm clipping; returns (clipped gradients, the pre-clip
    global norm as a device scalar).  A missing gradient (None) counts as
    zeros and stays None.  ``per_group`` scales each parameter group by its
    own norm (see ``OptimConfig.clip_grad_per_group``); the returned norm is
    the global one either way."""
    present = {n: g for n, g in grads.items() if g is not None}
    sq = {n: g.float().square().sum() for n, g in present.items()}
    if not sq:
        raise ValueError("no gradients to clip")
    global_norm = torch.stack(list(sq.values())).sum().sqrt()
    if per_group:
        group_sq: Dict[str, torch.Tensor] = {}
        for n, s in sq.items():
            group_sq[labels[n]] = group_sq.get(labels[n], 0.0) + s
        scale = {lab: (clip / (s.sqrt() + 1e-12)).clamp(max=1.0)
                 for lab, s in group_sq.items()}
        out = {n: g * scale[labels[n]].to(g.dtype) for n, g in present.items()}
    else:
        s = (clip / (global_norm + 1e-12)).clamp(max=1.0)
        out = {n: g * s.to(g.dtype) for n, g in present.items()}
    return {n: out.get(n) for n in grads}, global_norm


# ---------------------------------------------------------------------------
# masked AdamW with per-parameter counts
# ---------------------------------------------------------------------------

@dataclass
class AdamState:
    mu: Tensors
    nu: Tensors
    count: Dict[str, int]       # steps each parameter has taken


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    return AdamState(mu={n: torch.zeros_like(p) for n, p in params.items()},
                     nu={n: torch.zeros_like(p) for n, p in params.items()},
                     count={n: 0 for n in params})


@torch.no_grad()
def adam_update(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, Optional[torch.Tensor]], state: AdamState,
                lrs: Mapping[str, float], masks: Mapping[str, bool],
                weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """One masked AdamW step, in place on ``params`` and ``state``.  A
    parameter whose mask is False keeps its value, moments and count; one
    whose mask is True and whose gradient is None steps with a zero
    gradient, as the JAX package's pruned leaves do."""
    names = [n for n in params if masks[n]]
    if not names:
        return
    ps = [params[n] for n in names]
    gs = [grads[n] if grads[n] is not None else torch.zeros_like(params[n]) for n in names]
    mus = [state.mu[n] for n in names]
    nus = [state.nu[n] for n in names]
    for n in names:
        state.count[n] += 1
    bc1 = [1.0 - b1 ** state.count[n] for n in names]
    bc2 = [1.0 - b2 ** state.count[n] for n in names]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1.0 - b2)
    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    if weight_decay:
        torch._foreach_mul_(ps, [1.0 - lrs[n] * weight_decay for n in names])
    torch._foreach_addcdiv_(ps, mus, denom, [-lrs[n] / c for n, c in zip(names, bc1)])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Phase:
    """Which parameter groups train in one phase (the requires_grad
    machine, main.py:431-445,521-626)."""
    name: str
    pretrain: bool = False
    finetune: bool = False
    mask_only: bool = False         # epoch > epochs_finetune_mask_prune
    backbone_frozen: bool = True    # until freeze_epochs
    classifier_trains: bool = True
    net_trains: bool = True
    add_on_trains: bool = True


def phase_for_epoch(epoch: int, cfg: TrainConfig, *, pretrain: bool) -> Phase:
    if pretrain:
        return Phase(name="pretrain", pretrain=True, classifier_trains=False,
                     backbone_frozen=True, add_on_trains=True)
    if epoch <= cfg.epochs_finetune_classifier:
        return Phase(name="finetune_classifier", finetune=True, net_trains=False,
                     add_on_trains=False)
    if epoch <= cfg.epochs_finetune:
        return Phase(name="finetune", finetune=True, net_trains=False, add_on_trains=True)
    if epoch > cfg.epochs_finetune_mask_prune:
        return Phase(name="mask_only", mask_only=True, net_trains=False)
    return Phase(name="train", backbone_frozen=epoch <= cfg.freeze_epochs)


def group_trainable(group: str, phase: Phase) -> bool:
    """Whether a parameter group updates in this phase."""
    if group == "frozen":
        return False
    if phase.mask_only:
        return group == "presence"
    if group in ("classifier", "presence"):
        return phase.classifier_trains and not phase.pretrain
    if not phase.net_trains:
        return False
    if group == "add_on":
        return phase.add_on_trains
    if group in ("train", "freeze"):
        # the 'freeze' group trains at lr_block whenever the net trains
        # (main.py:442-443,606-616 keep requires_grad True for it)
        return True
    if group == "backbone":
        return not phase.backbone_frozen and not phase.pretrain
    return False


def masks_and_lrs(labels: Mapping[str, str], phase: Phase, cfg: OptimConfig,
                  net_lr: Callable[[float], float], cls_lr: Callable[[float], float],
                  backbone_lr: Optional[Callable[[float], float]] = None
                  ) -> Tuple[Dict[str, bool], Dict[str, float]]:
    """Per-parameter (mask, learning rate) for one step.  ``net_lr`` and
    ``cls_lr`` map a group's base rate to its scheduled rate for the net and
    classifier optimizers; ``backbone_lr``, when given, replaces ``net_lr``
    for the deep 'backbone' group (the unfreeze warm-up ramp)."""
    base = base_lrs(cfg)
    masks, lrs = {}, {}
    for name, label in labels.items():
        masks[name] = group_trainable(label, phase)
        opt = GROUP_TO_OPT[label]
        if opt == "net":
            fn = backbone_lr if (label == "backbone" and backbone_lr is not None) else net_lr
            lrs[name] = fn(base[label])
        elif opt == "cls":
            lrs[name] = cls_lr(base[label])
        else:
            lrs[name] = 0.0
    return masks, lrs
