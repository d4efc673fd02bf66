"""Total loss of one step, with the reference's phase-dependent weights.

Counterpart of the JAX package's ``losses/aggregate.py``: ``train_pipnet``'s
weight tables (``pipnet/train.py:148-177``) and ``calculate_loss``'s gating
rules (``pipnet/train.py:852-1217``) as one function of the forward's
outputs, differentiable by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..config import LossConfig
from ..ops.segment import soft_gumbel
from ..tree.compile import TreeArrays
from . import catalog as C
from .catalog import TreeConsts


@dataclass(frozen=True)
class LossWeights:
    """Phase weight table (ref pipnet/train.py:148-177)."""
    align_pf: float
    byol: float
    align: float = 0.5
    unif: float = 3.0
    tanh: float = 5.0
    cl: float = 0.0
    ood: float = 0.0
    orth: float = 0.5


def resolve_tanh_eps(cfg: LossConfig, min_contrast_ran: bool) -> float:
    """Epsilon for every -log(tanh(x)+eps) term this step: ``cfg.tanh_eps``
    when set, else the reference's 1e-8, rebound to 1e-12 when the
    min-contrast block runs first (pipnet/train.py:238,1024)."""
    if cfg.tanh_eps is not None:
        return cfg.tanh_eps
    return 1e-12 if min_contrast_ran else C.EPS


def compute_total_loss(tc: TreeConsts, outputs: Dict[str, torch.Tensor], ys: torch.Tensor,
                       w_eff: torch.Tensor, add_on_kernel: torch.Tensor,
                       proto_presence: torch.Tensor, multiplier: torch.Tensor,
                       cfg: LossConfig, weights: LossWeights, *, tree: TreeArrays,
                       pretrain: bool, finetune: bool, epoch: int = 1,
                       generator: Optional[torch.Generator] = None,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step's total loss and its parts, for logging.

    ``outputs`` is the forward's dict on the two-view batch; ``ys`` the
    duplicated labels.  Mask-pruning draws the presence Gumbel noise once,
    from ``generator``.  BYOL's loss, the OOD losses and ``minmaximize``,
    which no cell runs, raise."""
    unsupported = [name for name, on in (("byol", cfg.byol), ("ood_ent", cfg.ood_ent),
                                         ("minmaximize", cfg.minmaximize)) if on]
    if unsupported:
        raise ValueError(f"the reference's losses do not hold {unsupported}")
    aux: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=ys.device)

    if not finetune and (cfg.align or cfg.uni):
        if cfg.uni and not cfg.align:
            raise ValueError("uni can only be used together with align "
                             "(ref pipnet/train.py:923-924)")
        a, u = C.align_and_uniform(outputs["features"], align=cfg.align, uni=cfg.uni)
        if cfg.align:
            total = total + weights.align * a
            aux["align"] = a
        if cfg.uni:
            total = total + weights.unif * u
            aux["uniform"] = u

    pooled, logits = outputs["pooled"], outputs["logits"]

    if not pretrain and cfg.mask_prune_overspecific and epoch >= cfg.mask_prune_start_epoch:
        presence = soft_gumbel(proto_presence, generator, tau=0.5)[:, 1]
        os_ = C.overspecificity_losses(
            tc, pooled, ys, w_eff, presence, boost=cfg.mask_prune_boost,
            geometric_mean=cfg.geometric_mean_overspecificity,
            sg_score=cfg.sg_before_masking)
        total = total + os_["overspecificity"] + os_["mask_l1"]
        aux["overspecificity"] = os_["overspecificity"]
        aux["mask_l1"] = os_["mask_l1"]

    min_contrast_ran = not pretrain and not finetune and cfg.minimize_contrasting_set
    if min_contrast_ran:
        mc, _ = C.min_contrast_loss(tc, pooled, ys, w_eff, topk=cfg.min_contrast_topk)
        total = total + cfg.min_contrast_weight * mc
        aux["min_contrast"] = mc

    tanh_eps = resolve_tanh_eps(cfg, min_contrast_ran)

    if not finetune and cfg.align_pf:
        eps = cfg.align_eps if cfg.align_eps is not None else C.ALIGN_EPS
        apf, apf_pn = C.align_pf_loss(tc, outputs["proto_features"], ys, eps=eps)
        total = total + weights.align_pf * apf
        aux["align_pf"] = apf
        aux["align_pf_per_node"] = apf_pn

    if not finetune and cfg.tanh and (cfg.tanh_during_second_phase or pretrain):
        th, th_pn = C.tanh_loss(tc, pooled, ys, eps=tanh_eps)
        total = total + weights.tanh * th
        aux["tanh"] = th
        aux["tanh_per_node"] = th_pn

    if not finetune and not pretrain and cfg.tanh_desc:
        td, td_pn = C.tanh_desc_loss(tc, pooled, ys, w_eff, eps=tanh_eps)
        total = total + cfg.tanh_desc_weight * td
        aux["tanh_desc"] = td
        aux["tanh_desc_per_node"] = td_pn

    if not pretrain and not finetune and cfg.kernel_orth:
        ko, ko_pn = C.kernel_orth_loss(tree, tc, add_on_kernel, w_eff, cap=cfg.kernel_orth_cap)
        total = total + weights.orth * ko
        aux["kernel_orth"] = ko
        aux["kernel_orth_per_node"] = ko_pn

    if not pretrain:
        cl, cl_pn = C.classification_loss(
            tc, logits, ys, multiplier, pipnet_sparsity=cfg.pipnet_sparsity,
            weighted=cfg.weighted_ce,
            focal_gamma=cfg.focal_loss_gamma if cfg.focal_loss else None)
        total = total + weights.cl * cl
        aux["class"] = cl
        aux["class_per_node"] = cl_pn

    aux["total"] = total
    return total, aux
