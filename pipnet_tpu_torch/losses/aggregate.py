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

    @staticmethod
    def pretrain(epoch: int, nr_epochs: int) -> "LossWeights":
        return LossWeights(align_pf=float(epoch) / float(nr_epochs), byol=0.5,
                           tanh=5.0, cl=0.0, ood=0.0)

    @staticmethod
    def train(cl_weight: float) -> "LossWeights":
        return LossWeights(align_pf=5.0, byol=2.0, tanh=2.0, cl=cl_weight, ood=0.2)


def resolve_tanh_eps(cfg: LossConfig, min_contrast_ran: bool) -> float:
    """Epsilon for every -log(tanh(x)+eps) term this step: ``cfg.tanh_eps``
    when set, else the reference's 1e-8, rebound to 1e-12 when the
    min-contrast block runs first (pipnet/train.py:238,1024)."""
    if cfg.tanh_eps is not None:
        return cfg.tanh_eps
    return 1e-12 if min_contrast_ran else C.EPS


MINMAXIMIZE_REFUSAL = (
    "minmaximize survives in the reference only as a dead stub that would crash if "
    "enabled (pipnet/train.py:1203-1214 backwards an int); not supported")


def compute_total_loss(tc: TreeConsts, outputs: Dict[str, torch.Tensor], ys: torch.Tensor,
                       w_eff: torch.Tensor, add_on_kernel: torch.Tensor,
                       proto_presence: torch.Tensor, multiplier: torch.Tensor,
                       cfg: LossConfig, weights: LossWeights, *, tree: TreeArrays,
                       pretrain: bool, finetune: bool, epoch: int = 1,
                       ood_present: bool = False,
                       generator: Optional[torch.Generator] = None,
                       presence_noise: Optional[torch.Tensor] = None,
                       byol_online: Optional[torch.Tensor] = None,
                       byol_target: Optional[torch.Tensor] = None,
                       shard=None,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step's total loss and its parts, for logging.

    ``outputs`` is the forward's dict on the two-view batch (with either
    'proto_features' or the no-pf head's 'align_pf_logsum'); ``ys`` the
    duplicated labels.  Mask-pruning draws the presence Gumbel noise once,
    from ``generator``, unless ``presence_noise`` (P, 2) is given.
    ``byol_online`` and ``byol_target`` (the EMA target's projection) give
    BYOL's regression loss, outside the finetune phases.  With
    ``ood_present`` (OOD rows, label -1, in the batch) the OOD BCE loss
    adds in outside pretraining; ``cfg.ood_ent`` changes nothing, as in the
    JAX package.  ``minmaximize`` raises, as the JAX package does.  With
    ``shard`` (a mesh's ``BatchShard`` of the two views)
    ``outputs['features']`` are this rank's rows and the feature losses
    the global batch's (``align_and_uniform``); the other outputs are the
    global batch's."""
    aux: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=ys.device)

    if cfg.byol and not finetune and byol_online is not None:
        byol = C.byol_regression_loss(byol_online, byol_target)
        total = total + weights.byol * byol
        aux["byol"] = byol

    if not finetune and (cfg.align or cfg.uni):
        if cfg.uni and not cfg.align:
            raise ValueError("uni can only be used together with align "
                             "(ref pipnet/train.py:923-924)")
        a, u = C.align_and_uniform(outputs["features"], align=cfg.align, uni=cfg.uni,
                                   shard=shard)
        if cfg.align:
            total = total + weights.align * a
            aux["align"] = a
        if cfg.uni:
            total = total + weights.unif * u
            aux["uniform"] = u

    pooled, logits = outputs["pooled"], outputs["logits"]

    if not pretrain and cfg.mask_prune_overspecific and epoch >= cfg.mask_prune_start_epoch:
        presence = soft_gumbel(proto_presence, generator, tau=0.5, noise=presence_noise)[:, 1]
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
        if "align_pf_logsum" in outputs:
            f = outputs["features"]
            apf, apf_pn = C.align_pf_from_logsum(tc, outputs["align_pf_logsum"], ys,
                                                 f.shape[1] * f.shape[2])
        else:
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

        if ood_present:
            ob, _ = C.ood_bce_loss(tc, logits, ys, multiplier)
            total = total + weights.ood * ob
            aux["ood_bce"] = ob

    if cfg.minmaximize:
        raise NotImplementedError(MINMAXIMIZE_REFUSAL)

    aux["total"] = total
    return total, aux
