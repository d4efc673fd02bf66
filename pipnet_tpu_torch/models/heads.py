"""The stacked prototype head (inference), over the fused head kernel K1.

  features (B,H,W,D) --K1: matmul, per-node softmax, max-pool--> pf (B,H,W,P),
  pooled (B,P) --threshold--> --block-masked non-neg linear--> logits (B,C)

Counterpart of the JAX package's ``PrototypeHead`` on its fused path
(``models/heads.py:164-206``).  The port has one head path: K1 through
``ops/fused_head.py`` (the CUDA kernel on the card, its plain version on the
CPU), which computes the per-node temperature softmax that both of the JAX
package's head paths compute.  The other add-on types, the spatial, Gumbel
and cosine-multiplied softmax variants, focal pooling and the
overspecificity mask come with later slices and raise here.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import HeadConfig
from ..ops.fused_head import fused_head
from ..tree.compile import TreeArrays


def _unported(cfg: HeadConfig) -> list:
    return [name for name, on in (
        (f"add_on_type={cfg.add_on_type!r}", cfg.add_on_type != "conv"),
        ("add_on_bias", cfg.add_on_bias),
        ("softmax_tau=None", cfg.softmax_tau is None),
        ("softmax_over_channel", cfg.softmax_over_channel),
        ("multiply_cs_softmax", cfg.multiply_cs_softmax),
        ("gumbel_softmax", cfg.gumbel_softmax),
        ("focal", cfg.focal)) if on]


class PrototypeHead(nn.Module):
    """Stacked multi-node prototype head over compiled ``TreeArrays``.
    Parameter names and layouts are the JAX package's: ``add_on_kernel``
    (D, P), ``cls_weight`` (C, P), ``proto_presence`` (P, 2), ``multiplier``
    (1,), and ``cls_bias`` (C,) with ``classifier_bias``."""

    def __init__(self, tree: TreeArrays, cfg: HeadConfig, in_channels: int):
        super().__init__()
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                f"head options {missing} are not ported yet (they come with "
                "the head-variants slice); the port serves the conv add-on "
                "with the per-node softmax")
        self.tree, self.cfg = tree, cfg
        P, C = tree.num_protos_padded, tree.num_children_total
        self.add_on_kernel = nn.Parameter(torch.zeros(in_channels, P))
        self.cls_weight = nn.Parameter(torch.zeros(C, P))
        self.proto_presence = nn.Parameter(torch.zeros(P, 2))
        self.multiplier = nn.Parameter(torch.full((1,), 2.0))
        if cfg.classifier_bias:
            self.cls_bias = nn.Parameter(torch.zeros(C))
        mask = tree.class_mask if cfg.protopool else tree.child_block_mask
        self.register_buffer("cls_mask", torch.as_tensor(mask), persistent=False)

    def effective_cls_weight(self) -> torch.Tensor:
        """relu(W) under the static block mask — the weights the classifier
        actually applies."""
        w = self.cls_weight
        if self.cfg.classifier == "nonneg":
            w = torch.relu(w)
        return w * self.cls_mask

    def forward(self, features: torch.Tensor, *, inference: bool = False,
                apply_overspecificity_mask: bool = False) -> Dict[str, torch.Tensor]:
        if apply_overspecificity_mask:
            raise NotImplementedError(
                "the overspecificity mask is not ported yet (it comes with "
                "the head-variants slice)")
        cfg = self.cfg
        if cfg.sg_before_protos:
            features = features.detach()
        pf, pooled = fused_head(features, self.add_on_kernel.to(features.dtype),
                                self.tree, tau=cfg.softmax_tau)
        # cast before the threshold, as the JAX head does (heads.py:199-201)
        pooled, logits = self.classify(pooled.to(features.dtype), inference=inference)
        return {"proto_features": pf, "pooled": pooled, "logits": logits}

    def classify(self, pooled: torch.Tensor, *, inference: bool = False):
        """pooled (B, P) in the compute dtype -> (pooled after the inference
        threshold, logits (B, C))."""
        cfg = self.cfg
        if inference:
            pooled = torch.where(pooled < cfg.inference_threshold,
                                 torch.zeros_like(pooled), pooled)
        logits = pooled @ self.effective_cls_weight().to(pooled.dtype).T
        if cfg.classifier_bias:
            logits = logits + self.cls_bias.to(pooled.dtype)
        return pooled, logits
