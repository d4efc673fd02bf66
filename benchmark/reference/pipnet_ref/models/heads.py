"""The stacked prototype head as the plain composition.

  features (B,H,W,D) --F K, per-node softmax, max-pool--> pf (B,H,W,P),
  pooled (B,P) --threshold--> --block-masked non-neg linear--> logits (B,C)

Counterpart of the JAX package's ``PrototypeHead`` (``models/heads.py``) on
its XLA path, cut to the head the benchmark's configurations state: the
conv add-on without bias, the per-node temperature softmax, max pooling and
the non-negative classifier without bias.  The port runs this head through
its fused kernels (K1, K1b); the reference computes the same per-node
softmax with the composed operations of ``ops/segment.py``.  A head
configuration that asks for a variant raises.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import HeadConfig
from ..ops.segment import segment_softmax
from ..tree.compile import TreeArrays


def _variants(cfg: HeadConfig) -> list:
    """The options of ``cfg`` that the reference's head does not hold."""
    return [name for name, on in (
        ("add_on_type != conv", cfg.add_on_type != "conv"),
        ("add_on_bias", cfg.add_on_bias),
        ("softmax_tau None", cfg.softmax_tau is None),
        ("softmax_over_channel", cfg.softmax_over_channel),
        ("multiply_cs_softmax", cfg.multiply_cs_softmax),
        ("gumbel_softmax", cfg.gumbel_softmax),
        ("focal", cfg.focal),
        ("classifier != nonneg", cfg.classifier != "nonneg"),
        ("classifier_bias", cfg.classifier_bias),
        ("sg_before_protos", cfg.sg_before_protos)) if on]


class PrototypeHead(nn.Module):
    """Stacked multi-node prototype head over compiled ``TreeArrays``.
    Parameter names and layouts are the JAX package's: ``add_on_kernel``
    (D, P), ``cls_weight`` (C, P), ``proto_presence`` (P, 2) and
    ``multiplier`` (1,)."""

    def __init__(self, tree: TreeArrays, cfg: HeadConfig, in_channels: int):
        super().__init__()
        unsupported = _variants(cfg)
        if unsupported:
            raise ValueError(f"the reference's head does not hold {unsupported}")
        self.tree, self.cfg = tree, cfg
        P, C = tree.num_protos_padded, tree.num_children_total
        self.add_on_kernel = nn.Parameter(torch.zeros(in_channels, P))
        self.cls_weight = nn.Parameter(torch.zeros(C, P))
        self.proto_presence = nn.Parameter(torch.zeros(P, 2))
        self.multiplier = nn.Parameter(torch.full((1,), 2.0))
        mask = tree.class_mask if cfg.protopool else tree.child_block_mask
        self.register_buffer("cls_mask", torch.as_tensor(mask), persistent=False)

    def effective_cls_weight(self) -> torch.Tensor:
        """relu(W) under the static block mask — the weights the classifier
        actually applies."""
        return torch.relu(self.cls_weight) * self.cls_mask

    def forward(self, features: torch.Tensor, *, inference: bool = False
                ) -> Dict[str, torch.Tensor]:
        """features (B, H, W, D) -> {'proto_features', 'pooled', 'logits'}
        (the JAX head's XLA path, ``models/heads.py:209-244``)."""
        z = features @ self.add_on_kernel.to(features.dtype)
        pf = segment_softmax(z, self.tree, tau=self.cfg.softmax_tau)
        pooled = pf.amax(dim=(1, 2))                         # AdaptiveMaxPool2d
        pooled, logits = self.classify(pooled, inference=inference)
        return {"proto_features": pf, "pooled": pooled, "logits": logits}

    def classify(self, pooled: torch.Tensor, *, inference: bool = False):
        """pooled (B, P) in the compute dtype -> (pooled after the inference
        threshold, logits (B, C))."""
        if inference:
            pooled = torch.where(pooled < self.cfg.inference_threshold,
                                 torch.zeros_like(pooled), pooled)
        logits = pooled @ self.effective_cls_weight().to(pooled.dtype).T
        return pooled, logits
