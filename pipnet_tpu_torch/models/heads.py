"""The stacked prototype head, over the fused head kernels K1 and K2.

  features (B,H,W,D) --K1: matmul, per-node softmax, max-pool--> pf (B,H,W,P),
  pooled (B,P) --threshold--> --block-masked non-neg linear--> logits (B,C)

Counterpart of the JAX package's ``PrototypeHead`` on its fused path
(``models/heads.py:155-206``).  The port has one head path: K1 through
``ops/fused_head.py`` (the CUDA kernel on the card, its plain version on the
CPU; differentiable, with K1b as its backward), which computes the per-node
temperature softmax that both of the JAX package's head paths compute.
With ``fuse_align_pf`` a two-view training batch goes through K2 instead
(``ops/fused_head_nopf.py``): pooled and align_pf's per-node log-reduction,
with pf never materialised.  The other add-on types, the spatial, Gumbel
and cosine-multiplied softmax variants and focal pooling come with later
slices and raise here.

The overspecificity mask (``apply_overspecificity_mask`` with a presence
sample ``keep``) multiplies pooled after the spatial max and before the
inference threshold, the JAX head's order (``models/heads.py:230-237``).
Unlike the JAX head, which leaves its Pallas kernel for the plain path when
the mask is on, the masked head stays on K1: the mask acts after the max,
so K1's pf and pooled are what the plain path computes first, and a pruned
model evaluated or served on the card runs the kernel.  In float32 the two
agree to K1's bar; in bf16 ``keep`` is cast to the pooled dtype (0 or 1
there), where the JAX head promotes pooled to float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import HeadConfig
from ..losses.catalog import ALIGN_EPS
from ..ops.fused_head import fused_head
from ..ops.fused_head_nopf import fused_head_nopf
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

    def cosine_maps(self, features: torch.Tensor) -> torch.Tensor:
        """functional_UnitConv2D (ref pipnet/pipnet.py:34-41): cosine
        similarity (B, H, W, P) of each patch's features with each
        prototype's add-on column, the normalised kernel detached (no
        gradient reaches it), in the features' dtype.  A plain product: the
        JAX package computes it outside its Pallas kernel too."""
        k = self.add_on_kernel.to(features.dtype)
        kn = (k / (torch.linalg.vector_norm(k, dim=0, keepdim=True) + 1e-12)).detach()
        fn = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + 1e-12)
        return fn @ kn

    def effective_cls_weight(self) -> torch.Tensor:
        """relu(W) under the static block mask — the weights the classifier
        actually applies."""
        w = self.cls_weight
        if self.cfg.classifier == "nonneg":
            w = torch.relu(w)
        return w * self.cls_mask

    def forward(self, features: torch.Tensor, *, inference: bool = False,
                apply_overspecificity_mask: bool = False,
                keep: Optional[torch.Tensor] = None,
                fuse_align_pf: bool = False) -> Dict[str, torch.Tensor]:
        """features (B, H, W, D) -> {'proto_features', 'pooled', 'logits'};
        with ``fuse_align_pf`` (B = two stacked views) -> {'pooled',
        'logits', 'align_pf_logsum' (B/2, N)}, pf never materialised.
        ``apply_overspecificity_mask`` needs ``keep`` (P,), the hard-Gumbel
        presence sample (``models/pipnet.py::presence_keep``)."""
        if apply_overspecificity_mask and keep is None:
            raise ValueError("apply_overspecificity_mask requires keep")
        if not apply_overspecificity_mask:
            keep = None
        cfg = self.cfg
        if cfg.sg_before_protos:
            features = features.detach()
        kernel = self.add_on_kernel.to(features.dtype)
        if fuse_align_pf:
            pooled, logsum = fused_head_nopf(features, kernel, self.tree,
                                             tau=cfg.softmax_tau, eps=ALIGN_EPS)
            pooled, logits = self.classify(pooled.to(features.dtype), inference=inference,
                                           keep=keep)
            return {"pooled": pooled, "logits": logits, "align_pf_logsum": logsum}
        pf, pooled = fused_head(features, kernel, self.tree, tau=cfg.softmax_tau)
        # cast before the threshold, as the JAX head does (heads.py:199-201)
        pooled, logits = self.classify(pooled.to(features.dtype), inference=inference,
                                       keep=keep)
        return {"proto_features": pf, "pooled": pooled, "logits": logits}

    def classify(self, pooled: torch.Tensor, *, inference: bool = False,
                 keep: Optional[torch.Tensor] = None):
        """pooled (B, P) in the compute dtype -> (pooled after the presence
        mask ``keep`` (P,) and the inference threshold, logits (B, C))."""
        cfg = self.cfg
        if keep is not None:
            pooled = pooled * keep.to(pooled.dtype)[None, :]
        if inference:
            pooled = torch.where(pooled < cfg.inference_threshold,
                                 torch.zeros_like(pooled), pooled)
        logits = pooled @ self.effective_cls_weight().to(pooled.dtype).T
        if cfg.classifier_bias:
            logits = logits + self.cls_bias.to(pooled.dtype)
        return pooled, logits
