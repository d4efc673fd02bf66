"""The stacked prototype head, over the fused head kernels K1 and K2.

  features (B,H,W,D) --K1: matmul, per-node softmax, max-pool--> pf (B,H,W,P),
  pooled (B,P) --threshold--> --block-masked non-neg linear--> logits (B,C)

Counterpart of the JAX package's ``PrototypeHead`` (``models/heads.py``).
The flagship's head (conv add-on, per-node temperature softmax, no bias,
focal or cosine term: ``head_supports_fusion``) runs K1 through
``ops/fused_head.py`` (the CUDA kernel on the card, its plain version on
the CPU; differentiable, with K1b as its backward), which computes the
per-node softmax that both of the JAX package's head paths compute.  With
``fuse_align_pf`` a two-view training batch goes through K2 instead
(``ops/fused_head_nopf.py``): pooled and align_pf's per-node log-reduction,
with pf never materialised.

Every other head (the unit, project and l2 add-ons, the add-on bias,
``softmax_tau=None``, the spatial, Gumbel and cosine-multiplied softmaxes,
focal pooling) runs the composed operations of ``ops/segment.py``, as the
JAX head runs its XLA path there: the same predicate, so K1 launches
exactly where the JAX head takes its kernel.  The add-on kernels that
those add-ons normalise or read through ``.data`` in the reference
(pipnet/pipnet.py:1069,1097-1103,1113) are detached, as the JAX package's
``stop_gradient`` does.  The Gumbel softmax (``softmax_tau=None`` with
``gumbel_softmax``) adds the Gumbel sample ``gumbel_noise`` when one is
given; no training or serving path of either package gives one, so that
head trains and serves as a plain per-node softmax at temperature 1.

The overspecificity mask (``apply_overspecificity_mask`` with a presence
sample ``keep``) multiplies pooled after the spatial max and before the
inference threshold, the JAX head's order (``models/heads.py:230-237``).
Unlike the JAX head, which leaves its Pallas kernel for the plain path when
the mask is on, the masked head stays on K1: the mask acts after the max,
so K1's pf and pooled are what the plain path computes first, and a pruned
model evaluated or served on the card runs the kernel.  In float32 the two
agree to K1's bar; in bf16 ``keep`` is cast to the pooled dtype (0 or 1
there), where the JAX head promotes pooled to float32.

On the model axis of a mesh (``shard_columns``, ``runtime/mesh.py``) a head
holds its rank's columns of the prototype-axis parameters and runs the
composed operations on them, as the JAX package runs its XLA head there
(it refuses its fused kernel on a model axis): the per-node softmax on the
column range (``ops/segment.py::ProtoColumns``), the logits as the ranks'
partial products summed, the add-on bias's unit norm over the whole of P.
``gather_columns`` makes the head whole again, on K1 where it fuses.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import HeadConfig
from ..losses.catalog import ALIGN_EPS
from ..ops.fused_head import fused_head
from ..ops.fused_head_nopf import fused_head_nopf
from ..ops.segment import ProtoColumns, segment_softmax, spatial_softmax
from ..runtime.mesh import PROTO_AXIS_PARAMS, Mesh
from ..tree.compile import TreeArrays


def head_supports_fusion(cfg: HeadConfig) -> bool:
    """Whether the head runs the fused kernels (K1, or K2 for a step that
    fuses align_pf): the conv add-on with the per-node temperature softmax
    and none of the variants, the JAX package's ``head_supports_fusion``
    (``ops/pallas_head.py:460-470``) on the configuration alone.  Its tree
    test has no counterpart here: the port's kernels take every tree."""
    return (cfg.add_on_type == "conv" and not cfg.add_on_bias
            and cfg.softmax_tau is not None and not cfg.softmax_over_channel
            and not cfg.multiply_cs_softmax and not cfg.gumbel_softmax and not cfg.focal)


def _unit_columns(k: torch.Tensor) -> torch.Tensor:
    """``k`` with each column scaled to unit norm, detached."""
    return (k / (torch.linalg.vector_norm(k, dim=0, keepdim=True) + 1e-12)).detach()


class PrototypeHead(nn.Module):
    """Stacked multi-node prototype head over compiled ``TreeArrays``.
    Parameter names and layouts are the JAX package's: ``add_on_kernel``
    (D, P), ``cls_weight`` (C, P), ``proto_presence`` (P, 2), ``multiplier``
    (1,), ``add_on_bias`` (P,) with ``add_on_bias`` and ``cls_bias`` (C,)
    with ``classifier_bias``."""

    def __init__(self, tree: TreeArrays, cfg: HeadConfig, in_channels: int):
        super().__init__()
        if cfg.add_on_type not in ("conv", "unit", "project", "l2"):
            raise ValueError(f"unknown add_on_type {cfg.add_on_type}")
        self.tree, self.cfg = tree, cfg
        self.fused = head_supports_fusion(cfg)
        P, C = tree.num_protos_padded, tree.num_children_total
        self.add_on_kernel = nn.Parameter(torch.zeros(in_channels, P))
        if cfg.add_on_bias:
            self.add_on_bias = nn.Parameter(torch.zeros(P))
        self.cls_weight = nn.Parameter(torch.zeros(C, P))
        self.proto_presence = nn.Parameter(torch.zeros(P, 2))
        self.multiplier = nn.Parameter(torch.full((1,), 2.0))
        if cfg.classifier_bias:
            self.cls_bias = nn.Parameter(torch.zeros(C))
        self.register_buffer("cls_mask", self._whole_mask(), persistent=False)
        # this model rank's columns of P (shard_columns), None when whole
        self.columns: Optional[ProtoColumns] = None

    def _whole_mask(self) -> torch.Tensor:
        """The classifier's static (C, P) block mask."""
        tree = self.tree
        return torch.as_tensor(tree.class_mask if self.cfg.protopool else tree.child_block_mask)

    def _proto_axis_params(self):
        for name, dim in PROTO_AXIS_PARAMS.items():
            p = getattr(self, name.split(".", 1)[1], None)
            if p is not None:
                yield p, dim

    def shard_columns(self, mesh: Mesh) -> None:
        """Keep this model rank's columns (``Mesh.proto_columns``) of the
        prototype-axis parameters, in place (the same ``Parameter``
        objects), and of the classifier's mask."""
        lo, hi = mesh.proto_columns(self.tree.num_protos_padded)
        for p, dim in self._proto_axis_params():
            p.data = p.data.narrow(dim, lo, hi - lo).clone()
        self.cls_mask = self.cls_mask[:, lo:hi].clone()
        self.columns = ProtoColumns(mesh, self.tree, lo, hi)

    def gather_columns(self) -> None:
        """The whole head again from every model rank's columns, in place
        (collective: every rank of the model axis calls it)."""
        mesh = self.columns.mesh
        for p, dim in self._proto_axis_params():
            p.data = mesh.all_gather(p.data, dim=dim, axis="model")
        self.cls_mask = self._whole_mask().to(self.cls_mask.device)
        self.columns = None

    def _unit_bias(self, dtype: torch.dtype) -> torch.Tensor:
        """The add-on bias scaled to unit norm (over the whole of P, on a
        model rank too), detached."""
        b = self.add_on_bias.to(dtype).detach()
        if self.columns is None:
            return b / (torch.linalg.vector_norm(b) + 1e-12)
        return b / (self.columns.mesh.model_all_reduce((b ** 2).sum()).sqrt() + 1e-12)

    def proto_maps(self, features: torch.Tensor) -> torch.Tensor:
        """The raw add-on response (B, H, W, P) before any softmax, in the
        features' dtype, for each add-on type (ref pipnet/pipnet.py:1060-1113):
        ``conv`` F K (+ bias); ``unit`` the cosine of F's rows with K's
        columns (+ the unit bias); ``project`` F against K's unit columns (+
        the unit bias); ``l2`` the log similarity log((d + 1) / (d + 1e-4))
        of the squared distance d to K's columns (ProtoPNet's)."""
        cfg = self.cfg
        k = self.add_on_kernel.to(features.dtype)
        if cfg.add_on_type == "conv":
            z = features @ k
            return z + self.add_on_bias.to(features.dtype) if cfg.add_on_bias else z
        if cfg.add_on_type == "unit":
            return self.cosine_maps(features)
        if cfg.add_on_type == "project":
            z = features @ _unit_columns(k)
            return z + self._unit_bias(features.dtype) if cfg.add_on_bias else z
        kd = k.detach()
        x2 = (features ** 2).sum(dim=-1, keepdim=True)                    # (B, H, W, 1)
        d = torch.relu(x2 - 2 * (features @ kd) + (kd ** 2).sum(dim=0))
        return torch.log((d + 1.0) / (d + 1e-4))

    def cosine_maps(self, features: torch.Tensor) -> torch.Tensor:
        """functional_UnitConv2D (ref pipnet/pipnet.py:34-41): cosine
        similarity (B, H, W, P) of each patch's features with each
        prototype's add-on column, the normalised kernel (and the add-on
        bias, scaled to unit norm, when there is one) detached: no gradient
        reaches them.  In the features' dtype; a plain product: the JAX
        package computes it outside its Pallas kernel too."""
        fn = features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + 1e-12)
        z = fn @ _unit_columns(self.add_on_kernel.to(features.dtype))
        return z + self._unit_bias(features.dtype) if self.cfg.add_on_bias else z

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
                fuse_align_pf: bool = False,
                gumbel_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """features (B, H, W, D) -> {'proto_features', 'pooled', 'logits'};
        with ``fuse_align_pf`` (B = two stacked views; the fused head only)
        -> {'pooled', 'logits', 'align_pf_logsum' (B/2, N)}, pf never
        materialised.  ``apply_overspecificity_mask`` needs ``keep`` (P,),
        the hard-Gumbel presence sample (``models/pipnet.py::presence_keep``).
        ``gumbel_noise`` (B, H, W, P), read only by the Gumbel-softmax head,
        is the sample its softmax adds.  On a model rank (``shard_columns``)
        ``keep`` and ``gumbel_noise`` are whole and the rank reads its
        columns; 'proto_features' and 'pooled' are its columns, 'logits'
        the whole sum."""
        if apply_overspecificity_mask and keep is None:
            raise ValueError("apply_overspecificity_mask requires keep")
        if not apply_overspecificity_mask:
            keep = None
        cfg = self.cfg
        if cfg.sg_before_protos:
            features = features.detach()
        if self.columns is not None:
            if fuse_align_pf:
                raise ValueError("fuse_align_pf runs K2 on the whole head; a model rank's "
                                 "columns run the composed head")
            lo, hi = self.columns.lo, self.columns.hi
            return self._composed(self.columns.mesh.to_model(features), inference,
                                  None if keep is None else keep[lo:hi],
                                  None if gumbel_noise is None else gumbel_noise[..., lo:hi])
        if not self.fused:
            if fuse_align_pf:
                raise ValueError("fuse_align_pf runs K2, which computes the conv add-on's "
                                 "per-node softmax only; this head is a variant")
            return self._composed(features, inference, keep, gumbel_noise)
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

    def _composed(self, features: torch.Tensor, inference: bool,
                  keep: Optional[torch.Tensor],
                  gumbel_noise: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A variant head, or a model rank's columns of any head, as the JAX
        head's XLA path computes it (``models/heads.py:209-244``)."""
        cfg = self.cfg
        z = self.proto_maps(features)
        if cfg.add_on_type == "unit":
            z = z.abs()                                      # ref pipnet/pipnet.py:127-128
        if cfg.softmax_tau is not None:
            pf = (spatial_softmax(z) if cfg.softmax_over_channel
                  else segment_softmax(z, self.tree, tau=cfg.softmax_tau, columns=self.columns))
        elif cfg.gumbel_softmax:
            pf = segment_softmax(z, self.tree, noise=gumbel_noise, gumbel_tau=cfg.gumbel_tau,
                                 columns=self.columns)
        else:
            pf = z
        if cfg.multiply_cs_softmax:
            pf = self.cosine_maps(features) * pf             # ref pipnet/pipnet.py:154-157
        pooled = pf.amax(dim=(1, 2))                         # AdaptiveMaxPool2d
        if cfg.focal:
            pooled = pooled - pf.mean(dim=(1, 2))            # ref pipnet/pipnet.py:161-162
        pooled, logits = self.classify(pooled, inference=inference, keep=keep)
        return {"proto_features": pf, "pooled": pooled, "logits": logits}

    def classify(self, pooled: torch.Tensor, *, inference: bool = False,
                 keep: Optional[torch.Tensor] = None):
        """pooled (B, P) in the compute dtype -> (pooled after the presence
        mask ``keep`` (P,) and the inference threshold, logits (B, C)); on
        a model rank pooled and ``keep`` are its columns and the logits the
        ranks' partial products summed."""
        cfg = self.cfg
        if keep is not None:
            pooled = pooled * keep.to(pooled.dtype)[None, :]
        if inference:
            pooled = torch.where(pooled < cfg.inference_threshold,
                                 torch.zeros_like(pooled), pooled)
        logits = pooled @ self.effective_cls_weight().to(pooled.dtype).T
        if self.columns is not None:
            logits = self.columns.mesh.model_sum(logits)
        if cfg.classifier_bias:
            logits = logits + self.cls_bias.to(pooled.dtype)
        return pooled, logits
