"""The train step.

Counterpart of the JAX package's ``train/step.py`` (itself the reference's
hot loop, ``pipnet/train.py:202-369``): forward on the concatenated two-view
batch, the loss catalog, gradients, clipping and the masked AdamW update of
both optimizers' groups.  PyTorch runs it eagerly; parameters and Adam
state are updated in place.

What the JAX step expresses with ``stop_gradient`` on the groups that do
not train in a phase becomes ``requires_grad_(False)`` on those parameters,
so autograd builds no backward for them (with the stem and stages 0-1
frozen, the backward stops at ``down2``).  BatchNorm layers normalise with
the batch's statistics in every train forward and update their running
ones, in frozen groups too, as the JAX step's ``mutable=["batch_stats"]``
does.  Metrics stay on the card: they add into the caller's ``acc`` dict
without a host sync.

With BYOL (``use_byol`` and the ``byol`` loss), the EMA target's
projection of the batch is computed first, in inference mode with the
online model's running statistics as they stand, then the online forward;
the target moves towards the updated parameters after the Adam step.

A uint8 batch (one shared view a sample, ``xs2`` None) is augmented on the
device first, as the JAX step does: its spatial size picks the route
(larger than ``image_size + 4``: the resized base, through transform1 and
transform2; otherwise the host's geometric view, through transform2 only),
with draws from the ``TrainState``'s generator.

On a mesh (``runtime/mesh.py``) each rank takes its rows of the global
batch and the step keeps the one-process step's numbers: every draw is
made for the whole batch (each rank keeps its rows), the losses and
metrics are computed on every rank from the gathered outputs they read
(align_pf from each rank's per-row log sums, not from the maps; the
feature losses from each rank's sums over its own patch rows, the
uniformity's pairs those of its rows against every rank's),
BatchNorm normalises with the whole batch's statistics, and one
all-reduce sums the gradients before clipping and AdamW.  With ZeRO-1
each rank updates its part of the parameters from its part of the Adam
moments and the parts are all-gathered.

On a model axis (``--model_parallel``) the head holds its rank's columns
of P (``PrototypeHead.shard_columns``) and runs the composed operations on
them (K1, K1b and K2 do not run: the JAX package refuses its fused head
there); the model ranks of a data rank take the same rows.  The losses
read pooled, the effective classifier, the add-on kernel and the presence
logits gathered whole over the model ranks (each rank's gradient its own
columns), align_pf the ranks' per-node log sums; the gradient norm sums
the split leaves' squares over the model ranks; ZeRO-1 splits the other
leaves' moments over the data ranks, a head leaf's moments keep its
model split.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import RunConfig
from ..losses import LossWeights, compute_total_loss, make_tree_consts
from ..losses.catalog import ALIGN_EPS, align_pf_row_logsum, label_rows
from ..models.byol import byol_tau_schedule, ema_update, init_byol_state
from ..models.pipnet import PIPNet, joint_leaf_log_distribution, masked_decode_degenerates
from ..ops.device_augment import ViewDraws, op_counts, sample_view, two_view_transform2
from ..ops.device_geometric import GeometricDraws, sample_transform1, transform1_batch
from ..runtime.mesh import (PROTO_AXIS_PARAMS, BatchShard, Mesh, on_axis, split_of,
                            state_shardings, whole_of)
from ..runtime.profiling import span
from ..tree.compile import TreeArrays
from .optimizer import (AdamState, Phase, adam_init, adam_update, clip_gradients,
                        cosine_annealing, cosine_warm_restarts, group_trainable,
                        label_params, masks_and_lrs)

Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The model's parameters and buffers (the module's own tensors,
    updated in place: the buffers are BatchNorm's running statistics), the
    Adam state, the generator that the device augmentation, stochastic
    depth and the presence Gumbel noise draw from, and BYOL's EMA target
    (``backbone.*`` and ``projector.*`` tensors; empty without BYOL)."""
    params: Dict[str, torch.nn.Parameter]
    opt: AdamState
    generator: torch.Generator = field(repr=False)
    buffers: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)
    byol: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False)


@dataclass(frozen=True)
class StepStatics:
    """Configuration of one phase's step that does not change from step to
    step (the JAX package's compile-time statics)."""
    phase: Phase
    mask_prune_active: bool = False
    has_ood: bool = False
    eta_min_net: float = 0.0
    t0_cls: float = 5.0
    weight_reactivation: bool = False
    # OptimConfig.unfreeze_warmup_epochs on the net_t step axis: the
    # backbone group's lr ramps from 0 at backbone_warmup_t0 to the schedule
    # over backbone_warmup_steps steps; 0 steps = off
    backbone_warmup_t0: float = 0.0
    backbone_warmup_steps: float = 0.0


@dataclass(frozen=True)
class Scalars:
    """Per-step scalars, plain Python floats."""
    net_t: float              # net scheduler step
    net_T: float              # net scheduler horizon
    epoch_frac: float         # classifier fractional epoch (warm restarts)
    align_pf_weight: float    # pretrain ramp epoch/nr_epochs, or 5.0
    tanh_weight: float


@dataclass
class AugmentDraws:
    """The device augmentation's draws for one uint8 batch: transform1's
    (None when the batch is the host's geometric view), each view's
    transform2, and the views' op counts on the host (read with the draws;
    None: read when the views are made)."""
    geometric: Optional[GeometricDraws]
    views: Tuple[ViewDraws, ViewDraws]
    op_counts: Optional[List[List[int]]] = None

    def tensors(self) -> List[torch.Tensor]:
        parts = ([self.geometric] if self.geometric is not None else []) + list(self.views)
        return [getattr(p, f.name) for p in parts for f in dataclasses.fields(p)]

    def take(self, shard: BatchShard) -> "AugmentDraws":
        """This rank's rows of the whole batch's draws (op counts unread)."""
        def local(p):
            return type(p)(*(shard.local(getattr(p, f.name)) for f in dataclasses.fields(p)))
        return AugmentDraws(None if self.geometric is None else local(self.geometric),
                            tuple(local(v) for v in self.views))


def sample_augment(batch: int, size: int, image_size: int, generator: torch.Generator,
                   cars: bool = False, shard: Optional[BatchShard] = None) -> AugmentDraws:
    """Draws for ``batch`` uint8 images of ``size``^2 (through transform1
    to ``image_size + 4`` when ``size`` is larger, then two views of
    transform2 at ``image_size``), with the views' op counts read on the
    host.  With ``shard`` (one view), ``batch`` is the whole batch of a
    mesh and the draws and counts are this rank's rows'.  On a card the
    draws are made on a high-priority stream of their own, so that reading
    the counts waits for those few kernels only, not for the work queued
    before them (the previous step): the host stays ahead of the card."""
    if size < image_size:
        raise ValueError(f"uint8 input of {size}^2 is smaller than the image size "
                         f"{image_size}")
    dev = generator.device
    if dev.type != "cuda":
        draws = _draw(batch, size, image_size, generator, cars, shard)
        draws.op_counts = op_counts(draws.views, cars).tolist()
        return draws
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev, priority=-1)
    with torch.cuda.stream(side):
        draws = _draw(batch, size, image_size, generator, cars, shard)
        counts = op_counts(draws.views, cars)
        host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    with span("augment.wait"):
        done.synchronize()
    main.wait_stream(side)
    for t in draws.tensors():
        t.record_stream(main)       # made on the side stream, used on this one
    draws.op_counts = host.tolist()
    return draws


def _draw(batch: int, size: int, image_size: int, generator: torch.Generator,
          cars: bool, shard: Optional[BatchShard] = None) -> AugmentDraws:
    geometric = None
    if size > image_size + 4:
        geometric = sample_transform1(batch, size, generator)
        size = image_size + 4
    views = tuple(sample_view(batch, size, image_size, generator, cars) for _ in range(2))
    draws = AugmentDraws(geometric, views)
    return draws if shard is None else draws.take(shard)


def augment_views(x_u8: torch.Tensor, image_size: int, draws: AugmentDraws,
                  cars: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two normalized f32 views of a uint8 batch on its device."""
    shared = x_u8
    if draws.geometric is not None:
        shared = transform1_batch(x_u8, draws.geometric, image_size + 4)
    return two_view_transform2(shared, image_size, draws.views, cars=cars,
                               counts=draws.op_counts)


def init_train_state(model: PIPNet, seed: int = 0) -> TrainState:
    """Adam state for the model's parameters (as they stand: load them
    first), a generator on the model's device seeded with ``seed``, and
    under BYOL the EMA target as a copy of the backbone and projector."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    buffers = {n: t for n, t in model.state_dict(keep_vars=True).items() if n not in params}
    return TrainState(params=params, opt=adam_init(params), generator=gen, buffers=buffers,
                      byol=init_byol_state(model) if model.cfg.use_byol else {})


def reinit_optimizer(state: TrainState) -> TrainState:
    """Fresh Adam state at the phase-1 -> phase-2 boundary (main.py:501)."""
    return dataclasses.replace(state, opt=adam_init(state.params))


def make_train_step(model: PIPNet, tree: TreeArrays, cfg: RunConfig,
                    statics: StepStatics, *, fuse_align_pf: bool = False,
                    mesh: Optional[Mesh] = None, zero1: bool = False) -> Callable:
    """The step function of one phase:
    ``step(state, xs1, xs2, ys, scalars, acc=None, presence_noise=None,
    augment_draws=None) -> (state, metrics)``.

    ``xs1``/``xs2`` are the two views (B, S, S, 3) float, or ``xs1`` is one
    uint8 batch (the resized base or the host's geometric view) and ``xs2``
    None, augmented on the device (``augment_views``); ``ys`` (B,) the fine
    labels, -1 for OOD rows (``statics.has_ood``: the OOD BCE loss adds in
    outside pretraining; the loss tables map -1 to their sentinel row).
    ``fuse_align_pf`` runs the head through K2 (align_pf reduced in-kernel,
    pf never materialised); it needs align_pf on, the reference
    ``align_eps`` (None), a phase that is not a finetune phase and the
    fused head (``models/heads.py::head_supports_fusion``), and raises
    otherwise.  ``presence_noise`` (P, 2), when given, replaces
    the step's draw of the presence Gumbel noise (tests hand both packages
    the same sample); ``augment_draws``, likewise, replaces the draws of
    the device augmentation.

    ``mesh`` (``runtime/mesh.py``): ``xs1``, ``xs2`` and ``ys`` are this
    rank's rows of the global batch (``shard_batch``, over the data axis),
    every rank's the same count; ``augment_draws`` are the whole batch's.
    With a model axis the head holds this rank's columns
    (``PrototypeHead.shard_columns``, before ``init_train_state``).  The
    metrics and the updated parameters (a head leaf's columns on a model
    rank) are the one-process step's on every rank.  ``zero1`` (with more
    than one data rank): ``state.opt`` holds this rank's parts of the
    moments (``split_moments``)."""
    lcfg, ocfg, ph = cfg.train.loss, cfg.train.optim, statics.phase
    if fuse_align_pf:
        why = [reason for reason, bad in (
            ("align_pf is off", not lcfg.align_pf),
            (f"align_eps={lcfg.align_eps} is set (K2 takes the reference 1e-12)",
             lcfg.align_eps is not None),
            (f"phase {ph.name!r} computes no align_pf", ph.finetune),
            ("the head is a variant that K2 does not compute",
             not model.head.fused),
            ("a model rank's head runs the composed operations",
             model.head.columns is not None)) if bad]
        if why:
            raise ValueError(f"fuse_align_pf=True cannot apply: {'; '.join(why)}")

    columns = model.head.columns
    if (mesh is not None and mesh.n_model > 1) != (columns is not None):
        raise ValueError("a train step on a model axis takes the head split over it "
                         "(model.head.shard_columns(mesh)), and a split head that mesh")
    rows = views1 = None
    if mesh is not None:
        rows, views1 = BatchShard(mesh, views=2), BatchShard(mesh, views=1)
    zero1 = zero1 and mesh is not None and mesh.n_data > 1
    apf_active = not ph.finetune and lcfg.align_pf
    apf_eps = lcfg.align_eps if lcfg.align_eps is not None else ALIGN_EPS
    head = model.head
    device = head.add_on_kernel.device
    tc = make_tree_consts(tree, device)
    names = [n for n, _ in model.named_parameters()]
    labels = label_params(names, cfg.model.backbone)
    # the leaves whose gradients are a model rank's columns
    split = {n for n in names if n in PROTO_AXIS_PARAMS} if columns is not None else set()
    trainable = {n: group_trainable(labels[n], ph) for n in names}
    eff_lcfg = dataclasses.replace(lcfg, mask_prune_overspecific=statics.mask_prune_active,
                                   mask_prune_start_epoch=0)
    weights_cl = 0.0 if ph.pretrain else lcfg.cl_weight
    byol_active = lcfg.byol and model.cfg.use_byol and not ph.finetune

    def step(state: TrainState, xs1: torch.Tensor, xs2: torch.Tensor, ys: torch.Tensor,
             scalars: Scalars, acc: Optional[Metrics] = None,
             presence_noise: Optional[torch.Tensor] = None,
             augment_draws: Optional[AugmentDraws] = None) -> Tuple[TrainState, Metrics]:
        # the body inside the span, not a wrapper around the step: a wrapper's
        # frame would hold the uint8 batch until the step ends
        with span("step"):
            if xs1.dtype == torch.uint8:
                if xs2 is not None:
                    raise ValueError("a uint8 batch is one shared view a sample: pass xs2=None")
                S, cars = cfg.model.image_size, cfg.train.device_augment_cars
                with span("augment"):
                    if augment_draws is not None:
                        draws = augment_draws if mesh is None else augment_draws.take(views1)
                    else:
                        n = xs1.shape[0] if mesh is None else views1.global_rows(xs1.shape[0])
                        draws = sample_augment(n, xs1.shape[1], S, state.generator, cars, views1)
                    xs1, xs2 = augment_views(xs1, S, draws, cars)
            xs = torch.cat([xs1, xs2], dim=0)
            ys2 = torch.cat([ys, ys], dim=0)
            for n, p in state.params.items():
                p.requires_grad_(trainable[n])
                p.grad = None

            byol_target = model.byol_target_projection(xs, state.byol) if byol_active else None
            out = model(xs, train=True, generator=state.generator, fuse_align_pf=fuse_align_pf,
                        with_byol=byol_active, shard=rows)
            weights = LossWeights(align_pf=scalars.align_pf_weight,
                                  byol=0.5 if ph.pretrain else 2.0,
                                  tanh=scalars.tanh_weight, cl=weights_cl,
                                  ood=0.0 if ph.pretrain else 0.2)
            w_eff, kernel, presence = head.effective_cls_weight(), head.add_on_kernel, \
                head.proto_presence
            if mesh is not None:
                out = global_outputs(out)
                ys2 = rows.gather(ys2)
                if byol_target is not None:
                    byol_target = rows.gather(byol_target)
                if columns is not None:
                    w_eff, kernel = mesh.gather_columns(w_eff, 1), mesh.gather_columns(kernel, 1)
                    presence = mesh.gather_columns(presence, 0)
                w_eff, kernel, presence = mesh.once(w_eff), mesh.once(kernel), mesh.once(presence)
            with span("losses"):
                loss, aux = compute_total_loss(
                    tc, out, ys2, w_eff, add_on_kernel=kernel, proto_presence=presence,
                    multiplier=head.multiplier[0].detach(), cfg=eff_lcfg, weights=weights,
                    tree=tree, pretrain=ph.pretrain, finetune=ph.finetune,
                    ood_present=statics.has_ood, generator=state.generator,
                    presence_noise=presence_noise, byol_online=out.get("byol_online"),
                    byol_target=byol_target, shard=rows)
            with span("backward"):
                loss.backward()       # .grad stays set (unclipped) until the next step
            if mesh is not None:
                mesh.all_reduce_grads(state.params)
            grads = {n: p.grad for n, p in state.params.items()}

            grad_norm = None
            if ocfg.clip_grad > 0.0:
                with span("clip"):
                    grads, grad_norm = clip_gradients(grads, labels, ocfg.clip_grad,
                                                      per_group=ocfg.clip_grad_per_group,
                                                      split=split, mesh=mesh)

            def net_lr(base):
                return cosine_annealing(base, statics.eta_min_net, scalars.net_t, scalars.net_T)

            def cls_lr(base):
                return cosine_warm_restarts(base, 1e-3, scalars.epoch_frac, statics.t0_cls)

            backbone_lr = None
            if statics.backbone_warmup_steps > 0:
                ramp = min(max((scalars.net_t - statics.backbone_warmup_t0)
                               / statics.backbone_warmup_steps, 0.0), 1.0)
                backbone_lr = lambda base: net_lr(base) * ramp  # noqa: E731
            masks, lrs = masks_and_lrs(labels, ph, ocfg, net_lr, cls_lr, backbone_lr)
            with span("adamw"):
                if zero1:
                    zero1_update(state, grads, lrs, masks)
                else:
                    adam_update(state.params, grads, state.opt, lrs, masks,
                                weight_decay=ocfg.weight_decay)
                if byol_active:
                    ema_update(state.byol, state.params,
                               byol_tau_schedule(scalars.net_t, scalars.net_T, lcfg.byol_tau_base,
                                                 lcfg.byol_tau_max))

            with torch.no_grad(), span("metrics"):
                if statics.weight_reactivation and not ph.pretrain:
                    # the intended +0.01 to classifier weights <= 1e-3; a no-op in
                    # the reference through its name-matching bug (train.py:67-71)
                    w = head.cls_weight
                    w.copy_(torch.where(w <= 1e-3, w + 0.01, w))
                metrics = _metrics(tc, tree, out["logits"].detach(), ys2)
                metrics["loss"] = loss.detach()
                if grad_norm is not None:
                    metrics["grad_norm"] = grad_norm           # pre-clip
                for k, v in aux.items():
                    metrics[f"loss/{k}" if v.dim() == 0 else f"per_node/{k}"] = v.detach()
                if acc is not None:
                    metrics = {k: acc[k] + m.to(acc[k].dtype) for k, m in metrics.items()}
            return state, metrics

    def global_outputs(out: Metrics) -> Metrics:
        """The whole batch's outputs that the losses read, gathered from
        every rank's rows (and pooled from every model rank's columns):
        align_pf as each row's log sums (the maps stay on their rank); the
        features stay the rank's own rows (the feature losses add the
        ranks' sums, ``compute_total_loss``'s ``shard``)."""
        if columns is not None:
            out = dict(out, pooled=mesh.gather_columns(out["pooled"], 1))
        g = {k: rows.gather(out[k]) for k in ("pooled", "logits", "byol_online") if k in out}
        g["features"] = out["features"]
        if apf_active:
            logsum = (out["align_pf_logsum"] if "align_pf_logsum" in out
                      else align_pf_row_logsum(tc, out["proto_features"], apf_eps, columns))
            g["align_pf_logsum"] = views1.gather(logsum)
        return g

    def zero1_update(state: TrainState, grads, lrs, masks) -> None:
        """AdamW on this rank's parts of the parameters (views) from its
        parts of the moments, then each updated parameter all-gathered over
        the data ranks (a head leaf on a model axis is already the rank's
        columns, its moments too: it updates whole)."""
        specs = on_axis(state_shardings(mesh, state, zero1=True), "data")["mu"]
        parts = {n: split_of(mesh, p.detach(), specs[n]) for n, p in state.params.items()}
        gparts = {n: None if g is None else split_of(mesh, g, specs[n]) for n, g in grads.items()}
        adam_update(parts, gparts, state.opt, lrs, masks, weight_decay=ocfg.weight_decay)
        with torch.no_grad():
            for n, spec in specs.items():
                if spec is not None and masks[n]:
                    state.params[n].copy_(whole_of(mesh, parts[n], spec))

    return step


def make_eval_step(model: PIPNet, tree: TreeArrays, *, path_prob_softmax_tau: float = 1.0,
                   apply_overspecificity_mask: bool = False,
                   leave_out_idx=None) -> Callable[..., Metrics]:
    """The eval step (the JAX package's ``make_eval_step``, ref test_pipnet):
    ``step(xs, keep=None) -> {'logits', 'pooled', 'log_joint', 'pred'}``
    for the B images ``xs`` (B, S, S, 3), without gradients.  The batch is
    duplicated to mirror the training shape (ref pipnet/train.py:644-645),
    so the head runs at 2B rows; inference thresholding is on; the joint
    leaf distribution decodes the first B rows with the path softmax
    temperature ``path_prob_softmax_tau``.

    ``leave_out_idx``: left-out class indices, the reference's LOU decode
    short-circuit (ref util/node.py:319-326, pipnet/train.py:713).

    ``apply_overspecificity_mask``: ``keep`` (P,) (required) masks pooled
    in the head, and the decode falls back to leaf-count priors at every
    node where some child class's masked classifier row keeps no weight
    > 1e-3 (ref util/node.py:336-361), judged from the same ``keep``
    (``models/pipnet.py::masked_decode_degenerates``)."""

    @torch.no_grad()
    def step(xs: torch.Tensor, keep: Optional[torch.Tensor] = None) -> Metrics:
        B = xs.shape[0]
        out = model(torch.cat([xs, xs], dim=0), train=False, inference=True,
                    apply_overspecificity_mask=apply_overspecificity_mask, keep=keep)
        logits = out["logits"][:B]
        degenerate = (masked_decode_degenerates(model, tree, keep)
                      if apply_overspecificity_mask else None)
        logp = joint_leaf_log_distribution(logits, tree, softmax_tau=path_prob_softmax_tau,
                                           degenerate_nodes=degenerate,
                                           leave_out_idx=leave_out_idx)
        return {"logits": logits, "pooled": out["pooled"][:B], "log_joint": logp,
                "pred": logp.argmax(dim=-1)}

    return step


def _metrics(tc, tree: TreeArrays, logits: torch.Tensor, ys: torch.Tensor) -> Metrics:
    """Fine accuracy through the joint leaf distribution
    (pipnet/train.py:363-369) and per-node accuracy (1186-1194)."""
    pred = joint_leaf_log_distribution(logits, tree).argmax(dim=-1)
    valid = ys >= 0
    B = logits.shape[0]
    node_logits = logits[:, tc.node_cols.reshape(-1)].reshape(B, *tc.node_cols.shape)
    node_logits = torch.where(tc.node_cols_valid[None], node_logits,
                              torch.full_like(node_logits, float("-inf")))
    node_pred = node_logits.argmax(dim=-1)                            # (B, N)
    slot = tc.leaf_slot[label_rows(ys, tc.num_leaves)]
    under = slot >= 0
    return {"fine_correct": ((pred == ys) & valid).sum(), "n_fine": valid.sum(),
            "node_correct": ((node_pred == slot) & under).sum(dim=0),
            "node_examples": under.sum(dim=0)}
