"""The train step.

Counterpart of the JAX package's ``train/step.py`` (itself the reference's
hot loop, ``pipnet/train.py:202-369``): forward on the concatenated two-view
batch, the loss catalog, gradients, clipping and the masked AdamW update of
both optimizers' groups.  PyTorch runs it eagerly; parameters and Adam
state are updated in place.

What the JAX step expresses with ``stop_gradient`` on the groups that do
not train in a phase becomes ``requires_grad_(False)`` on those parameters,
so autograd builds no backward for them (with the stem and stages 0-1
frozen, the backward stops at ``down2``).  Metrics stay on the card: they
add into the caller's ``acc`` dict without a host sync.

A uint8 batch (one shared view a sample, ``xs2`` None) is augmented on the
device first, as the JAX step does: its spatial size picks the route
(larger than ``image_size + 4``: the resized base, through transform1 and
transform2; otherwise the host's geometric view, through transform2 only),
with draws from the ``TrainState``'s generator.  The mesh, BYOL and the
no-pf head (K2), which no cell runs, are not held.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import RunConfig
from ..losses import LossWeights, compute_total_loss, make_tree_consts
from ..losses.catalog import label_rows
from ..models.pipnet import PIPNet, joint_leaf_log_distribution
from ..ops.device_augment import ViewDraws, op_counts, sample_view, two_view_transform2
from ..ops.device_geometric import GeometricDraws, sample_transform1, transform1_batch
from ..tree.compile import TreeArrays
from .optimizer import (AdamState, Phase, adam_init, adam_update, clip_gradients,
                        cosine_annealing, cosine_warm_restarts, group_trainable,
                        label_params, masks_and_lrs)

Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """The model's parameters (the module's own tensors, updated in
    place), the Adam state and the generator that the device augmentation,
    stochastic depth and the presence Gumbel noise draw from."""
    params: Dict[str, torch.nn.Parameter]
    opt: AdamState
    generator: torch.Generator = field(repr=False)


@dataclass(frozen=True)
class StepStatics:
    """Configuration of one phase's step that does not change from step to
    step (the JAX package's compile-time statics)."""
    phase: Phase
    mask_prune_active: bool = False
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


def sample_augment(batch: int, size: int, image_size: int, generator: torch.Generator,
                   cars: bool = False) -> AugmentDraws:
    """Draws for ``batch`` uint8 images of ``size``^2 (through transform1
    to ``image_size + 4`` when ``size`` is larger, then two views of
    transform2 at ``image_size``), with the views' op counts read on the
    host.  On a card the draws are made on a high-priority stream of their
    own, so that reading the counts waits for those few kernels only, not
    for the work queued before them (the previous step): the host stays
    ahead of the card."""
    if size < image_size:
        raise ValueError(f"uint8 input of {size}^2 is smaller than the image size "
                         f"{image_size}")
    dev = generator.device
    if dev.type != "cuda":
        draws = _draw(batch, size, image_size, generator, cars)
        draws.op_counts = op_counts(draws.views, cars).tolist()
        return draws
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev, priority=-1)
    with torch.cuda.stream(side):
        draws = _draw(batch, size, image_size, generator, cars)
        counts = op_counts(draws.views, cars)
        host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    main.wait_stream(side)
    for t in draws.tensors():
        t.record_stream(main)       # made on the side stream, used on this one
    draws.op_counts = host.tolist()
    return draws


def _draw(batch: int, size: int, image_size: int, generator: torch.Generator,
          cars: bool) -> AugmentDraws:
    geometric = None
    if size > image_size + 4:
        geometric = sample_transform1(batch, size, generator)
        size = image_size + 4
    views = tuple(sample_view(batch, size, image_size, generator, cars) for _ in range(2))
    return AugmentDraws(geometric, views)


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
    first) and a generator on the model's device seeded with ``seed``."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(params=params, opt=adam_init(params), generator=gen)


def make_train_step(model: PIPNet, tree: TreeArrays, cfg: RunConfig,
                    statics: StepStatics) -> Callable:
    """The step function of one phase:
    ``step(state, xs1, xs2, ys, scalars, acc=None) -> (state, metrics)``.

    ``xs1``/``xs2`` are the two views (B, S, S, 3) float, or ``xs1`` is one
    uint8 batch (the resized base or the host's geometric view) and ``xs2``
    None, augmented on the device (``augment_views``); ``ys`` (B,) the fine
    labels."""
    lcfg, ocfg, ph = cfg.train.loss, cfg.train.optim, statics.phase
    head = model.head
    device = head.add_on_kernel.device
    tc = make_tree_consts(tree, device)
    names = [n for n, _ in model.named_parameters()]
    labels = label_params(names, cfg.model.backbone)
    trainable = {n: group_trainable(labels[n], ph) for n in names}
    eff_lcfg = dataclasses.replace(lcfg, mask_prune_overspecific=statics.mask_prune_active,
                                   mask_prune_start_epoch=0)
    weights_cl = 0.0 if ph.pretrain else lcfg.cl_weight

    def step(state: TrainState, xs1: torch.Tensor, xs2: torch.Tensor, ys: torch.Tensor,
             scalars: Scalars, acc: Optional[Metrics] = None) -> Tuple[TrainState, Metrics]:
        if xs1.dtype == torch.uint8:
            if xs2 is not None:
                raise ValueError("a uint8 batch is one shared view a sample: pass xs2=None")
            S, cars = cfg.model.image_size, cfg.train.device_augment_cars
            draws = sample_augment(xs1.shape[0], xs1.shape[1], S, state.generator, cars)
            xs1, xs2 = augment_views(xs1, S, draws, cars)
        xs = torch.cat([xs1, xs2], dim=0)
        ys2 = torch.cat([ys, ys], dim=0)
        for n, p in state.params.items():
            p.requires_grad_(trainable[n])
            p.grad = None

        out = model(xs, train=True, generator=state.generator)
        weights = LossWeights(align_pf=scalars.align_pf_weight,
                              byol=0.5 if ph.pretrain else 2.0,
                              tanh=scalars.tanh_weight, cl=weights_cl,
                              ood=0.0 if ph.pretrain else 0.2)
        loss, aux = compute_total_loss(
            tc, out, ys2, head.effective_cls_weight(), add_on_kernel=head.add_on_kernel,
            proto_presence=head.proto_presence, multiplier=head.multiplier[0].detach(),
            cfg=eff_lcfg, weights=weights, tree=tree, pretrain=ph.pretrain,
            finetune=ph.finetune, generator=state.generator)
        loss.backward()       # .grad stays set (unclipped) until the next step
        grads = {n: p.grad for n, p in state.params.items()}

        grad_norm = None
        if ocfg.clip_grad > 0.0:
            grads, grad_norm = clip_gradients(grads, labels, ocfg.clip_grad,
                                              per_group=ocfg.clip_grad_per_group)

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
        adam_update(state.params, grads, state.opt, lrs, masks,
                    weight_decay=ocfg.weight_decay)

        with torch.no_grad():
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
