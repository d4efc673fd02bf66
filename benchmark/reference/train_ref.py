"""The reference's first training steps: the frozen plain path in float32
(TF32 off), from the same seeded weights, images, labels and step seed as
the program, through the joint phase's settings that ``joint_settings``
works out from the configuration as the port's Trainer does.

What it returns is what the check compares: each step's loss, the norm of
each leaf's first gradient as AdamW got it (its first moment after one
step, over 1 - beta1) and the norm of each leaf's change after the steps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .. import seeded
from .model import build, merged_run_config, run_config, state_shapes
from .pipnet_ref.device import host_to_device
from .pipnet_ref.train.optimizer import phase_for_epoch
from .pipnet_ref.train.step import Scalars, StepStatics, init_train_state, make_train_step
from .precision import lower_products

ADAM_B1 = 0.9


def joint_settings(cfg, epoch: int, iters: int) -> Tuple[StepStatics, callable]:
    """The step's statics and its scalars by step index at ``epoch`` of the
    train phase, with ``iters`` steps an epoch, as the port's
    ``Trainer.run_epoch`` sets them."""
    t = cfg.train
    phase = phase_for_epoch(epoch, t, pretrain=False)
    warm_t0 = warm_steps = 0.0
    if t.optim.unfreeze_warmup_epochs > 0:
        warm_t0 = float(t.freeze_epochs * iters)
        warm_steps = float(t.optim.unfreeze_warmup_epochs * iters)
    statics = StepStatics(
        phase=phase,
        mask_prune_active=t.loss.mask_prune_overspecific and epoch >= t.loss.mask_prune_start_epoch,
        eta_min_net=t.optim.lr_net / 100.0, t0_cls=5.0 if t.epochs <= 30 else 10.0,
        weight_reactivation=t.weight_reactivation == "on",
        backbone_warmup_t0=warm_t0, backbone_warmup_steps=warm_steps)

    def scalars(i: int) -> Scalars:
        i = i % iters
        return Scalars(net_t=float((epoch - 1) * iters + i), net_T=float(max(t.epochs * iters, 1)),
                       epoch_frac=(epoch - 1) + i / iters, align_pf_weight=5.0, tanh_weight=2.0)
    return statics, scalars


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and cuDNN convolutions."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's 2-norm, taken in float64, read in one transfer."""
    names = sorted(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names])
    return dict(zip(names, norms.tolist()))


def reference_steps(config: Mapping, changes: Mapping, seed: int, epoch: int, iters: int,
                    batches: Sequence[Tuple[torch.Tensor, np.ndarray]], device,
                    precision: str = "float32") -> Dict:
    """Run the reference's steps on ``batches`` (uint8 bases on ``device``
    and their labels).  ``precision`` "float32" is the reference; "float8"
    or "int8" a control: bfloat16 with every product lowered
    (``precision.py``)."""
    d = merged_run_config(config, changes)
    cfg = run_config(d, "float32" if precision == "float32" else "bfloat16")
    shapes, tree = state_shapes(config, cfg)
    weights = seeded.seeded_state_dict(shapes, tree, seed, device, config["add_on_scale"])
    model, tree = build(config, cfg, weights, device)
    statics, scalars = joint_settings(cfg, epoch, iters)
    step = make_train_step(model, tree, cfg, statics)
    state = init_train_state(model, seed=seeded.stream_seed(seed, seeded.STEP))
    losses: List[float] = []
    grads = None
    lower = (lower_products(precision) if precision != "float32"
             else contextlib.nullcontext())
    with exact_float32(), lower:
        for i, (x, ys) in enumerate(batches):
            state, m = step(state, x, None, host_to_device(ys, device), scalars(i))
            losses.append(m["loss"])
            if i == 0:
                grads = leaf_norms({n: mu / (1.0 - ADAM_B1) for n, mu in state.opt.mu.items()})
    change = leaf_norms({n: p.detach() - weights[n] for n, p in state.params.items()})
    out = {"losses": [float(v) for v in losses], "grad": grads, "change": change}
    del model, state, step, weights
    return out
