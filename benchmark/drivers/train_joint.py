"""Training traffic: the train phase's joint steps, fed from the device
data cache and augmented on the device, issued back to back as
``Trainer.run_epoch`` issues them.

The traffic mix (``benchmark/traffic/<mix>.json``) gives ``epoch`` (the
phase, the mask-prune and unfreeze state, the schedules' position),
``batch``, ``warmup_steps`` (set-up; the first ``checked_steps`` of them
are the steps the reference follows) and ``changes`` to the configuration's
run config (e.g. the CLI's default align and uniformity losses).  The
configuration gives the data set's size and base size; its images are
seeded uint8 bases made on the device, one label each, and every epoch
takes a seeded permutation of them in whole batches.

``fault`` plants one of the faults the check must catch:
``unchanged`` (each step returns its state unchanged) or ``half_batch``
(the step sees half of each batch, the loss its mean over that half).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from pipnet_tpu_torch.config import ModelConfig, RunConfig, TrainConfig
from pipnet_tpu_torch.data.device_cache import DeviceDataCache
from pipnet_tpu_torch.device import host_to_device
from pipnet_tpu_torch.losses import LossWeights, compute_total_loss, make_tree_consts
from pipnet_tpu_torch.models import build_pipnet
from pipnet_tpu_torch.run_io import config_from_dict
from pipnet_tpu_torch.train import (Scalars, StepStatics, adam_update, augment_views,
                                    clip_gradients, init_train_state, label_params,
                                    make_train_step, phase_for_epoch, sample_augment)
from pipnet_tpu_torch.train.optimizer import base_lrs
from pipnet_tpu_torch.tree import Node

from .. import judge, seeded
from ..reference.model import merged_run_config, state_shapes, run_config as ref_run_config
from ..reference.train_ref import ADAM_B1, leaf_norms, reference_steps
from ..stallwatch import StallWatch

FAULTS = ("unchanged", "half_batch")


def port_run_config(d: Mapping):
    """A run-config dict as the port's ``RunConfig``."""
    return RunConfig(model=config_from_dict(ModelConfig, d["model"]),
                     train=config_from_dict(TrainConfig, d["train"]))


def labels_of(config: Mapping) -> np.ndarray:
    """One label per image: the held-in classes (all but the
    configuration's ``leave_out``) in turn, as many images each."""
    classes = config["classes"]
    out = set(config["dataset"]["leave_out"])
    held = np.array([i for i, c in enumerate(classes) if c not in out], np.int64)
    n = config["dataset"]["train_images"]
    return np.repeat(held, -(-n // len(held)))[:n]


class Cell:
    kind = "train"

    def __init__(self, spec: Mapping, seed: int, device, fault: Optional[str] = None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.spec, self.seed, self.device, self.fault = spec, int(seed), torch.device(device), fault
        self.config, self.mix = spec["config_file"], spec["mix"]
        self.batch = int(self.mix["batch"])
        self.epoch = int(self.mix["epoch"])
        n = self.config["dataset"]["train_images"]
        self.iters = -(-n // self.batch)         # the Trainer's batches an epoch
        self.run_dict = merged_run_config(self.config, self.mix.get("changes"))
        self.marks = []     # (part of set-up, host time at its end)
        self.watch = StallWatch()

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        cfg = port_run_config(self.run_dict)
        self.cfg = cfg
        model, tree = build_pipnet(Node.from_dict(self.config["tree"]), cfg.model,
                                   weighted=cfg.train.loss.weighted_ce,
                                   class_names=self.config["classes"], device=self.device)
        shapes, self.ref_tree = state_shapes(self.config, ref_run_config(self.run_dict))
        self.weights = seeded.seeded_state_dict(shapes, self.ref_tree, self.seed, self.device,
                                                self.config["add_on_scale"])
        model.load_state_dict(self.weights)
        self.model, self.tree = model, tree
        self.marks.append(("model_and_weights", time.perf_counter()))

        ds = self.config["dataset"]
        images = seeded.u8_bases(ds["train_images"], ds["base_size"], self.seed, self.device)
        self.cache = DeviceDataCache(np.zeros((1, 1, 1, 3), np.uint8), "u8base", self.device)
        self.cache.array, self.cache.nbytes = images, images.numel()
        self.labels = labels_of(self.config)
        self.marks.append(("data", time.perf_counter()))

        t = cfg.train
        e = self.epoch
        warm_t0 = warm_steps = 0.0
        if t.optim.unfreeze_warmup_epochs > 0:
            warm_t0 = float(t.freeze_epochs * self.iters)
            warm_steps = float(t.optim.unfreeze_warmup_epochs * self.iters)
        statics = StepStatics(
            phase=phase_for_epoch(e, t, pretrain=False),
            mask_prune_active=t.loss.mask_prune_overspecific and e >= t.loss.mask_prune_start_epoch,
            eta_min_net=t.optim.lr_net / 100.0, t0_cls=5.0 if t.epochs <= 30 else 10.0,
            weight_reactivation=t.weight_reactivation == "on",
            backbone_warmup_t0=warm_t0, backbone_warmup_steps=warm_steps)
        self.statics = statics
        self.step_fn = make_train_step(model, tree, cfg, statics)
        self.state = init_train_state(model, seed=seeded.stream_seed(self.seed, seeded.STEP))
        self.acc = None
        self.i = 0
        self._rows = self._row_stream()

        self.checked: Dict = {"losses": []}
        self.checked_batches = []
        n_check = int(self.mix["checked_steps"])
        for k in range(int(self.mix["warmup_steps"])):
            rows, ys = self.next_batch()
            if k < n_check:
                self.checked_batches.append((self.cache.array[rows], ys))
            m = self.step(rows, ys, accumulate=k >= n_check)
            if k < n_check:
                self.checked["losses"].append(m["loss"].detach().clone())
            if k == 0:
                self.checked["grad"] = leaf_norms(
                    {n: mu / (1.0 - ADAM_B1) for n, mu in self.state.opt.mu.items()})
            if k == n_check - 1:
                self.checked["change"] = leaf_norms(
                    {n: p.detach() - self.weights[n] for n, p in self.state.params.items()})
            if k == 0:
                self.marks.append(("first_step", time.perf_counter()))
        self.checked["losses"] = [float(v) for v in self.checked["losses"]]
        self.marks.append(("other_steps", time.perf_counter()))

    def _row_stream(self):
        epoch = 0
        while True:
            for rows in seeded.epoch_rows(len(self.labels), self.batch, self.seed, epoch):
                yield rows
            epoch += 1

    def next_batch(self):
        rows = next(self._rows)
        return rows, self.labels[rows]

    def scalars(self, i: int):
        i = i % self.iters
        t = self.cfg.train
        return Scalars(net_t=float((self.epoch - 1) * self.iters + i),
                       net_T=float(max(t.epochs * self.iters, 1)),
                       epoch_frac=(self.epoch - 1) + i / self.iters,
                       align_pf_weight=5.0, tanh_weight=2.0)

    # -- the timed path -------------------------------------------------------
    def step(self, rows: np.ndarray, ys: np.ndarray, accumulate: bool = True):
        """One step as ``Trainer.run_epoch`` issues it: the batch fetched
        from the cache, the labels sent from pinned memory, the metrics
        added up on the device (``accumulate``; otherwise the step's own
        metrics are returned)."""
        if self.fault == "half_batch":
            rows, ys = rows[:len(rows) // 2], ys[:len(ys) // 2]
        saved = None
        if self.fault == "unchanged":
            saved = ({n: p.detach().clone() for n, p in self.state.params.items()},
                     {n: m.clone() for n, m in self.state.opt.mu.items()})
        self.state, m = self.step_fn(self.state, self.cache.fetch(rows), None,
                                     host_to_device(ys, self.device), self.scalars(self.i),
                                     acc=self.acc if accumulate else None)
        if accumulate:
            self.acc = m
        if saved is not None:
            with torch.no_grad():
                for n, p in self.state.params.items():
                    p.copy_(saved[0][n])
                    self.state.opt.mu[n].copy_(saved[1][n])
        self.i += 1
        return m

    def window(self, seconds: float) -> Dict:
        """Steps back to back until ``seconds`` have passed, then a
        synchronise; the window is the host's time over both."""
        steps = 0
        sync(self.device)
        t0 = time.perf_counter()
        self.issued = [t0]
        with self.watch:
            while time.perf_counter() - t0 < seconds:
                self.step(*self.next_batch())
                steps += 1
                self.issued.append(time.perf_counter())
                self.watch.beat(steps)
            sync(self.device)
        return {"window_s": time.perf_counter() - t0, "steps": steps,
                "images": steps * self.batch}

    def summary(self, w: Mapping) -> Dict:
        """The host's time between step issues in the window: the longest
        (and after which step) and the first few, where a stall would show,
        and what the stall watch saw (``stallwatch.py``)."""
        gaps = np.diff(self.issued) * 1e3
        if not len(gaps):
            return {}
        k = int(gaps.argmax())
        return {"steps": int(w["steps"]), "issue_ms_median": float(np.median(gaps)),
                "issue_ms_max": float(gaps[k]), "issue_max_at_step": k,
                "issue_ms_first": [round(float(g), 3) for g in gaps[:5]],
                "drain_ms": 1e3 * (w["window_s"] - (self.issued[-1] - self.issued[0])),
                "watch": self.watch.report()}

    def end_to_end(self, w: Mapping) -> Dict:
        return {"train_images_per_s": (w["images"] / w["window_s"], "images/s"),
                "train_peak_gb": (w["peak_bytes"] / 1e9, "GB")}

    def attempted(self, w: Mapping):
        """Steps issued in the window; all count as failed where the
        window's summed loss is not finite."""
        bad = not math.isfinite(float(self.acc["loss"]))
        return w["steps"], w["steps"] if bad else 0

    def shapes(self) -> Dict:
        pub = self.config["published"]
        return {"images": 2 * self.batch, "side": pub["stage_maps"][-1][0],
                "dim": pub["dims"][-1], "prototypes": int(self.ref_tree.proto_valid.sum()),
                "children": int(self.ref_tree.num_children_total),
                "dtype": self.run_dict["model"]["compute_dtype"]}

    def parts(self) -> Dict:
        """The step's layers, each alone on one batch with the trainable
        flags the step set (``chip_smoke.py::train_breakdown``'s split):
        the data path (fetch, draws, both views), the backbone's forward
        and backward, the head's, the losses' and the optimiser (clipping
        and AdamW)."""
        model, head, state, cfg = self.model, self.model.head, self.state, self.cfg
        S = cfg.model.image_size
        rows, ys = self.next_batch()
        ys2 = torch.as_tensor(np.concatenate([ys, ys]), device=self.device)

        def augment():
            x = self.cache.fetch(rows)
            draws = sample_augment(len(rows), x.shape[1], S, state.generator,
                                   cfg.train.device_augment_cars)
            return augment_views(x, S, draws, cfg.train.device_augment_cars)

        xs = torch.cat(augment())
        with torch.no_grad():
            feats = model.features(xs)
            out = head(feats)
        g_feats = torch.randn(feats.shape, generator=state.generator,
                              device=self.device).to(feats.dtype)
        f_in = feats.detach().requires_grad_()

        def backbone():
            model.features(xs, train=True, generator=state.generator).backward(g_feats)

        def head_part():
            o = head(f_in)
            (o["pooled"].float().sum() + o["proto_features"].float().mean()).backward()

        tc = make_tree_consts(self.tree, self.device)
        lcfg = dataclasses.replace(cfg.train.loss,
                                   mask_prune_overspecific=self.statics.mask_prune_active,
                                   mask_prune_start_epoch=0)

        def losses():
            o = {k: v.detach().requires_grad_(v.is_floating_point()) for k, v in out.items()}
            o["features"] = feats.detach().requires_grad_()
            loss, _ = compute_total_loss(
                tc, o, ys2, head.effective_cls_weight(), head.add_on_kernel,
                head.proto_presence, head.multiplier[0].detach(), lcfg,
                LossWeights(align_pf=5.0, byol=2.0, tanh=2.0, cl=cfg.train.loss.cl_weight,
                            ood=0.2),
                tree=self.tree, pretrain=False, finetune=False, generator=state.generator)
            loss.backward()

        labels = label_params(state.params, cfg.model.backbone)
        lrs = {n: base_lrs(cfg.train.optim)[labels[n]] for n in labels}
        backbone()
        head_part()
        losses()
        masks = {n: p.grad is not None for n, p in state.params.items()}

        def optimiser():
            grads = {n: p.grad for n, p in state.params.items()}
            grads, _ = clip_gradients(grads, labels, cfg.train.optim.clip_grad,
                                      per_group=cfg.train.optim.clip_grad_per_group)
            adam_update(state.params, grads, state.opt, lrs, masks)
        return {"augment": augment, "backbone": backbone, "head": head_part, "losses": losses,
                "optimizer": optimiser}

    # -- the check ------------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.checked_batches = [(x.clone(), ys) for x, ys in self.checked_batches]
        for name in ("model", "state", "step_fn", "cache", "acc", "weights"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> Dict:
        return reference_steps(self.config, self.mix.get("changes"), self.seed, self.epoch,
                               self.iters, self.checked_batches, self.device, precision)

    def numbers(self, reference: Mapping) -> Dict[str, float]:
        return judge.train_numbers(self.checked, reference)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
