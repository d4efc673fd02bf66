"""The two-phase training engine (the port's counterpart of the JAX
package's ``train/trainer.py``).

Orchestrates the reference's training flow (``main.py:58-724``): phase 1
self-supervised pretraining, phase 2 staged training (finetune-classifier
-> finetune -> frozen backbone -> full -> mask-only), periodic eval, CSV
telemetry and checkpoints.  The per-step compute is the train step
(``train/step.py``); this module is host-side control only.  It trains on
the model's device, one rank of a mesh or alone.

On a mesh (``runtime/mesh.py``, ``--data_parallel N``: one process a
rank) every rank runs the same seeded loaders and keeps its rows of each
batch, trimmed as the JAX Trainer trims them (a ragged final batch cut to a
multiple of the data axis, the OOD chunk shortened so the combined batch
divides it); the device cache and the evaluation passes are whole on every
rank; only rank 0 writes logs and checkpoints, and a checkpoint holds the
whole parameters and moments whatever the mesh.  With ``--model_parallel
M`` the mesh is (N, M): the model ranks of a data rank take the same rows,
and from its first epoch to the end of ``fit`` the head holds each rank's
columns of P (``PrototypeHead.shard_columns``), their moments too.  The
evaluation passes and the saves gather it whole first (``whole_model``):
evaluation runs the whole head, on K1 where it fuses.

The host never waits for the card inside an epoch: the batch indices and
labels go to the card from pinned memory without waiting
(``device.host_to_device``), and the epoch's metrics add up on the card
(the step's ``acc``) and are read once, with the classifier's sparsity,
when the epoch ends.  The one wait a step holds is the read of the
augmentation's op counts in ``train/step.py::sample_augment``, made on a
side stream of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import RunConfig
from ..data.loader import Loader, Loaders
from ..device import host_to_device
from ..models.convert import random_jax_variables, state_dict_from_jax
from ..losses import make_tree_consts
from ..losses.catalog import label_rows
from ..models.pipnet import PIPNet, presence_keep
from ..runtime.log import RunLog, open_run_log
from ..runtime.mesh import (Mesh, data_mesh, dp_mp_mesh, on_axis, replicate, shard_batch,
                            split_moments, state_shardings, whole_moments)
from ..runtime.profiling import trace
from ..tree.compile import TreeArrays
from .optimizer import cosine_annealing, cosine_warm_restarts, phase_for_epoch
from .step import (Scalars, StepStatics, TrainState, init_train_state, make_eval_step,
                   make_train_step, reinit_optimizer)


PALLAS_HEAD_REFUSAL = (
    "model_parallel > 1 shards the prototype axis across devices; the fused "
    "Pallas head is a single-device kernel — build the model with "
    "use_pallas_head=False")


def trimmed_rows(n: int, n_shards: int) -> int:
    """Rows of a batch of ``n`` kept on a data axis of ``n_shards``: a
    ragged final batch drops its remainder so that it splits evenly (0: the
    batch is skipped; the JAX Trainer's rule, with OOD rows the trimmed
    rows are OOD rows)."""
    return n - n % n_shards


def ood_chunk_size(batch_size: int, ood_batch_size: int, n_shards: int) -> int:
    """OOD rows a step takes: the OOD loader's batch size, shortened so that
    the combined batch divides the data axis (the JAX Trainer's rule)."""
    size = ood_batch_size - (batch_size + ood_batch_size) % n_shards
    if size <= 0:
        raise ValueError(f"OOD batch size {ood_batch_size} too small to align batch "
                         f"{batch_size}+OOD to {n_shards} shards")
    return size


def _ood_chunks(ood_loader: Loader, start_epoch: int, size: int):
    """Endless stream of fixed-``size`` (xs1, xs2) OOD chunks (host arrays).

    Cycles the OOD loader across epochs (its iterator restarted with the
    next epoch number, so the augmentations stay fresh) and re-chunks the
    rows, so every training step sees exactly ``size`` OOD rows.  The
    reference silently truncates its zip where the OOD epoch is shorter
    (pipnet/train.py:205-214); cycling is the JAX package's deliberate
    deviation, kept for parity."""
    buf1, buf2, have = [], [], 0
    ep = start_epoch
    while True:
        for b in ood_loader.epoch(ep):
            buf1.append(b.xs1)
            if b.xs2 is not None:       # None under device-side transform2
                buf2.append(b.xs2)
            have += len(b.xs1)
            while have >= size:
                x1 = np.concatenate(buf1) if len(buf1) > 1 else buf1[0]
                x2 = (np.concatenate(buf2) if len(buf2) > 1 else buf2[0]) if buf2 else None
                yield x1[:size], (x2[:size] if x2 is not None else None)
                buf1 = [x1[size:]]
                buf2 = [x2[size:]] if x2 is not None else []
                have = len(buf1[0])
        ep += 1


class Trainer:
    # per-node CSV columns (fixed, "n.a" when a loss is inactive in a phase:
    # the reference's fixed set, pipnet/train.py:186-194, plus the
    # hierarchical extras)
    NODE_LOSS_COLS = ("class", "tanh", "tanh_desc", "kernel_orth", "align_pf")

    def __init__(self, model: PIPNet, tree: TreeArrays, cfg: RunConfig,
                 loaders: Loaders, log: Optional[RunLog] = None,
                 ood_loaders: Optional[Loaders] = None, mesh: Optional[Mesh] = None):
        """``mesh``: the mesh this process is a rank of; by default
        ``cfg.train.data_parallel`` data ranks (0: every rank of the process
        group, over ``model_parallel``) by ``cfg.train.model_parallel``
        model ranks, which needs a process group of that many ranks
        (``runtime/mesh.py::init_ranks``; the CLI starts them).  One rank
        trains without a mesh."""
        t = cfg.train
        if t.model_parallel > 1 and cfg.model.use_pallas_head:
            raise ValueError(PALLAS_HEAD_REFUSAL)
        self.device = model.head.add_on_kernel.device
        if mesh is None and t.model_parallel > 1:
            world = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
            mesh = dp_mp_mesh(t.data_parallel or max(world // t.model_parallel, 1),
                              t.model_parallel, device=self.device)
        elif mesh is None and t.data_parallel != 1:
            mesh = data_mesh(t.data_parallel or None, device=self.device)
        # one rank: no mesh, the one-device step as it is
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            self.mesh.proto_columns(tree.num_protos_padded)   # raises where M does not divide P
        self.zero1 = t.zero1 and self.mesh is not None
        # the head and its moments hold this rank's columns (a model axis,
        # while fit runs)
        self._model_split = False
        self.model = model
        self.tree = tree
        self.cfg = cfg
        self.loaders = loaders
        # the OOD dataset's loaders (--OOD_dataset): their train loader
        # feeds OOD rows (label -1) into every phase-2 step
        self.ood_loaders = ood_loaders
        # only rank 0 writes the run directory
        self.log = log or open_run_log(cfg.log_dir, 0 if self.mesh is None else self.mesh.rank)
        self._step_cache: Dict[tuple, Callable] = {}
        self.eval_step = make_eval_step(model, tree)
        # eval steps by (path_prob_softmax_tau, apply_overspecificity_mask,
        # leave_out_idx)
        self._eval_steps: Dict[tuple, Callable] = {(1.0, False, None): self.eval_step}
        self.state: Optional[TrainState] = None
        self.history: list = []
        # --profile_epoch: a torch.profiler trace of steps 2..1+trace_steps
        # of that train epoch into <log_dir>/traces/epoch_<N>
        self.trace_epoch: Optional[int] = None
        self.trace_steps: int = 8
        # cadence of the rolling net_trained save (1 = reference parity:
        # every epoch, main.py:703-705); the last epoch always saves
        self.checkpoint_every: int = 1
        # (name, seconds) of every checkpoint this trainer wrote
        self.save_seconds: list = []
        # device-resident dataset caches, built on first use per dataset
        # object (data/device_cache.py): None = checked and not cacheable or
        # over budget
        self._device_data: Dict[int, object] = {}
        self._device_data_bytes: int = 0

    # -- setup ---------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh seeded parameters and BatchNorm statistics for the
        configured backbone and BYOL heads (``random_jax_variables`` with the
        run's seed: the JAX initializers' scales, from numpy) loaded into the
        model, a zero Adam state, a generator seeded with the run's seed and
        under BYOL the EMA target as a copy of the backbone and projector."""
        seed = self.cfg.train.seed
        variables = random_jax_variables(self.cfg.model, self.tree, seed=seed,
                                         backbone=self.model.backbone)
        self.model.load_state_dict(state_dict_from_jax(variables))
        self.state = self._place(init_train_state(self.model, seed=seed))
        return self.state

    def adopt_state(self, state: TrainState) -> None:
        """Install a restored TrainState (checkpoint resume or partial load)."""
        self.state = self._place(state)

    def _place(self, state: TrainState) -> TrainState:
        """On a mesh: rank 0's weights, BatchNorm statistics and BYOL target
        on every rank (a whole state: the head is split when an epoch
        begins), and under ZeRO-1 each whole moment cut to this rank's part
        over the data ranks (the layout the step expects)."""
        if self.mesh is None:
            return state
        replicate(self.mesh, [*state.params.values(), *state.buffers.values(),
                              *state.byol.values()])
        return self._split_data_moments(state)

    def _split_data_moments(self, state: TrainState) -> TrainState:
        if self.zero1:
            whole = all(state.opt.mu[n].shape == p.shape for n, p in state.params.items())
            if whole:
                state.opt = split_moments(self.mesh, state.opt,
                                          on_axis(self._specs(state), "data"))
        return state

    def _specs(self, state: TrainState):
        """The state's layout as it stands: a head leaf's moments split over
        the model ranks only between ``_shard_model`` and
        ``_gather_model``."""
        specs = state_shardings(self.mesh, state, zero1=self.zero1)
        return specs if self._model_split else on_axis(specs, "data")

    def _shard_model(self) -> None:
        """On a model axis: the head and its moments cut to this rank's
        columns (a no-op where they are)."""
        if self.mesh is None or self.mesh.n_model == 1 or self._model_split:
            return
        self.model.head.shard_columns(self.mesh)
        self._model_split = True
        self.state.opt = split_moments(self.mesh, self.state.opt,
                                       on_axis(self._specs(self.state), "model"))

    def _gather_model(self) -> None:
        """The head and its moments whole again (collective)."""
        if not self._model_split:
            return
        self.state.opt = whole_moments(self.mesh, self.state.opt,
                                       on_axis(self._specs(self.state), "model"))
        self.model.head.gather_columns()
        self._model_split = False

    @contextlib.contextmanager
    def whole_model(self):
        """The model with its whole head while the block runs (gathered
        from the model ranks and cut again after: collective, every rank
        enters it); the model as it is where the head is whole."""
        columns = self.model.head.columns
        if columns is None:
            yield self.model
            return
        self.model.head.gather_columns()
        try:
            yield self.model
        finally:
            self.model.head.shard_columns(columns.mesh)

    def whole_state(self) -> TrainState:
        """The train state with whole Adam moments (under ZeRO-1 or on a
        model axis a collective: every rank calls it)."""
        specs = self._specs(self.state) if self.mesh is not None else None
        if specs is None or not any(s for s in specs["mu"].values()):
            return self.state
        return dataclasses.replace(self.state, opt=whole_moments(
            self.mesh, self.state.opt, specs))

    # -- device-resident data ------------------------------------------------
    def device_cache_for(self, loader: Loader):
        """The device-resident data cache for ``loader``'s dataset, built on
        first use; None when gated off.  Gates: PIPNET_DEVICE_DATA=0
        disables; the total cached bytes are capped by
        PIPNET_DEVICE_CACHE_MB (default 6144)."""
        if os.environ.get("PIPNET_DEVICE_DATA", "1") == "0":
            return None
        key = id(loader.dataset)
        if key in self._device_data:
            return self._device_data[key]
        from ..data.device_cache import build_device_cache, estimate_bytes
        budget = int(os.environ.get("PIPNET_DEVICE_CACHE_MB", "6144")) << 20
        est = estimate_bytes(loader.dataset)
        cache = None
        if est is not None and self._device_data_bytes + est <= budget:
            cache = build_device_cache(loader, device=self.device)
            if cache is not None:
                self._device_data_bytes += cache.nbytes
                print(f"device data cache: {cache.kind} "
                      f"{cache.nbytes / 2**20:.0f} MB "
                      f"({self._device_data_bytes / 2**20:.0f} MB total)", flush=True)
        self._device_data[key] = cache
        return cache

    def drop_device_cache(self, loader: Loader) -> None:
        """Free a cache's device memory (the pretrain cache after the
        pretrain phase) and hand it back to the card, so that the next
        cache finds it."""
        cache = self._device_data.pop(id(loader.dataset), None)
        if cache is not None:
            self._device_data_bytes -= cache.nbytes
            cache.delete()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _get_step(self, statics: StepStatics) -> Callable:
        key = (statics.phase, statics.mask_prune_active, statics.has_ood,
               statics.eta_min_net, statics.t0_cls, statics.weight_reactivation,
               statics.backbone_warmup_t0, statics.backbone_warmup_steps)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(self.model, self.tree, self.cfg, statics,
                                                    mesh=self.mesh, zero1=self.zero1)
        return self._step_cache[key]

    # -- epochs --------------------------------------------------------------
    def run_epoch(self, epoch: int, *, pretrain: bool, net_t0: int, net_T: int,
                  loader: Loader, ood_loader: Optional[Loader] = None) -> Dict:
        """One epoch of ``loader``'s batches.  With ``ood_loader`` each step
        also takes a fixed-size chunk of OOD rows (``_ood_chunks``, label
        -1) after the batch's own, and the epoch streams from the host: the
        device cache holds one dataset, and the OOD rows come from a
        second."""
        cfg = self.cfg.train
        phase = phase_for_epoch(epoch, cfg, pretrain=pretrain)
        mask_prune_active = (cfg.loss.mask_prune_overspecific and not pretrain
                             and epoch >= cfg.loss.mask_prune_start_epoch)
        # unfreeze warmup (OptimConfig.unfreeze_warmup_epochs) on the net_t
        # axis: net_t0 == (epoch-1)*len(loader) in the train phase, so the
        # backbone becomes trainable at net_t == freeze_epochs*len(loader)
        warm_t0 = warm_steps = 0.0
        if cfg.optim.unfreeze_warmup_epochs > 0 and not pretrain:
            warm_t0 = float(cfg.freeze_epochs * len(loader))
            warm_steps = float(cfg.optim.unfreeze_warmup_epochs * len(loader))
        self._shard_model()
        statics = StepStatics(
            phase=phase,
            mask_prune_active=mask_prune_active,
            has_ood=ood_loader is not None,
            eta_min_net=(cfg.optim.lr_block / 100.0 if pretrain
                         else cfg.optim.lr_net / 100.0),
            t0_cls=5.0 if cfg.epochs <= 30 else 10.0,   # main.py:504-507
            weight_reactivation=cfg.weight_reactivation == "on",
            backbone_warmup_t0=warm_t0,
            backbone_warmup_steps=warm_steps,
        )
        step = self._get_step(statics)

        iters = len(loader)
        nr_epochs = cfg.epochs_pretrain if pretrain else cfg.epochs
        align_pf_w = (epoch / max(nr_epochs, 1)) if pretrain else 5.0  # train.py:149,164
        tanh_w = 5.0 if pretrain else 2.0                              # train.py:154,169

        def scalars(i: int) -> Scalars:
            return Scalars(net_t=float(net_t0 + i), net_T=float(max(net_T, 1)),
                           epoch_frac=(epoch - 1) + i / max(iters, 1),  # train.py:322
                           align_pf_weight=align_pf_w, tanh_weight=tanh_w)

        # device-resident dataset: a step's transfer is a (B,) index vector,
        # the device gathers the uint8 bases itself (data/device_cache.py);
        # as in the JAX package, the epoch's clock includes building it
        t_start = time.time()
        cache = self.device_cache_for(loader) if ood_loader is None else None
        dev = self.device

        def batches():
            for b in self.epoch_batches(loader, epoch, cache is not None, ood_loader):
                if cache is not None:
                    rows, ys, nrows = b
                    yield cache.fetch(rows), None, host_to_device(ys, dev), nrows
                    continue
                xs1, xs2, ys, nrows = b
                yield (host_to_device(xs1, dev),
                       None if xs2 is None else host_to_device(xs2, dev),
                       host_to_device(ys, dev), nrows)

        # profiling: trace steps 2..1+trace_steps of the chosen epoch (step 1
        # carries the warm-up and would dominate the trace)
        trace_dir = None
        if self.trace_epoch is not None and not pretrain and epoch == self.trace_epoch:
            trace_dir = self.log.trace_dir(epoch)

        # the epoch's metric totals add up ON THE DEVICE (the step's `acc`);
        # the host reads them once after the epoch
        acc = None
        n_steps = n_images = 0
        with contextlib.ExitStack() as tracing:
            for i, (xs1, xs2, ys, nrows) in enumerate(batches()):
                self.state, acc = step(self.state, xs1, xs2, ys, scalars(i), acc=acc)
                n_steps += 1
                n_images += nrows
                if trace_dir is not None:
                    if n_steps == 1:
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        tracing.enter_context(trace(trace_dir))
                    elif n_steps == 1 + self.trace_steps:
                        tracing.close()
                        trace_dir = None
        if acc is None:
            raise ValueError(
                f"epoch {epoch}: 0 training steps ran ({n_images} images from "
                f"{len(loader)} batches survived sharding-alignment trimming; batch_size "
                f"must be >= the data-parallel shard count and the loader non-empty)")
        metrics = self._read_epoch_metrics(acc)

        fine_correct = int(metrics.pop("fine_correct"))
        n_fine = int(metrics.pop("n_fine"))
        node_correct = metrics.pop("node_correct").astype(np.int64)
        node_examples = metrics.pop("node_examples").astype(np.int64)
        sparsity = {k: float(metrics.pop(k)) for k in ("nonzero_protos",
                                                       "nonzero_connections")}
        totals: Dict[str, float] = {}
        per_node_sums: Dict[str, np.ndarray] = {}
        for k, v in metrics.items():
            if k.startswith("per_node/"):
                per_node_sums[k] = v
            else:
                totals[k] = float(v)

        wall = time.time() - t_start
        info = {k: v / max(n_steps, 1) for k, v in totals.items()}
        info["fine_accuracy"] = fine_correct / max(n_fine, 1)
        info["images_per_sec"] = n_images / max(wall, 1e-9)
        info["epoch_seconds"] = wall
        # host-memory telemetry: a leak shows in the metrics trail
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        info["host_rss_mb"] = float(line.split()[1]) / 1024.0
                        break
        except OSError:
            pass
        # classifier-sparsity trajectory (the product metric of PIP-Net; ref
        # pipnet/test.py:90-96), read with the epoch's metrics
        info.update(sparsity)
        info["net_t_end"] = net_t0 + n_steps
        with np.errstate(invalid="ignore"):
            info["node_accuracy"] = np.where(node_examples > 0,
                                             node_correct / np.maximum(node_examples, 1), 0.0)
        info["per_node"] = {k: v / max(n_steps, 1) for k, v in per_node_sums.items()}
        return info

    def epoch_batches(self, loader: Loader, epoch: int, indices: bool,
                      ood_loader: Optional[Loader] = None):
        """This rank's part of each batch of ``loader``'s epoch, on the
        host: ``(rows, ys, n)`` (dataset rows for the device cache, with
        ``indices``) or ``(xs1, xs2, ys, n)``, ``n`` the rows the whole
        step takes.  With ``ood_loader`` each batch is followed by a
        fixed-size chunk of OOD rows (label -1, ``_ood_chunks``).  On a
        mesh the batches are trimmed to the data axis (``trimmed_rows``,
        ``ood_chunk_size``; a batch trimmed to nothing is skipped) and split
        (``shard_batch``)."""
        mesh = self.mesh
        n_shards = mesh.n_data if mesh is not None else 1
        ood_iter = None
        if ood_loader is not None:
            size = ood_chunk_size(loader.batch_size, ood_loader.batch_size, n_shards)
            ood_iter = _ood_chunks(ood_loader, epoch, size)

        def part(*arrays):
            keep = trimmed_rows(len(arrays[-1]), n_shards)
            if keep == 0:
                return None
            arrays = tuple(None if a is None else a[:keep] for a in arrays)
            return (shard_batch(mesh, *arrays) if mesh is not None else arrays) + (keep,)

        if indices:
            batches = (part(rows, ys) for rows, ys in loader.epoch_index_batches(epoch))
            yield from (b for b in batches if b is not None)
            return
        for b in loader.epoch(epoch):
            xs1, xs2, ys = b.xs1, b.xs2, b.ys
            if ood_iter is not None:
                ox1, ox2 = next(ood_iter)
                xs1 = np.concatenate([xs1, ox1])
                if xs2 is not None:
                    xs2 = np.concatenate([xs2, ox2])
                ys = np.concatenate([ys, np.full(len(ox1), -1, ys.dtype)])
            b = part(xs1, xs2, ys)
            if b is not None:
                yield b

    @torch.no_grad()
    def _read_epoch_metrics(self, acc: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The epoch's metric totals and the classifier's sparsity
        (``relu(W) * mask > 1e-3``: prototypes with a live connection, and
        the connections) in ONE device-to-host read: every value as float64
        (the counts are exact there), concatenated on the device."""
        head = self.model.head
        alive = (torch.relu(head.cls_weight) * head.cls_mask) > 1e-3
        sparsity = torch.stack([alive.any(dim=0).sum(), alive.sum()]).double()
        if head.columns is not None:          # each model rank's columns
            sparsity = head.columns.mesh.model_all_reduce(sparsity)
        parts = dict(acc, nonzero_protos=sparsity[0], nonzero_connections=sparsity[1])
        flat = torch.cat([v.detach().reshape(-1).double() for v in parts.values()]).cpu()
        out, at = {}, 0
        for k, v in parts.items():
            out[k] = flat[at:at + v.numel()].reshape(v.shape).numpy()
            at += v.numel()
        return out

    # -- full run ------------------------------------------------------------
    def fit(self, *, epochs: Optional[int] = None, epochs_pretrain: Optional[int] = None,
            eval_every: int = 5, save_every: int = 5, start_epoch: int = 0,
            skip_pretrain: bool = False) -> Dict:
        """``start_epoch > 0`` resumes phase 2 at that epoch (pretraining
        skipped), with the schedules recovered from the step counter.
        ``skip_pretrain`` resumes from a restored ``net_pretrained`` state:
        phase 2 starts at epoch 1 without re-running phase 1 (but keeps
        phase-1 epoch numbering in the logs)."""
        cfg = self.cfg.train
        n_pre = cfg.epochs_pretrain if epochs_pretrain is None else epochs_pretrain
        n_epochs = cfg.epochs if epochs is None else epochs
        n_pre_log = n_pre
        if start_epoch > 0 or skip_pretrain:
            # resume skips pretraining but keeps the original epoch NUMBERING
            # (otherwise resumed CSV/JSONL rows land n_pre lower than the
            # fresh run's and overlap earlier rows)
            n_pre = 0
        if self.state is None:
            self.init_state()
        self.log.save_config(self.cfg)
        if getattr(self.loaders, "classes", None):
            self.log.save_classes(self.loaders.classes)
        self.log.create_log("log_epoch_overview", "epoch", "test_top1_acc",
                            "test_top5_acc", "mean_train_acc", "mean_train_loss")

        # phase 1: pretraining (main.py:428-488)
        net_t = 0
        net_T = len(self.loaders.train_pretraining) * n_pre
        for epoch in range(1, n_pre + 1):
            info = self.run_epoch(epoch, pretrain=True, net_t0=net_t, net_T=net_T,
                                  loader=self.loaders.train_pretraining)
            net_t = info["net_t_end"]
            self._log_epoch("pretrain", epoch, info)
            self.log.log_values("log_epoch_overview", epoch, "n.a.", "n.a.",
                                "n.a.", f"{info['loss']:.5f}")
        if n_pre > 0:
            self._save("net_pretrained", epoch=0, phase="pretrained")
            # the pretrain loader's device-resident bases (its resize_to
            # differs from the train loader's) are dead weight from here
            self.drop_device_cache(self.loaders.train_pretraining)

        # phase 2: fresh optimizer + schedulers (main.py:501-507)
        if start_epoch == 0:
            self.state = self._split_data_moments(reinit_optimizer(self.state))
        net_t = start_epoch * len(self.loaders.train)
        net_T = len(self.loaders.train) * n_epochs
        ood_loader = self.ood_loaders.train if self.ood_loaders else None
        last_eval: Dict = {}
        info: Dict = {}   # stays empty when resuming an already-finished run
        for epoch in range(start_epoch + 1, n_epochs + 1):
            info = self.run_epoch(epoch, pretrain=False, net_t0=net_t, net_T=net_T,
                                  loader=self.loaders.train, ood_loader=ood_loader)
            net_t = info["net_t_end"]
            self._log_epoch("train", epoch + n_pre_log, info)
            if (epoch % eval_every == 0 or epoch == n_epochs) and n_epochs > 1:
                last_eval = self.evaluate(self.loaders.test)
                self.log.message(f"epoch {epoch}: test top1 {last_eval['top1']:.4f}")
                self.log.log_values("log_epoch_overview", epoch + n_pre_log,
                                    f"{last_eval['top1']:.5f}",
                                    f"{last_eval['top5']:.5f}",
                                    f"{info['fine_accuracy']:.5f}",
                                    f"{info['loss']:.5f}")
            # the reference saves net_trained EVERY epoch (main.py:703-705);
            # checkpoint_every > 1 coarsens that
            if epoch % self.checkpoint_every == 0 or epoch == n_epochs:
                self._save("net_trained", epoch=epoch, phase="train")
            if epoch % save_every == 0:
                self._save(f"net_trained_{epoch}", epoch=epoch, phase="train")
        self._save("net_trained_last", epoch=n_epochs, phase="train")
        self._save_lr_curves(n_epochs)
        self._gather_model()
        return {"train": info, "eval": last_eval}

    def _save(self, name: str, **meta) -> None:
        t0 = time.perf_counter()
        with self.whole_model():
            self.log.save_checkpoint(name, self.model, self.whole_state(), **meta)
        self.save_seconds.append((name, time.perf_counter() - t0))

    def _save_lr_curves(self, n_epochs: int) -> None:
        """lr_net.png / lr_class.png run artifacts (ref main.py:714-721),
        reconstructed from the schedules (pure functions of the step
        counter)."""
        cfg = self.cfg.train
        spe = max(len(self.loaders.train), 1)
        T = spe * max(n_epochs, 1)
        t = np.arange(T)
        lrs_net = [cosine_annealing(cfg.optim.lr_net, cfg.optim.lr_net / 100.0,
                                    float(i), float(T)) for i in t[::max(1, T // 2000)]]
        t0 = 5.0 if cfg.epochs <= 30 else 10.0     # main.py:504-507
        lrs_cls = [cosine_warm_restarts(cfg.optim.lr, 1e-3, float(i) / spe, t0)
                   for i in t[::max(1, T // 2000)]]
        self.log.save_curves({"lr_net": lrs_net, "lr_class": lrs_cls})

    # -- eval ----------------------------------------------------------------
    def eval_batches(self, loader: Loader):
        """(images on the device, labels on the host) for each batch of
        ``loader``'s pass: gathered from its device cache when it has one,
        else streamed from the host loader."""
        cache = self.device_cache_for(loader)
        if cache is not None:
            return ((cache.fetch(rows), ys) for rows, ys in loader.epoch_index_batches(0))
        return ((host_to_device(b.xs1, self.device), b.ys) for b in loader.epoch(0))

    def get_eval_step(self, path_prob_softmax_tau: float = 1.0,
                      apply_overspecificity_mask: bool = False,
                      leave_out_idx: Optional[tuple] = None) -> Callable:
        key = (float(path_prob_softmax_tau), bool(apply_overspecificity_mask), leave_out_idx)
        if key not in self._eval_steps:
            self._eval_steps[key] = make_eval_step(
                self.model, self.tree, path_prob_softmax_tau=path_prob_softmax_tau,
                apply_overspecificity_mask=apply_overspecificity_mask,
                leave_out_idx=leave_out_idx)
        return self._eval_steps[key]

    def mask_samples(self, num_batches: int,
                     fixed_mask_seed: Optional[int] = None) -> torch.Tensor:
        """(num_batches, P) presence samples of a masked pass, drawn before
        it and on the device at once (``models/pipnet.py::presence_keep``):
        one per batch from a generator seeded 0 (the reference's
        GumbelSoftmax draws fresh noise every forward), or with
        ``fixed_mask_seed`` one for the whole pass, the pruned model that
        ``serve.Predictor(mask_seed=fixed_mask_seed)`` deploys."""
        presence = self.model.head.proto_presence
        if fixed_mask_seed is not None:
            return presence_keep(presence, fixed_mask_seed)[None].expand(num_batches, -1)
        return presence_keep(presence, 0, num=num_batches)

    def evaluate(self, loader: Loader, *, leave_out_classes=None,
                 apply_overspecificity_mask: bool = False,
                 path_prob_softmax_tau: float = 1.0,
                 fixed_mask_seed: Optional[int] = None) -> Dict[str, float]:
        """Test pass (ref test_pipnet, pipnet/train.py:525-849): duplicated
        views, inference thresholding, joint-distribution top-1/top-5.

        With ``leave_out_classes``, the decode applies the reference's LOU
        short-circuit (util/node.py:319-326) and accuracy is measured on the
        left-out rows only (calc_acc_LOU.ipynb semantics): ``n`` counts
        them.  With ``apply_overspecificity_mask``, each batch's forward and
        decode use that batch's presence sample (``mask_samples``, drawn
        before the pass).

        The counts add up on the device and are read once.  A label counts
        in the top k when fewer than k leaves rank above it, a leaf ranking
        above when its log probability is larger, or equal at a lower
        index: the order of ``jax.lax.top_k``, so that ties (leaves whose
        paths decode alike) count as in the JAX package whatever order a
        top-k kernel returns them in.  On a model axis the pass runs the
        whole head (``whole_model``), as the JAX package evaluates a model
        trained with ``--model_parallel`` at ``model_parallel=1``."""
        with self.whole_model():
            return self._evaluate(loader, leave_out_classes, apply_overspecificity_mask,
                                  path_prob_softmax_tau, fixed_mask_seed)

    def _evaluate(self, loader, leave_out_classes, apply_overspecificity_mask,
                  path_prob_softmax_tau, fixed_mask_seed) -> Dict[str, float]:
        dev = self.device
        leave_out_idx = rows_of = None
        if leave_out_classes:
            leave_out_idx = tuple(self.tree.class_names.index(c) for c in leave_out_classes)
            left_out = np.zeros(self.tree.num_classes, bool)
            left_out[list(leave_out_idx)] = True
            rows_of = torch.as_tensor(left_out, device=dev)
        step = self.get_eval_step(path_prob_softmax_tau, apply_overspecificity_mask,
                                  leave_out_idx)
        keeps = (self.mask_samples(max(len(loader), 1), fixed_mask_seed)
                 if apply_overspecificity_mask else None)
        acc = torch.zeros(3, dtype=torch.long, device=dev)
        for i, (xs, ys) in enumerate(self.eval_batches(loader)):
            ys = host_to_device(ys, dev)
            keep = None if keeps is None else keeps[min(i, len(keeps) - 1)]
            logp = step(xs, keep)["log_joint"]
            rows = None if rows_of is None else rows_of[ys.clamp(min=0)] & (ys >= 0)
            acc += _topk_counts(logp, ys, rows=rows)
        top1, top5, n = (int(v) for v in acc.cpu())
        return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1), "n": n}

    # -- logging -------------------------------------------------------------
    def _log_epoch(self, split: str, epoch: int, info: Dict) -> None:
        name = f"epoch_wise_metrics_{split}"
        self.log.create_log(name, "epoch", "fine_accuracy", "loss", "images_per_sec")
        self.log.log_values(name, epoch, f"{info['fine_accuracy']:.5f}",
                            f"{info.get('loss/total', 0.0):.5f}",
                            f"{info['images_per_sec']:.2f}")
        # full loss detail as JSONL (columns vary by phase)
        row = {k: float(v) for k, v in info.items() if not isinstance(v, (dict, np.ndarray))}
        row["epoch"] = epoch
        self.log.append(f"metrics_{split}.jsonl", json.dumps(row))
        # per-node loss CSVs (ref pipnet/train.py:503-518)
        per_node = info.get("per_node", {})
        sub = f"node_wise_metrics_{split}"
        for ni, node_name in enumerate(self.tree.node_names):
            log_name = f"{sub}/{node_name}_losses"
            self.log.create_log(log_name, "epoch", *self.NODE_LOSS_COLS, "accuracy")
            vals = []
            for c in self.NODE_LOSS_COLS:
                v = per_node.get(f"per_node/{c}_per_node")
                vals.append(f"{v[ni]:.5f}" if v is not None else "n.a")
            acc = info["node_accuracy"][ni]
            self.log.log_values(log_name, epoch, *vals, f"{acc:.4f}")
        self.history.append((split, epoch, {k: v for k, v in info.items()
                                            if not isinstance(v, (dict, np.ndarray))}))


def _topk_counts(logp: torch.Tensor, ys: torch.Tensor, k: int = 5,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(top-1 hits, top-k hits, rows counted) of labels ``ys`` under
    ``logp`` (B, L), ranked as ``jax.lax.top_k`` ranks: larger first, ties
    by lower index.  ``rows`` (B,) bool counts only those rows (all when
    None)."""
    k = min(k, logp.shape[-1])
    mine = logp.gather(1, ys[:, None])
    idx = torch.arange(logp.shape[-1], device=logp.device)
    above = (logp > mine) | ((logp == mine) & (idx[None] < ys[:, None]))
    rank = above.sum(dim=-1)
    if rows is None:
        rows = torch.ones_like(rank, dtype=torch.bool)
    return torch.stack([((rank == 0) & rows).sum(), ((rank < k) & rows).sum(), rows.sum()])


def evaluate_per_node(trainer: Trainer, loader: Loader) -> dict:
    """Per-node accuracy and weighted F1 on an eval loader (the reference's
    node_accuracy bookkeeping and torchmetrics weighted F1,
    pipnet/train.py:469-475): at every node, the argmax over its child
    columns of the unmasked eval step's logits (ties to the first child, as
    numpy's argmax) against the child the label lies under, for the images
    under the node.  The predictions and slots stay on the device until one
    read after the pass."""
    from ..eval.metrics import per_node_prf
    tree, dev = trainer.tree, trainer.device
    tc = make_tree_consts(tree, dev)
    preds, slots = [], []
    for xs, ys in trainer.eval_batches(loader):
        logits = trainer.eval_step(xs)["logits"]
        node_logits = logits[:, tc.node_cols.reshape(-1)].reshape(len(ys), *tc.node_cols.shape)
        node_logits = torch.where(tc.node_cols_valid[None], node_logits,
                                  torch.full_like(node_logits, float("-inf")))
        preds.append(node_logits.argmax(dim=-1))
        slots.append(tc.leaf_slot[label_rows(host_to_device(ys, dev), tc.num_leaves)])
    if not preds:
        return {}
    pred, slot = torch.stack([torch.cat(preds), torch.cat(slots)]).cpu().numpy()
    report = {}
    for ni, name in enumerate(tree.node_names):
        under = slot[:, ni] >= 0
        if under.any():
            report[name] = per_node_prf(pred[under, ni], slot[under, ni],
                                        int(tree.node_num_children[ni]))
    return report
