"""Serving traffic: one caller classifying bulk batches through
``Predictor.forward`` in a closed loop with ``in_flight`` batches sent and
not yet answered (1: the next batch is sent once the last one's
log-probabilities are on the host; 2: the caller sends batch k + 1 before
it waits for batch k, so the card has the next batch queued while the
host reads an answer).  A batch's latency runs from its call until its
answers are on the host.  The window sends nothing once its time is up,
waits for every batch it sent, and reads the clock after that wait.

The traffic mix gives ``batch``, ``in_flight``, ``pool`` (normalised images
made on the device from the seed; batches cycle through it),
``warmup_batches`` (run as the window runs them) and
``checked_batches``: how many of the window's first ``CHECK_SPAN``
batches the check compares, drawn from the seed before the window (their
answers and pooled prototype scores are kept; the rest are read and
dropped).  Set-up writes a run directory of seeded weights under
``TMPDIR`` and loads it as users do.

The served model thresholds each pooled prototype score at the
configuration's ``inference_threshold``, a step that rounding can flip:
where the reference's score lies within the cell's ``threshold_band`` of
the threshold, the reference takes the served decision for that score,
and its own everywhere else.

``fault`` plants one of the faults the check must catch: ``answer`` (one
image's answer replaced by another's where it is produced) or
``half_batch`` (half of each batch computed, its answers copied over the
other half).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution as served_decode
from pipnet_tpu_torch.serve import Predictor

from .. import judge, seeded
from ..reference.model import build, merged_run_config, run_config, state_shapes
from ..reference.pipnet_ref.models.pipnet import joint_leaf_log_distribution
from ..reference.train_ref import exact_float32
from ..reference.precision import lower_products

FAULTS = ("answer", "half_batch")
# the checked batches are drawn among the window's first CHECK_SPAN, which cover
# every distinct batch of the pool at its size
CHECK_SPAN = 16


class Cell:
    kind = "serve"

    def __init__(self, spec: Mapping, seed: int, device, fault: Optional[str] = None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.spec, self.seed, self.device, self.fault = spec, int(seed), torch.device(device), fault
        self.config, self.mix = spec["config_file"], spec["mix"]
        self.batch, self.pool_n = int(self.mix["batch"]), int(self.mix["pool"])
        self.in_flight = int(self.mix.get("in_flight", 1))
        self.run_dict = merged_run_config(self.config, self.mix.get("changes"))
        self.marks = []     # (part of set-up, host time at its end)
        self.ring: List[torch.Tensor] = []     # the answers' host buffers, pinned on a card

    def setup(self) -> None:
        shapes, self.ref_tree = state_shapes(self.config, run_config(self.run_dict))
        weights = seeded.seeded_state_dict(shapes, self.ref_tree, self.seed, self.device,
                                           self.config["add_on_scale"])
        self.run_dir = tempfile.mkdtemp(prefix="bench_run_")
        os.makedirs(os.path.join(self.run_dir, "metadata"))
        os.makedirs(os.path.join(self.run_dir, "checkpoints"))
        for name, obj in (("config.json", self.run_dict), ("classes.json", self.config["classes"]),
                          ("tree.json", self.config["tree"])):
            with open(os.path.join(self.run_dir, "metadata", name), "w") as f:
                json.dump(obj, f)
        self.marks.append(("weights", time.perf_counter()))
        torch.save({k: v.cpu() for k, v in weights.items()},
                   os.path.join(self.run_dir, "checkpoints", "net_trained_last.pt"))
        del weights
        self.marks.append(("checkpoint_written", time.perf_counter()))
        self.predictor = Predictor(self.run_dir, batch_size=self.batch, device=self.device)
        self.marks.append(("predictor_loaded", time.perf_counter()))
        S = self.run_dict["model"]["image_size"]
        self.pool = seeded.normalised_images(self.pool_n, S, self.seed, self.device)
        self.marks.append(("images", time.perf_counter()))
        self.n_offsets = self.pool_n // self.batch
        rng = np.random.default_rng([self.seed, 7])
        self.check_ks = set(rng.choice(CHECK_SPAN, size=int(self.mix["checked_batches"]),
                                       replace=False).tolist())
        self.served: Dict[int, tuple] = {}
        self.latencies: List[float] = []
        self.n_failed = 0
        self.finish(self.issue(0), timed=False)
        self.marks.append(("first_batch", time.perf_counter()))
        n = int(self.mix["warmup_batches"]) - 1
        self.drive(lambda k: k < n, timed=False)
        self.marks.append(("other_batches", time.perf_counter()))

    def images(self, k: int) -> torch.Tensor:
        lo = (k % self.n_offsets) * self.batch
        return self.pool[lo:lo + self.batch]

    def issue(self, k: int) -> tuple:
        """Send batch ``k``: the call to ``Predictor.forward`` and the copy
        of its log joint leaf distribution to the host, queued behind it;
        returns what ``finish`` waits for."""
        t = time.perf_counter()
        xs = self.images(k)
        if self.fault == "half_batch":
            half = xs.shape[0] // 2
            _, pooled, logp = self.predictor.forward(xs[:half])
            pooled, logp = torch.cat([pooled, pooled]), torch.cat([logp, logp])
        else:
            _, pooled, logp = self.predictor.forward(xs)
        logp = logp.float()
        if self.device.type != "cuda":
            return k, t, logp, pooled, None
        if not self.ring:
            self.ring = [torch.empty(logp.shape, dtype=logp.dtype, pin_memory=True)
                         for _ in range(self.in_flight + 1)]
        host = self.ring[k % len(self.ring)]
        host.copy_(logp, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return k, t, host, pooled, done

    def finish(self, sent: tuple, timed: bool = True):
        """Wait for a sent batch's answers on the host; in the window, take
        its latency and keep it where the check compares it."""
        k, t, host, pooled, done = sent
        if done is not None:
            done.synchronize()
        out = host.numpy().copy()
        if self.fault == "answer":
            out[0] = out[1]
        if timed:
            self.latencies.append(time.perf_counter() - t)
            self.n_failed += int(not np.isfinite(out).all())
            if k in self.check_ks:
                self.served[k] = (out, pooled)
        return out

    def drive(self, more, timed: bool) -> int:
        """Send batches 0, 1, ... while ``more(k)`` holds, ``in_flight`` at a
        time, then wait for every one sent; returns how many were sent."""
        pending = collections.deque()
        k = 0
        while True:
            while len(pending) < self.in_flight and more(k):
                pending.append(self.issue(k))
                k += 1
            if not pending:
                return k
            self.finish(pending.popleft(), timed)

    def window(self, seconds: float) -> Dict:
        """Batches sent until ``seconds`` have passed, each timed from its
        call until its answers are on the host; the window ends once the
        last one sent is answered."""
        t0 = time.perf_counter()
        k = self.drive(lambda k: time.perf_counter() - t0 < seconds, timed=True)
        return {"window_s": time.perf_counter() - t0, "batches": k, "steps": k,
                "images": k * self.batch}

    def end_to_end(self, w: Mapping) -> Dict:
        ms = sorted(1e3 * v for v in self.latencies)
        return {"serve_images_per_s": (w["images"] / w["window_s"], "images/s"),
                "serve_batch_ms_p95": (statistics.quantiles(ms, n=20)[18], "ms")}

    def summary(self, w: Mapping) -> Dict:
        ms = [1e3 * v for v in self.latencies]
        return {"batches": len(ms), "batch_ms_median": statistics.median(ms) if ms else None,
                "batch_ms_p95": statistics.quantiles(ms, n=20)[18] if len(ms) > 1 else None,
                "batch_ms_20_quantiles": ([round(q, 3) for q in statistics.quantiles(ms, n=20)]
                                          if len(ms) > 1 else None),
                "batch_ms_max": max(ms) if ms else None,
                "batch_max_at": ms.index(max(ms)) if ms else None}

    def attempted(self, w: Mapping):
        return w["batches"], self.n_failed

    def parts(self) -> Dict:
        """The serving path's layers alone, on one batch: the backbone
        forward and the joint decode of its logits."""
        p = self.predictor
        xs = self.images(0)
        with torch.inference_mode():
            logits = p.forward(xs)[0]

        def backbone():
            with torch.inference_mode():
                p.model.features(xs)

        def joint_decode():
            with torch.inference_mode():
                served_decode(logits, p.tree, softmax_tau=p.path_prob_softmax_tau)
        return {"backbone": backbone, "decode": joint_decode}

    def shapes(self) -> Dict:
        pub = self.config["published"]
        return {"images": self.batch, "side": pub["stage_maps"][-1][0],
                "dim": pub["dims"][-1], "prototypes": int(self.ref_tree.proto_valid.sum()),
                "children": int(self.ref_tree.num_children_total),
                "dtype": self.run_dict["model"]["compute_dtype"]}

    def release(self) -> None:
        self.served = {k: (out, pooled.float().cpu()) for k, (out, pooled) in self.served.items()}
        del self.predictor
        shutil.rmtree(self.run_dir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def answers(self, precision: str) -> Dict[int, tuple]:
        """The control's served answers for the checked batches: the
        reference computed in ``precision`` ("float8": bfloat16 with e4m3
        products) in the program's place, thresholding as served."""
        model, tree = self._model(precision)
        out = {}
        lower = (lower_products(precision) if precision != "float32"
             else contextlib.nullcontext())
        with torch.inference_mode(), lower:
            for k in sorted(self.served):
                o = model(self.images(k), inference=True)
                logp = joint_leaf_log_distribution(o["logits"], tree)
                out[k] = (logp.float().cpu().numpy(), o["pooled"].float().cpu())
        return out

    def _model(self, precision: str):
        cfg = run_config(self.run_dict, "float32" if precision == "float32" else "bfloat16")
        shapes, tree = state_shapes(self.config, cfg)
        weights = seeded.seeded_state_dict(shapes, tree, self.seed, self.device,
                                           self.config["add_on_scale"])
        return build(self.config, cfg, weights, self.device)

    def reference(self, served: Mapping[int, tuple] = None, band: float = None
                  ) -> Dict[int, np.ndarray]:
        """The reference's log joint leaf distribution for each checked
        batch: the frozen plain path in float32 (TF32 off), its pooled
        scores thresholded by its own decision, or by the served one
        (``served``, by default the program's) within the band."""
        served = self.served if served is None else served
        model, tree = self._model("float32")
        head = model.head
        thr = head.cfg.inference_threshold
        band = float(self.spec["cell_file"]["threshold_band"] if band is None else band)
        out = {}
        with torch.inference_mode(), exact_float32():
            for k in sorted(served):
                pooled = model(self.images(k))["pooled"].float()
                keep = pooled >= thr
                near = (pooled - thr).abs() <= band
                keep = torch.where(near, served[k][1].to(pooled.device) > 0, keep)
                _, logits = head.classify(torch.where(keep, pooled, torch.zeros_like(pooled)))
                out[k] = joint_leaf_log_distribution(logits, tree).cpu().numpy()
        del model
        return out

    def numbers(self, reference: Mapping[int, np.ndarray],
                served: Mapping[int, tuple] = None) -> Dict[str, float]:
        served = self.served if served is None else served
        keys = sorted(reference)
        if not keys:
            return judge.serve_numbers(np.zeros((0, 1)), np.zeros((1, 1)))
        return judge.serve_numbers(np.concatenate([served[k][0] for k in keys]),
                                   np.concatenate([reference[k] for k in keys]))
