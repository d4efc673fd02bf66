#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pipnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--baseline CHECKOUT]
                          [--only blocks|uniform|data|trainer|eval|interp|backbones|options|
                                  mesh|model|f32]

Phases, each of which fails the run loudly:

1. device: the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its main path gives it (the flagship 190-class tree, 26x26x768
   features: K1 at the serving batch of 8 and the training batch of 128, its
   adjoint K1b at 128, the no-pf head K2 at 64 view pairs; in f32 with TF32
   off and in bf16) and on a small tree with several bucket widths and a
   padded tail; the depthwise conv K3 and the fused block K4 at the four
   ConvNeXt-tiny-26 stage maps at B=128 and at the serving B=8, in f32
   and bf16, on small ragged shapes, and K3's gradient against cuDNN's (K4's
   three launches also one by one against their plain pieces, each timed
   beside its bound, and K4 f32 beside the eager branch with TF32 off);
   with the kernel's time, its plain
   version's, one PyTorch library call's where one computes the same
   function, and the card's bound; K1 and K2 also at
   the edges of their bf16 tiling (99 rows, D = 72, bucket widths that do
   not divide the tile, one image, tau = 0.5); K1, K1b and K2 on flat
   PIP-Net's node of 768 prototypes (K1 at B=8 and 128 in both dtypes, K1b
   at 128, K2 at 64 pairs) and on nodes of 300 and 2000 and a tree
   mixing a narrow bucket with a node of 300 off an 8-column boundary, all
   wider than a column tile and run as parts; with ``--baseline CHECKOUT``
   an older checkout's K1, K2, K1b, K3 and K4 are built and their launches
   at the main-path shapes timed in turns with these (baseline, this, this,
   baseline): K1 on the flagship in both dtypes, K2 in bf16 and in f32
   (flagship and flat at 64 pairs, ResNet-50's shape at 4), K1b and K3 in
   bf16, K4 in f32 at the four stage maps at both batches; the uniformity
   loss's pair sum K5 and its gradient K5b at one view of the flagship
   step (43,264 rows, D = 768) against the float64 value of the same bf16
   rows and the plain version, bit for bit on a repeat, timed beside the
   plain version and the bound, and on 4,097 rows at D = 768 and 2048;
4. K3's own path: ``dwconv7x7`` forward and backward at the four stage
   maps (no model of either package runs K3), with its exact launches;
5. serving: a run directory holding the flagship configuration and tree
   (``artifacts/lou_190_s2/metadata``) and seeded random weights, served by
   ``Predictor`` + ``serve_http`` at full width (ConvNeXt-tiny-26, 224^2,
   bf16); GET /healthz, three POST /predict and one POST /predict_batch;
   the kernel launch counts of those requests; the served answers held
   against the plain head on the same features; ``Predictor.bench()``;
   then the same for a second run directory with the fused-backbone
   configuration (``use_pallas_backbone``: every block's branch through K4),
   held against the plain composition (K4's and K1's plain versions);
6. training, path A: the flagship run config's train step (epoch 20: joint
   phase, backbone unfrozen, mask-prune on) at full width on 64 images in
   two views, through ``make_train_step``: warm-up steps, then timed steps
   with their exact kernel launches (K1 1, K1b 1 per step), step time,
   images/s, the profiler's kernel time and busy share, peak memory, and
   where the step's time goes;
7. training, path B: the same with ``align_eps`` unset and
   ``fuse_align_pf=True`` (K2 1, K1 1 for the backward's recompute, K1b 1
   per step); before it, the two paths' first-step losses from the same
   parameters and batch, and the head gradients through the kernels
   against autograd through the plain composition on the step's features;
8. training, path C: path A's step in the fused-backbone configuration
   (K4 54, three launches for each of the 18 blocks; K1 1, K1b 1 per
   step); before it, path A's and path C's first-step losses from the
   same parameters and batch, and one stage-3 block's gradients through
   ``FusedCNBlock`` against autograd through the unfused composition;
9. training from data: the flagship run's dataset (``synthetic:190:48:s1``)
   generated by the port at 8 images a class, its loaders as the JAX
   package's CLI builds them (batch 64, the flagship's leave-out list,
   device geometric), the tree built from the fixture's phylogeny and
   checked against the flagship's (189 nodes, 3780 prototypes), the
   device-resident uint8 cache of the 232^2 bases, and path A's step fed
   ``cache.fetch(rows)`` of the epoch's index batches (device transform1
   and transform2 inside the step): warm-up and timed steps with their
   exact launches (K1 1, K1b 1 per step), step time, images/s and busy
   share; then one batch's augmentation timed on the card and held to the
   same functions on the CPU for the same draws (within one grey level),
   and the eval cache's normalized batch held to the host
   ``EvalTransform`` (within 2e-6);
10. flat PIP-Net (the flagship config with ``num_features`` 768 and no
   per-child budget, one node of 768 prototypes over 200 generated classes;
   seeded weights, the add-on kernel scaled so the softmax over 768 peaks):
   a run directory served as in 5 (K1 twice per forward: the row statistics
   over the node's parts, then the pass that writes), path A (K1 2, K1b 2
   per step), the path A / B cross-checks, and path B (K2 3, K1 2, K1b 2);
11. training through the CLI: ``pipnet_tpu_torch.main.run_pipnet`` in this
   process with the flags of ``scripts/runs/run_lou_190.sh``, changed only
   to the data phase's fixture, 2 epochs after 1 of pretraining and an
   evaluation every epoch (its leave-out list as an absolute path, a
   temporary ``--log_dir``), then ``--resume --epochs 3`` on the same
   directory: every epoch and evaluation with its seconds, images/s and
   exact launches (K1 once a step and once an evaluation batch, K1b once
   a step where the backbone or the add-on trains), finite losses, the
   run directory's files and checkpoints; the run served by ``Predictor``
   with logits equal to the trainer's own on the same batch, and
   ``Trainer.evaluate`` from the test cache equal to the host-streamed
   one; then ``Trainer.run_epoch`` at epoch 20 of the flagship's 40 (the
   joint phase, mask-prune on) from the cache: step time by CUDA events,
   images/s, busy share, host waits and the synchronising lines (only the
   read at the epoch's end is allowed, beside the augmentation's
   side-stream wait);
12. evaluation: ``pipnet_tpu_torch.evaluate.run`` on the run directory
   phase 11 trained (with ``--only eval``: one written from seeded weights,
   evaluated on the data phase's fixture), with the flagship's leave-out
   list, then again with the overspecificity mask (``--fixed_mask_seed
   0``): each report's keys against ``artifacts/lou_190_s2/
   eval_report_lou.json`` plus 189 ``per_node`` entries, its seconds, and
   exactly one K1 launch an evaluation batch in each of its three passes
   (``Trainer.evaluate``, the collecting sweep, ``evaluate_per_node``);
   one masked pass timed by CUDA events (seconds, images/s) and profiled
   (busy share); one batch's masked forward through K1 against the plain
   composition on the same presence sample (the serving bar); the card's
   presence samples against the CPU's for the same seeds (equal); a
   masked ``Predictor`` answering requests, its logits equal to the eval
   step's on the same sample;
13. interpretability, on the same run directory (with ``--only interp``:
   one of seeded weights, on the data phase's fixture): the projection
   (``interp/topk.py::run_projection``, K1 a batch of 32) timed and
   profiled, one batch of it against the plain composition; ``evaluate.run``
   with the flagship evaluation script's pruning sweep (``--threshold_prune
   0.1,...,0.5``) and part purity on synthetic annotation files, again with
   ``--threshold_prune 0.4 --prune_leaf_parents``, and with
   ``--galleries_nodes`` on a leaf-parent node and the smallest node with an
   internal child: the reports' keys against
   ``artifacts/sparse_190/eval_report.json`` and ``head.cls_weight``
   restored bit for bit; ``main.py::final_galleries`` on those nodes;
   ``Predictor.explain`` on two images and the serve CLI's ``--explain`` on
   one (the folder layout); the adversarial attack (40 steps) and
   integrated gradients (50 steps) at B = 1, their image gradients through
   K1b; MIPS over 256 test images against the CPU's product; each part's
   K1 and K1b launches derived from the code and checked exactly, and its
   seconds.  The kernel phase also holds K1b at B = 1 (only g_pf in one
   column, only g_pooled), as the attack and integrated gradients run it;
14. the other backbones and interop (the kernel phase first holds K1, K1b
   and K2 on the flagship tree at their head shapes: 28x28x2048 and
   16x16x384, bf16 at B = 8 and 128 (K2 at 64 pairs), f32 at B = 8):
   run directories of the flagship config and tree with ``resnet50`` and
   ``dinov2_vits14`` (seeded weights and BatchNorm statistics) served as
   in 5; ResNet-50 path A and path B (with 3's cross-checks) and ViT-S/14
   path A as in 6 and 7, with exact launches; ResNet-50's BatchNorm
   statistics after one f32 step against the CPU's plain step; the ViT's
   position-embedding resize against the CPU's; BYOL on the flagship
   ConvNeXt (pretraining and joint phases: K1 1, K1b 1 a step, the EMA
   target against tau * t + (1 - tau) * theta); the ResNet-50 run exported
   by the port's CLI and re-imported by ``convert_reference_pipnet``, its
   logits equal bit for bit;
15. the options that once raised (the kernel phase first holds K1, K1b
   and K2 on the flagship tree at the stage-4 reducer's width, 26x26x128,
   as at the other backbones' widths): path A with the JAX CLI's default
   ``align`` and ``uni`` losses on (pretraining at epoch 1, joint at 20)
   beside path A without them, and the two losses' forward and backward
   alone on the step's 43,264 patch rows a view; a step with an OOD chunk
   of 64 images of ``synthetic:20:24:s9`` (the OOD set of
   ``scripts/runs/eval_full_phase_190.sh``) beside the 64 labelled ones;
   each head variant (unit, project and l2 add-ons, add-on bias, no
   softmax, Gumbel, spatial, cosine-multiplied, focal) served at B = 8 off
   K1 (0 launches), its f32 head on the card against the CPU's on the same
   features, and the unit head trained; the Gaussian multiplier (stages 3
   and 4) with the reducer served as in 5 and trained on path A, and with
   the fused-backbone configuration (which the multiplier leaves: no K4);
   one f32 joint step with every option and an OOD row on the card
   against the CPU's; ``run_pipnet`` with the CLI's defaults for
   ``--align``/``--uni`` and ``--OOD_dataset`` (one pretraining and two
   joint epochs on ``synthetic:190:2``); every path's launches checked
   exactly;
16. the train step on a data mesh (``runtime/mesh.py``): path A's flagship
   step through the mesh step on a process group of one rank through NCCL
   against path A's step on the same parameters and batch (loss, metrics,
   head gradients), both timed in turns with the mesh step's launches (K1
   1, K1b 1 a step) and busy share; then two ranks on the one card through
   gloo on CUDA tensors (NCCL takes one rank a card), 32 of the 64 images
   each, against the one-process step (loss, head gradients, each rank's
   K1 and K1b in each step), and ZeRO-1's update against the plain one on
   each rank; a rank that fails fails the phase.  Multi-card times are not
   measured (one card);
17. the train step on a model axis (``--model_parallel``): two ranks of a
   (1, 2) mesh on the one card through gloo on CUDA tensors, each holding
   half of the head's 3840 prototype columns (and their moments) and the
   whole batch, with ``use_pallas_head`` off: first one evaluation pass
   (``Trainer.evaluate``, 2 batches of 32 seeded images) on the head
   gathered whole (K1 once a batch), its report equal to a one-process
   Trainer's on the same model and to the parent's; then two joint steps
   in bf16 (64 images in two views) and in f32 with TF32 off (32 images)
   against the one-process step with the composed head on the same seeded
   parameters and batch (loss, metrics, whole head gradients, updated head
   parameters), each rank launching none of K1, K1b and K2; three bf16
   steps timed on each rank, with its peak memory, beside the one-process
   composed step's and path A's; one step in the fused-backbone
   configuration (K4 54 a step a rank) against the one-process step.  A
   rank that fails fails the phase;
18. the f32 kernel configuration: the flagship run config with
   ``compute_dtype`` float32 (the port's default) and TF32 off, at full
   width and depth on seeded weights: served at B = 8 through ``Predictor``
   with the head kernel (K1 1 a forward), then also with the fused backbone
   (K4 54 a forward: three launches a block), each forward's answers
   against the plain composition (K1's and K4's plain versions) on the same
   images; paths A (K1 1, K1b 1 a step), C (K4 54 with them) and B (K2
   1, then K1 1 and K1b 1 in its backward; align_eps unset) at 64 images
   in two views at epoch 20: C's first-step loss within 1e-4 relative of
   A's from the same parameters and batch, B's of a path-A step with
   align_eps unset, then 3 warm-up and 5 timed steps with exact launches,
   step time, peak memory, busy share and the largest kernels.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  ``--only blocks`` runs
phases 1, 2 and the K3 and K4 checks of phase 3, ``--only uniform`` phases
1, 2 and the K5 and K5b checks of phase 3, ``--only data`` phases
1, 2 and 9, ``--only trainer`` phases 1, 2 and 11, ``--only eval`` phases
1, 2 and 12, ``--only interp`` phases 1, 2 and 13, ``--only backbones``
phases 1, 2, the kernel checks at the other backbones' shapes and 14,
``--only options`` phases 1, 2, the kernel checks at the reducer's width
and 15, ``--only mesh`` phases 1, 2 and 16, ``--only model`` phases 1, 2
and 17, ``--only f32`` phases 1, 2, the f32 K1, K2 and K4 checks of
phase 3 and 18, then each stops without either line: neither can pass for a full run.  Without a CUDA card, or without the rest of the repository
beside it, it exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_META = os.path.join(REPO, "artifacts", "lou_190_s2", "metadata")
RUN_DIR = os.path.join(REPO, "build", "smoke_run")
# flat PIP-Net (Nauta et al., CVPR 2023, CUB-200-2011): one node of 768
# prototypes (num_features; one per ConvNeXt-tiny-26 channel) over 200
# classes, named cub_001 .. cub_200 here (no dataset is read)
FLAT_FEATURES, FLAT_CLASSES = 768, 200
# the flat head's seeded add-on kernel is scaled so that its logits F K
# spread with this standard deviation over the served images: from the
# xavier scale a softmax over 768 prototypes is nearly uniform (every
# pooled value under the 0.1 inference cut), as no trained head's is
FLAT_LOGIT_STD = 6.0
# the test fixtures' trees (MULTI_NEWICK, MIXED_NEWICK, the flat trees) are
# those of tests/torch_port_util.py, which imports no JAX until asked to
FIXTURES = os.path.join(REPO, "tests")
KERNEL_SOURCES = ["fused_head", "head_backward", "fused_head_nopf", "dwconv", "cnblock",
                  "uniform_pairs"]

# H100 SXM published peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# K1's tolerances: f32 (TF32 off) differs from the plain version only by
# the product's summation order, pf and pooled within 1e-5; bf16 pf is
# rounded from f32 values that differ that way, so it may land one bf16 ulp
# apart: within 2^-7 of each plain value (an ulp is 2^-8 to 2^-7 of a
# value), beyond a floor at f32's least normal (exponentials of slots at the
# clip, flushed to zero); pooled is taken in f32 before the cast, within
# 1e-5 in both dtypes
TOL = {torch.float32: {"pf_abs": 1e-5, "pf_rel": 0.0, "pooled": 1e-5},
       torch.bfloat16: {"pf_abs": 2.0 ** -126, "pf_rel": 2.0 ** -7, "pooled": 1e-5}}
# the served head against the plain head on the same features: pooled values
# within 4e-3 (the kernel check above holds K1 itself to 1e-5)
SERVED_POOLED_TOL = 4e-3
# K1b writes dz in pf's dtype from f32 arithmetic that differs from the
# plain version's by summation order: f32 to 1e-5 relative, bf16 within one
# bf16 ulp (2^-7 relative); K2's outputs are f32 in both dtypes (bf16
# products are exact in f32), pooled to 1e-5 and logsum, a sum over 676
# patches of logs, to 1e-5 relative
DZ_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
LOGSUM_REL = 1e-5
# K3 and K4, relative to the output's largest value: f32 (TF32 off) differs
# from the plain version only by summation order (K3: the same 49 taps, fused
# multiply-adds against a multiply and an add; K4 also its products' order
# and the device's tanhf/erff/rsqrtf), so within 1e-5 (K3) and 2e-5 (K4);
# a bf16 output is one rounding of f32 values that differ that way, so within
# one bf16 ulp of the largest output (2^-7), and a z or h1 element of K4 that
# rounds the other way moves the output far less
DW_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
BLOCK_REL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
# fused-backbone serving against the plain composition: the two backbones
# round each of the 18 block outputs to bf16 from f32 values that differ by
# summation order, so features drift apart by bf16 ulps over the blocks; pooled
# softmax values (at most 1) within 2^-6, logits within 2^-4 of the largest
FUSED_SERVING_TOL = {"pooled": 2.0 ** -6, "logits_rel": 2.0 ** -4}
# the ConvNeXt-tiny-26 stage maps at 224^2: (H, W, C) of each stage's blocks
STAGES = ((56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768))
# the blocks' batch in a train step (64 images in two views) and in serving
STEP_IMAGES, SERVE_IMAGES = 128, 8
# the flagship train step (bench.py:114-130, the flagship run config)
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 64, 3, 10
# training from data: the flagship run's dataset (synthetic:190:48:s1) cut
# from 48 to 8 images a class (1520 train images) to fit the run's time
DATA_FIXTURE = "synthetic:190:8:s1"
# training through the CLI: the flagship's own command line, run with the
# data phase's fixture, one pretraining epoch and two training epochs
FLAGSHIP_SCRIPT = os.path.join(REPO, "scripts", "runs", "run_lou_190.sh")
CLI_CHANGES = {"--dataset": "synthetic:190:8", "--epochs": "2", "--epochs_pretrain": "1",
               "--eval_every": "1"}
# the joint phase (backbone unfrozen, mask-prune on) that Trainer.run_epoch
# times from the cache
JOINT_EPOCH = 20


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_tree():
    from pipnet_tpu_torch.models.pipnet import assign_prototype_budgets
    from pipnet_tpu_torch.run_io import load_run_config
    from pipnet_tpu_torch.tree import Node, compile_tree
    with open(os.path.join(FLAGSHIP_META, "tree.json")) as f:
        root = Node.from_dict(json.load(f))
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        classes = json.load(f)
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    assign_prototype_budgets(root, cfg.model)
    return compile_tree(root, class_names=classes, protopool=cfg.model.head.protopool,
                        weighted=cfg.train.loss.weighted_ce), cfg


@dataclasses.dataclass
class Setup:
    """A model configuration that the smoke run serves and trains: the
    flagship run config with the changes ``model`` to its model section, a
    tree (as a run directory's ``metadata/tree.json`` holds it) and classes,
    and seeded random weights, whose add-on kernel is scaled so that F K has
    the standard deviation ``logit_std`` on the served images where that is
    set (the factor is measured once).  ``wide_node``: the tree has a node
    wider than every head kernel's column tile, which K1 and K1b run in two
    launches a call (row statistics over its parts, then the pass that
    writes) and K2 in three (its third adds each row's parts and takes the
    log sums)."""
    name: str
    model: dict
    tree_json: dict
    classes: list
    wide_node: bool = False
    logit_std: float = None
    kernel_scale: float = None


def flagship_setup() -> Setup:
    with open(os.path.join(FLAGSHIP_META, "tree.json")) as f:
        tree_json = json.load(f)
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        classes = json.load(f)
    return Setup("", {}, tree_json, classes)


def flat_setup() -> Setup:
    """Flat PIP-Net: ``num_features`` 768, no per-child budget, the flat tree
    over the generated classes unbudgeted, as a flat run saves it."""
    from pipnet_tpu_torch.tree import flat_tree
    from torch_port_util import flat_classes
    classes = flat_classes(FLAT_CLASSES)
    return Setup("flat", {"num_features": FLAT_FEATURES, "num_protos_per_child": 0},
                 flat_tree(classes, FLAT_FEATURES).to_dict(), classes, wide_node=True,
                 logit_std=FLAT_LOGIT_STD)


def check_fused_head(tree, B, H, W, D, dtype, seed, timed=False, tau=1.0, baseline=None):
    """K1 against its plain version on the card; returns a result record.
    With ``baseline`` (``baseline_kernels``) a timed record also holds an
    older checkout's K1 timed in turns with this one."""
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    P = tree.num_protos_padded
    f, k = _features_and_kernel(tree, B, H, W, D, dtype, seed)
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree, tau=tau)
        torch.cuda.synchronize()
        pf_r, pooled_r = fused_head_reference(f, k, tree, tau=tau)
    if pf.shape != (B, H, W, P) or pooled.shape != (B, P) or pf.dtype != dtype:
        fail(f"fused head output shapes {tuple(pf.shape)} {tuple(pooled.shape)} {pf.dtype}")
    if not (torch.isfinite(pf.float()).all() and torch.isfinite(pooled).all()):
        fail("fused head gave non-finite values")
    tol = TOL[dtype]
    valid = torch.from_numpy(tree.proto_valid).cuda()
    ref = pf_r.float().abs()
    err = (pf.float() - pf_r.float()).abs()
    over = (err - tol["pf_rel"] * ref - tol["pf_abs"]).max().item()
    # a typical pf value (the median over real slots, every 7th taken) sets
    # the scale of the errors: most pf values of a wide node are far below
    # any absolute bar
    typical = ref[..., valid].flatten()[::7].median().item()
    rec = {"shape": [B, H, W, D, P], "dtype": _dtype_name(dtype), "tau": tau,
           "buckets": [[b.num_nodes, b.width] for b in tree.buckets],
           "pf_max_abs_err": err.max().item(),
           "pf_max_rel_err": (err / ref.clamp(min=2.0 ** -126)).max().item(),
           "pf_typical": typical, "pf_max_abs_err_over_typical": err.max().item() / max(typical, 2.0 ** -126),
           "pooled_max_abs_err": (pooled - pooled_r).abs().max().item(),
           "padded_slots_zero": bool((pf[..., ~valid] == 0).all().item())}
    del ref, err
    if over > 0 or rec["pooled_max_abs_err"] > tol["pooled"] or not rec["padded_slots_zero"]:
        fail(f"fused head disagrees with its plain version: {rec}, tolerance {tol}")
    if timed:
        with torch.inference_mode():
            rec["ms"] = time_ms(lambda: fused_head(f, k, tree, tau=tau))
            rec["plain_ms"] = time_ms(lambda: fused_head_reference(f, k, tree, tau=tau))
            f2 = f.reshape(-1, D)
            rec["library_ms"] = time_ms(lambda: torch.matmul(f2, k))
            if baseline is not None:
                rec.update(in_turns(lambda: fused_head(f, k, tree, tau=tau), baseline))
        covered = int(sum(b.num_nodes * b.width for b in tree.buckets))
        es = f.element_size()
        rec.update(bound((f.numel() + k.numel() + pf.numel()) * es + pooled.numel() * 4,
                         2.0 * B * H * W * D * covered, dtype))
    return rec


def bound(nbytes: float, ops: float, dtype, f32_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type (``ops`` in ``dtype``, plus
    ``f32_ops`` on the f32 SIMT units), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype] + f32_ops / PEAK_FLOPS[torch.float32]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": ops + f32_ops}


def _features_and_kernel(tree, B, H, W, D, dtype, seed):
    r = np.random.default_rng(seed)
    P = tree.num_protos_padded
    limit = np.sqrt(6.0 / (D + P))           # the add-on's xavier-uniform scale
    f = torch.from_numpy(r.standard_normal((B, H, W, D)).astype(np.float32))
    k = torch.from_numpy(r.uniform(-limit, limit, (D, P)).astype(np.float32))
    return f.to("cuda", dtype), k.to("cuda", dtype)


def check_head_backward(tree, B, H, W, D, dtype, seed, timed=False, baseline=None,
                        cotangents="both"):
    """K1b against its plain version on the card, on pf from the forward at
    the same shape and random cotangents; returns a result record (with
    ``baseline``, as ``check_fused_head``).  ``cotangents``: "both" (random
    g_pf and g_pooled, the train step's), "pf_column" (g_pf non-zero in one
    prototype's column only and g_pooled zero: the adversarial attack's) or
    "pooled_only" (g_pf None and one non-zero g_pooled entry per image:
    integrated gradients')."""
    from pipnet_tpu_torch.ops.fused_head import (fused_head, head_backward,
                                                 head_backward_reference)
    f, k = _features_and_kernel(tree, B, H, W, D, dtype, seed)
    with torch.inference_mode():
        pf, _ = fused_head(f, k, tree)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        P = pf.shape[-1]
        g_pf = torch.randn(pf.shape, generator=gen, device="cuda").to(dtype)
        g_pooled = torch.randn((B, P), generator=gen, device="cuda")
        column = int(np.flatnonzero(tree.proto_valid)[seed % int(tree.proto_valid.sum())])
        if cotangents == "pf_column":
            g_pf = torch.where(torch.arange(P, device="cuda") == column, g_pf,
                               torch.zeros_like(g_pf))
            g_pooled = torch.zeros_like(g_pooled)
        elif cotangents == "pooled_only":
            g_pf = None
            g_pooled = torch.where(torch.arange(P, device="cuda") == column, 1.0, 0.0
                                   ).expand(B, P).contiguous()
        dz = head_backward(pf, g_pf, g_pooled, tree)
        torch.cuda.synchronize()
        ref = head_backward_reference(pf, g_pf, g_pooled, tree)
        err = (dz.float() - ref.float()).abs()
        over = (err - DZ_REL[dtype] * ref.float().abs()
                - 1e-6 * ref.float().abs().max()).max().item()
        rec = {"shape": [B, H, W, pf.shape[-1]], "dtype": _dtype_name(dtype),
               "cotangents": cotangents,
               "dz_max_abs_err": err.max().item(), "dz_scale": ref.float().abs().max().item()}
        if over > 0 or not torch.isfinite(dz.float()).all():
            fail(f"head backward disagrees with its plain version: {rec}")
        if timed:
            rec["ms"] = time_ms(lambda: head_backward(pf, g_pf, g_pooled, tree))
            rec["plain_ms"] = time_ms(lambda: head_backward_reference(pf, g_pf, g_pooled, tree),
                                      iters=5)
            rec["library_ms"] = None       # no single PyTorch call computes this
            if baseline is not None:
                rec.update(in_turns(lambda: head_backward(pf, g_pf, g_pooled, tree), baseline))
            es = pf.element_size()
            # each input read once, dz written once: pf, g_pf (when given), dz
            rec.update(bound((pf.numel() * (2 + (g_pf is not None))) * es
                             + g_pooled.numel() * 4, 5.0 * pf.numel(), torch.float32))
    return rec


def check_nopf(tree, pairs, H, W, D, dtype, seed, timed=False, tau=1.0, baseline=None):
    """K2 against its plain version on the card; returns a result record
    (with ``baseline``, as ``check_fused_head``)."""
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    from pipnet_tpu_torch.losses.catalog import ALIGN_EPS
    from pipnet_tpu_torch.ops.fused_head import head_plan, plan_launches
    f, k = _features_and_kernel(tree, 2 * pairs, H, W, D, dtype, seed)
    with torch.inference_mode():
        before = fused_head_nopf.launches
        pooled, logsum = fused_head_nopf(f, k, tree, tau=tau, eps=ALIGN_EPS)
        launches = fused_head_nopf.launches - before
        again = fused_head_nopf(f, k, tree, tau=tau, eps=ALIGN_EPS)
        torch.cuda.synchronize()
        pooled_r, logsum_r = fused_head_nopf_reference(f, k, tree, tau=tau, eps=ALIGN_EPS)
    rec = {"shape": [2 * pairs, H, W, D, tree.num_protos_padded],
           "dtype": _dtype_name(dtype), "tau": tau,
           "pooled_max_abs_err": (pooled - pooled_r).abs().max().item(),
           "logsum_max_abs_err": (logsum - logsum_r).abs().max().item(),
           "logsum_scale": logsum_r.abs().max().item(), "launches_per_call": launches,
           "two_calls_bitwise_equal": bool(torch.equal(pooled, again[0])
                                           and torch.equal(logsum, again[1]))}
    if not (torch.isfinite(pooled).all() and torch.isfinite(logsum).all()) or \
            rec["pooled_max_abs_err"] > 1e-5 or \
            rec["logsum_max_abs_err"] > LOGSUM_REL * rec["logsum_scale"] + 1e-4:
        fail(f"no-pf head disagrees with its plain version: {rec}")
    want = plan_launches(*head_plan(tree, dtype, f.device), 3)
    if launches != want or not rec["two_calls_bitwise_equal"]:
        fail(f"no-pf head: {launches} launches a call (expected {want}), or two calls "
             f"differ: {rec}")
    if timed:
        with torch.inference_mode():
            rec["ms"] = time_ms(lambda: fused_head_nopf(f, k, tree, tau=tau, eps=ALIGN_EPS))
            rec["plain_ms"] = time_ms(lambda: fused_head_nopf_reference(
                f, k, tree, tau=tau, eps=ALIGN_EPS), iters=5)
            f2 = f.reshape(-1, D)
            rec["library_ms"] = time_ms(lambda: torch.matmul(f2, k))
            if baseline is not None:
                rec.update(in_turns(lambda: fused_head_nopf(f, k, tree, tau=tau, eps=ALIGN_EPS),
                                    baseline))
        covered = int(sum(b.num_nodes * b.width for b in tree.buckets))
        es = f.element_size()
        rec.update(bound((f.numel() + k.numel()) * es + (pooled.numel() + logsum.numel()) * 4,
                         2.0 * f.shape[0] * H * W * D * covered, dtype))
    return rec


BASELINE_SOURCES = ("fused_head", "fused_head_nopf", "head_backward", "dwconv", "cnblock")


@dataclasses.dataclass
class Baseline:
    """An older checkout's kernel libraries; whether its K1b takes a
    plan of groups of ``sv`` 16-byte vectors (``backward_plan``) or is the
    earlier kernel, which ran on the f32 SIMT column plan; whether its
    K1, K2 and K1b take split plans (``split_plan``: whole-node groups and
    parts of wide nodes, GF ints a group) or one plan of (col_start, ncols,
    width) triples of whole nodes; whether its f32 K4 is the earlier
    single fused launch (``pipnet_cnblock_f32``, timed through
    ``_fused_f32_block``; its bf16 K4 is then not timed in turns); and
    whether its K2 takes the f32 kernel's row-tile scratch (z, partial,
    count) or only the parts' (stats, ip; called through
    ``_nopf_parts_scratch``)."""
    libs: dict
    k1b_takes_sv: bool
    takes_split_plan: bool
    fused_f32_block: bool
    nopf_takes_f32_scratch: bool


def baseline_kernels(checkout: str) -> Baseline:
    """K1's, K2's, K1b's and K3's libraries built from an older checkout of
    this repository (e.g. ``git archive`` of a parent commit unpacked under
    the git-ignored ``build/``), with this checkout's flags, for timing in
    turns with the kernels here.  K1 and K2 run on this checkout's column
    plan (``head_plan``), so the older kernels must accept it: those of the
    parent commits took any groups of whole nodes within 128 columns."""
    from pipnet_tpu_torch.ops.build import NVCC_FLAGS, _nvcc
    src = os.path.join(checkout, "pipnet_tpu_torch", "ops", "csrc")
    out = os.path.join(REPO, "build", "baseline_kernels")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in BASELINE_SOURCES:
        lib = os.path.join(out, f"lib{name}.so")
        # without GNU-unique symbols, so that the statics of inline host code
        # (a kernel's "shared-memory limit raised" flag, tensor-map caches)
        # stay the baseline's own and are not bound to this checkout's copy
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o", lib,
             os.path.join(src, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"baseline {name}.cu did not build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].pipnet_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].pipnet_cuda_error_string.restype = ctypes.c_char_p
    with open(os.path.join(src, "head_backward.cu")) as f:
        k1b_src = f.read()
    with open(os.path.join(src, "cnblock.cu")) as f:
        fused_f32 = "int pipnet_cnblock_f32(" in f.read()
    with open(os.path.join(src, "fused_head_nopf.cu")) as f:
        nopf_scratch = "void* z, void* partial, void* count" in f.read()
    takes_split = "const void* whole, int Gw" in k1b_src
    return Baseline(libs, takes_split or "int G, int sv," in k1b_src, takes_split, fused_f32,
                    nopf_scratch)


def _triples(tree, dtype, device, hw=None):
    """``(sv, plan)``: the (G, 3) (col_start, ncols, width) plan that kernels
    older than the split plans take, for trees of whole nodes only: K1's
    and K2's (``head_plan``; sv 0) or, with ``hw`` patch rows, K1b's
    (``backward_plan``), cached on the tree."""
    from pipnet_tpu_torch.ops import fused_head as fh

    def make():
        sv, whole, wide = (fh.backward_plan(tree, dtype, hw, device) if hw
                           else (0, *fh.head_plan(tree, dtype, device)))
        if wide is not None:
            fail("kernels older than the split plans take trees of whole nodes only")
        return sv, whole[:, :3].contiguous()
    return fh._cached_plan(tree, ("triples", str(dtype), hw), device, make)


def _triple_plan_launchers(libs):
    """Launchers of K1, K2 and K1b (with ``sv``) older than the split plans
    (``_triples``), in the place of ``fused_head._launch``,
    ``fused_head_nopf._launch`` and ``fused_head._launch_backward``."""
    from pipnet_tpu_torch.ops import fused_head as fh
    from pipnet_tpu_torch.ops import fused_head_nopf as fn
    from pipnet_tpu_torch.ops.build import check_cuda
    from pipnet_tpu_torch.ops.segment import tree_tensor
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def entry(name, symbol, argtypes):
        fn_ = getattr(libs[name], symbol)
        fn_.argtypes, fn_.restype = argtypes, ctypes.c_int
        return fn_

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k1(features, kernel, tree, tau):
        B, H, W, D = features.shape
        P, dev = tree.num_protos_padded, features.device
        _, groups = _triples(tree, features.dtype, dev)
        valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
        pf = torch.empty((B, H, W, P), dtype=features.dtype, device=dev)
        pooled = torch.empty((B, P), dtype=torch.float32, device=dev)
        code = entry("fused_head", "pipnet_fused_head_forward", [vp] * 6 + [ci] * 5 + [cf, ci, vp])(
            features.data_ptr(), kernel.data_ptr(), valid.data_ptr(), groups.data_ptr(),
            pf.data_ptr(), pooled.data_ptr(), B, H * W, D, P, groups.shape[0], float(tau),
            fh._DTYPE_CODES[features.dtype], stream())
        check_cuda(libs["fused_head"], code, "baseline fused head launch")
        fh.fused_head.launches += 1
        return pf, pooled

    def k2(features, kernel, tree, tau, eps):
        B2, H, W, D = features.shape
        P, N, dev = tree.num_protos_padded, tree.num_nodes, features.device
        _, groups = _triples(tree, features.dtype, dev)
        valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
        proto_node = tree_tensor(tree, "proto_node_i32", tree.proto_node, dev, torch.int32)
        pooled = torch.empty((B2, P), dtype=torch.float32, device=dev)
        logsum = torch.empty((B2 // 2, N), dtype=torch.float32, device=dev)
        code = entry("fused_head_nopf", "pipnet_fused_head_nopf_forward",
                     [vp] * 7 + [ci] * 6 + [cf, cf, ci, vp])(
            features.data_ptr(), kernel.data_ptr(), valid.data_ptr(), groups.data_ptr(),
            proto_node.data_ptr(), pooled.data_ptr(), logsum.data_ptr(), B2 // 2, H * W, D, P,
            N, groups.shape[0], float(tau), float(eps), fh._DTYPE_CODES[features.dtype],
            stream())
        check_cuda(libs["fused_head_nopf"], code, "baseline no-pf head launch")
        fn.fused_head_nopf.launches += 1
        return pooled, logsum

    def k1b(pf, g_pf, g_pooled, tree, tau):
        B, H, W, P = pf.shape
        sv, groups = _triples(tree, pf.dtype, pf.device, H * W)
        dz = torch.empty_like(pf)
        code = entry("head_backward", "pipnet_head_backward", [vp] * 5 + [ci] * 5 + [cf, ci, vp])(
            pf.data_ptr(), None if g_pf is None else g_pf.data_ptr(), g_pooled.data_ptr(),
            groups.data_ptr(), dz.data_ptr(), B, H * W, P, groups.shape[0], sv, float(tau),
            fh._DTYPE_CODES[pf.dtype], stream())
        check_cuda(libs["head_backward"], code, "baseline head backward launch")
        fh.head_backward.launches += 1
        return dz
    return k1, k2, k1b


def _simt_plan_backward(lib):
    """A launcher of the earlier K1b (no ``sv`` argument; the f32 SIMT
    column plan) in the place of ``fused_head._launch_backward``."""
    from pipnet_tpu_torch.ops.build import check_cuda
    from pipnet_tpu_torch.ops.fused_head import _DTYPE_CODES, head_backward
    fn = lib.pipnet_head_backward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def launch(pf, g_pf, g_pooled, tree, tau):
        B, H, W, P = pf.shape
        _, groups = _triples(tree, torch.float32, pf.device)
        dz = torch.empty_like(pf)
        code = fn(pf.data_ptr(), None if g_pf is None else g_pf.data_ptr(),
                  g_pooled.data_ptr(), groups.data_ptr(), dz.data_ptr(), B, H * W, P,
                  groups.shape[0], float(tau), _DTYPE_CODES[pf.dtype],
                  torch.cuda.current_stream().cuda_stream)
        check_cuda(lib, code, "baseline head backward launch")
        head_backward.launches += 1
        return dz
    return launch


def _fused_f32_block(lib, forward):
    """A launcher of the earlier f32 K4 (one fused launch: ``pipnet_cnblock_f32``
    with its ten inputs as one array of pointers, W1 and W2 in nn.Linear's
    layout) in the place of ``cnblock._forward``; other inputs take
    ``forward``."""
    from pipnet_tpu_torch.ops import cnblock as cb
    from pipnet_tpu_torch.ops.build import check_cuda
    fn = lib.pipnet_cnblock_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale, *,
               fast_gelu):
        args = (x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale)
        if x.dtype != torch.float32 or x.device.type != "cuda":
            return forward(*args, fast_gelu=fast_gelu)
        cb.check_cnblock_inputs(*args)
        B, H, W, C = x.shape
        keep = [x, *[t.contiguous() for t in args[1:5]], w1.t().contiguous(), b1.contiguous(),
                w2.t().contiguous(), b2.contiguous(), layer_scale.contiguous()]
        params = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in keep])
        out = torch.empty_like(x)
        code = fn(ctypes.cast(params, ctypes.c_void_p), out.data_ptr(), B, H, W, C,
                  int(fast_gelu), torch.cuda.current_stream().cuda_stream)
        check_cuda(lib, code, "baseline fused block launch")
        cb.cnblock_branch.launches += 1
        return out
    return launch


def _nopf_parts_scratch(lib):
    """The earlier K2's C entry (scratch for the parts only: stats and ip;
    its f32 kernel one block per (column group, pair)) behind this
    checkout's argument list: the f32 row-tile scratch (z, partial, count)
    is dropped."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.pipnet_fused_head_nopf_forward
    fn.argtypes = [vp] * 3 + [vp, ci] * 2 + [vp] * 5 + [ci] * 5 + [cf, cf, ci, vp]
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args[:10], *args[13:])


@contextlib.contextmanager
def baseline_launches(baseline: Baseline):
    """The wrappers launch the baseline libraries."""
    import pipnet_tpu_torch.ops.cnblock as cb
    import pipnet_tpu_torch.ops.dwconv as dw
    import pipnet_tpu_torch.ops.fused_head as fh
    import pipnet_tpu_torch.ops.fused_head_nopf as fn
    saved = (fh.kernel_entry, fn.kernel_entry, dw.kernel_entry, cb.kernel_entry,
             fh._launch_backward, fh._launch, fn._launch, cb._forward)

    def entry(name, symbol, argtypes):
        if name == "fused_head_nopf" and not baseline.nopf_takes_f32_scratch:
            return baseline.libs[name], _nopf_parts_scratch(baseline.libs[name])
        fn_ = getattr(baseline.libs[name], symbol)
        fn_.argtypes, fn_.restype = list(argtypes), ctypes.c_int
        return baseline.libs[name], fn_
    fh.kernel_entry = fn.kernel_entry = dw.kernel_entry = entry
    if baseline.fused_f32_block:
        cb._forward = _fused_f32_block(baseline.libs["cnblock"], cb._forward)
    else:
        cb.kernel_entry = entry
    if not baseline.takes_split_plan:
        fh._launch, fn._launch, fh._launch_backward = _triple_plan_launchers(baseline.libs)
    if not baseline.k1b_takes_sv:
        fh._launch_backward = _simt_plan_backward(baseline.libs["head_backward"])
    try:
        yield
    finally:
        (fh.kernel_entry, fn.kernel_entry, dw.kernel_entry, cb.kernel_entry,
         fh._launch_backward, fh._launch, fn._launch, cb._forward) = saved


def in_turns(call, baseline: Baseline) -> dict:
    """``call`` through the baseline kernels and through this checkout's, in
    the order baseline, this, this, baseline, each by ``time_ms``."""
    out = {"baseline_ms": [], "turns_ms": []}
    for who in ("baseline_ms", "turns_ms", "turns_ms", "baseline_ms"):
        ctx = baseline_launches(baseline) if who == "baseline_ms" else contextlib.nullcontext()
        with ctx:
            out[who].append(time_ms(call, iters=10))
    return out


def kernel_phase(card: str, baseline=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    from torch_port_util import MIXED_NEWICK, MULTI_NEWICK, flat_tree_port, port_tree
    flag, _ = flagship_tree()
    # a tree whose nodes have 2, 3 and 4 children: with per-child budgets
    # max(2, 3 * leaves) it compiles to several bucket widths and a padded tail
    multi = port_tree(MULTI_NEWICK, 2, 3)
    flat = flat_tree_port(FLAT_CLASSES, FLAT_FEATURES)
    bf16, f32 = torch.bfloat16, torch.float32
    # nodes wider than every kernel's tile besides flat PIP-Net's 768: 300 (a
    # part ends inside a 16-byte vector, a padded tail follows), 2000 (the
    # flat tree at 10 prototypes a child), and a narrow bucket with a node of
    # 300 starting off an 8-column boundary (MIXED_NEWICK); 99 rows, D = 72
    wide = [(name, tree, dt) for name, tree in (
        ("flat300", flat_tree_port(FLAT_CLASSES, 300)),
        ("flat2000", flat_tree_port(FLAT_CLASSES, 2000)), ("mixed", port_tree(MIXED_NEWICK)))
        for dt in (f32, bf16)]
    # the edges of the bf16 kernels' tiling: 9x11 = 99 rows (not a multiple
    # of the 128-row tile), D = 72 (not a multiple of the 64-deep stage),
    # bucket widths 6, 9, 15, 30 (none divides the 128-column tile), groups
    # narrower than the tile, starting off an 8-column boundary, a padded
    # tail, one image (one pair), tau = 0.5
    ragged = [(f"multi_bucket_b1_tau05_{_dtype_name(dt)}", multi, (1, 9, 11, 72), dt, 0.5)
              for dt in (f32, bf16)] + [("flagship_b1_tau05_bf16", flag, (1, 26, 26, 768),
                                         bf16, 0.5)]
    records = f32_head_checks(baseline)
    for name, tree, shape, dtype, timed in (
            ("flagship_bf16", flag, (8, 26, 26, 768), bf16, True),
            ("flagship_train_bf16", flag, (128, 26, 26, 768), bf16, True),
            ("multi_bucket_f32", multi, (3, 9, 11, 72), f32, False),
            ("multi_bucket_bf16", multi, (3, 9, 11, 72), bf16, False)):
        records[name] = check_fused_head(tree, *shape, dtype, seed=len(records), timed=timed,
                                         baseline=baseline)
    for name, tree, shape, dtype, timed in (
            ("flat_bf16", flat, (8, 26, 26, 768), bf16, True),
            ("flat_train_bf16", flat, (128, 26, 26, 768), bf16, True)):
        records[name] = check_fused_head(tree, *shape, dtype, seed=len(records), timed=timed)
    for name, tree, dtype in wide:
        records[f"{name}_{_dtype_name(dtype)}"] = check_fused_head(
            tree, 3, 9, 11, 72, dtype, seed=len(records), tau=0.5)
    for name, tree, shape, dtype, tau in ragged:
        records[name] = check_fused_head(tree, *shape, dtype, seed=len(records), tau=tau)
    for name, rec in records.items():
        say(f"kernel fused_head {name}: {json.dumps(rec)} [{card}]")
    backward = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_train_f32", flag, (128, 26, 26, 768), f32, True),
            ("flagship_train_bf16", flag, (128, 26, 26, 768), bf16, True),
            ("multi_bucket_f32", multi, (4, 9, 11, 72), f32, False),
            ("multi_bucket_bf16", multi, (4, 9, 11, 72), bf16, False),
            ("flat_train_bf16", flat, (128, 26, 26, 768), bf16, True),
            ("flat_train_f32", flat, (128, 26, 26, 768), f32, True)) + tuple(
            (f"{name}_{_dtype_name(dt)}", tree, (4, 9, 11, 72), dt, False)
            for name, tree, dt in wide):
        flagship_bf16 = dtype == bf16 and not name.startswith(("flat", "mixed"))
        backward[name] = check_head_backward(tree, *shape, dtype, seed=10 + len(backward),
                                             timed=timed,
                                             baseline=baseline if flagship_bf16 else None)
        say(f"kernel head_backward {name}: {json.dumps(backward[name])} [{card}]")
    # the interpretability phase's K1b: one image, with only g_pf (one
    # prototype's column: the adversarial attack) or only g_pooled
    # (integrated gradients)
    for cot in ("pf_column", "pooled_only"):
        for dtype in (bf16, f32):
            name = f"flagship_b1_{cot}_{_dtype_name(dtype)}"
            backward[name] = check_head_backward(flag, 1, 26, 26, 768, dtype,
                                                 seed=10 + len(backward), timed=True,
                                                 cotangents=cot)
            say(f"kernel head_backward {name}: {json.dumps(backward[name])} [{card}]")
    nopf = f32_nopf_checks(baseline)
    for name, tree, shape, dtype, timed in (
            ("flagship_train_bf16", flag, (64, 26, 26, 768), bf16, True),
            ("multi_bucket_f32", multi, (2, 9, 11, 72), f32, False),
            ("multi_bucket_bf16", multi, (2, 9, 11, 72), bf16, False),
            ("flat_train_bf16", flat, (64, 26, 26, 768), bf16, True)) + tuple(
            (f"{name}_{_dtype_name(dt)}", tree, (2, 9, 11, 72), dt, False)
            for name, tree, dt in wide):
        flagship_bf16 = dtype == bf16 and not name.startswith(("flat", "mixed"))
        nopf[name] = check_nopf(tree, *shape, dtype, seed=20 + len(nopf), timed=timed,
                                baseline=baseline if flagship_bf16 else None)
    for name, tree, shape, dtype, tau in ragged:
        nopf[name.replace("_b1_", "_1pair_")] = check_nopf(tree, *shape, dtype,
                                                           seed=20 + len(nopf), tau=tau)
    for name, rec in nopf.items():
        say(f"kernel fused_head_nopf {name}: {json.dumps(rec)} [{card}]")
    return records, backward, nopf


def f32_head_checks(baseline=None) -> dict:
    """K1 in f32 (TF32 off) at the main path's shapes, timed: the flagship
    tree and flat PIP-Net's node of 768 at the serving batch and at the
    training batch, the flagship's in turns with an older checkout's K1
    with ``baseline``."""
    from torch_port_util import flat_tree_port
    flag, _ = flagship_tree()
    flat = flat_tree_port(FLAT_CLASSES, FLAT_FEATURES)
    records = {}
    for name, tree, B in (("flagship_f32", flag, SERVE_IMAGES),
                          ("flagship_train_f32", flag, STEP_IMAGES),
                          ("flat_f32", flat, SERVE_IMAGES), ("flat_train_f32", flat, STEP_IMAGES)):
        records[name] = check_fused_head(tree, B, 26, 26, 768, torch.float32,
                                         seed=60 + len(records), timed=True,
                                         baseline=baseline if tree is flag else None)
    return records


def f32_nopf_checks(baseline=None) -> dict:
    """K2 in f32 (TF32 off) at the train step's shapes, timed, each in
    turns with an older checkout's K2 with ``baseline``: the flagship tree
    and flat PIP-Net's node of 768 at 64 pairs of 26x26 patches, and the
    flagship tree at ResNet-50's 28x28x2048 at 4 pairs."""
    from torch_port_util import flat_tree_port
    flag, _ = flagship_tree()
    flat = flat_tree_port(FLAT_CLASSES, FLAT_FEATURES)
    H, W, D = BACKBONE_SHAPES["resnet50"]
    records = {}
    for name, tree, shape in (("flagship_train_f32", flag, (64, 26, 26, 768)),
                              ("flat_train_f32", flat, (64, 26, 26, 768)),
                              ("resnet50_train_f32", flag, (4, H, W, D))):
        records[name] = check_nopf(tree, *shape, torch.float32, seed=100 + len(records),
                                   timed=True, baseline=baseline)
    return records


# K5 and K5b against the float64 value of the same rows (the sum relative,
# the gradient relative to each value plus a share of the largest): bf16
# rows, the sum within 1e-4 (distances from f32 accumulators, ~1e-6 off,
# and the tiles' f32 partials), the gradient within 2^-8 (one rounding to
# bf16) plus 1e-3 (m rounded to bf16 before its product, as in the plain
# version); f32 rows, nothing rounded below f32: 1e-5, 1e-5 and 1e-5;
# tests/test_torch_cuda.py gives the same bars
UNIFORM_BARS = {torch.bfloat16: (1e-4, 2.0 ** -8, 1e-3), torch.float32: (1e-5, 1e-5, 1e-5)}


def check_uniform_pairs(n: int, D: int, seed: int, dtype=torch.bfloat16,
                        timed: bool = False) -> dict:
    """K5 and K5b on n unit rows of width D in ``dtype`` (one view of the
    flagship step at n = 43,264, D = 768) against the float64 value of the
    same rows and against the plain version in ``dtype``, repeated bit for
    bit; timed, beside the plain version's time and the bound: the
    products that ``benchmark/flops.py::uniformity_flops`` counts for one
    view (the forward's pairs i < j and m X, not K5b's recomputed Gram)
    over the dtype's peak, and the same with the recomputed Gram
    (``work_bound_ms``)."""
    from pipnet_tpu_torch.ops.uniform_pairs import (UNIFORM_BLOCK, pair_sum_backward_reference,
                                                    pair_sum_reference, uniform_pairs,
                                                    uniform_pairs_backward)
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, D))
    x = torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
    x = x.to("cuda", dtype)
    g = torch.tensor(0.37, device="cuda")
    rec = {"rows": n, "dim": D, "dtype": str(dtype).replace("torch.", "")}
    sum_rel, dx_rel, dx_floor = UNIFORM_BARS[dtype]
    with torch.inference_mode():
        zero_counts()
        s = uniform_pairs(x, 2.0)
        dx = uniform_pairs_backward(x, g, 2.0)
        rec["launches"] = {k: v for k, v in counts().items() if k.startswith("uniform")}
        s2 = uniform_pairs(x, 2.0)
        dx2 = uniform_pairs_backward(x, g, 2.0)
        torch.cuda.synchronize()
        rec["bit_identical_repeat"] = bool(torch.equal(s, s2) and torch.equal(dx, dx2))
        x64 = x.double()
        want = float(pair_sum_reference(x64, 2.0, 1024))
        want_dx = pair_sum_backward_reference(x64, g.double(), 2.0, 1024)
        plain = float(pair_sum_reference(x, 2.0, UNIFORM_BLOCK))
        plain_dx = pair_sum_backward_reference(x, g, 2.0, UNIFORM_BLOCK)
        err = (dx.double() - want_dx).abs()
        scale = want_dx.abs().max().item()
        rec.update(sum=float(s), exact_sum=want, sum_rel_err=abs(float(s) - want) / want,
                   plain_sum_rel_err=abs(plain - want) / want, max_abs_err=err.max().item(),
                   plain_dx_max_abs_err=(plain_dx.double() - want_dx).abs().max().item(),
                   dx_scale=scale)
        within = bool((err <= dx_rel * want_dx.abs() + dx_floor * scale).all())
        del x64, want_dx, plain_dx, err
        if not (within and rec["bit_identical_repeat"] and rec["sum_rel_err"] <= sum_rel
                and rec["launches"] == {"uniform_pairs": 1, "uniform_pairs_backward": 1}
                and bool(torch.isfinite(dx.float()).all())):
            fail(f"K5/K5b disagree with the exact pair sum: {rec}")
        if timed:
            rec["forward_ms"] = time_ms(lambda: uniform_pairs(x, 2.0), iters=5, warmup=1)
            rec["backward_ms"] = time_ms(lambda: uniform_pairs_backward(x, g, 2.0), iters=5,
                                         warmup=1)
            rec["ms"] = rec["forward_ms"] + rec["backward_ms"]
            rec["plain_forward_ms"] = time_ms(lambda: pair_sum_reference(x, 2.0, UNIFORM_BLOCK),
                                              iters=2, warmup=1)
            rec["plain_backward_ms"] = time_ms(
                lambda: pair_sum_backward_reference(x, g, 2.0, UNIFORM_BLOCK), iters=2, warmup=1)
            rec["plain_ms"] = rec["plain_forward_ms"] + rec["plain_backward_ms"]
            rec["library_ms"] = None
            ops = 2.0 * D * (n * (n - 1) / 2.0 + n * n)
            peak = PEAK_FLOPS[dtype]
            rec.update(bound(0.0, ops, dtype))
            rec["work_bound_ms"] = (ops + 2.0 * D * n * n) / peak * 1e3
            rec["forward_bound_ms"] = D * n * (n - 1) / peak * 1e3
            rec["backward_work_bound_ms"] = 4.0 * D * n * n / peak * 1e3
            rec["roofline_pct"] = 100.0 * rec["bound_ms"] / rec["ms"]
            rec["profile"] = profile_ms(lambda: (uniform_pairs(x, 2.0),
                                                 uniform_pairs_backward(x, g, 2.0)), n=2)
    torch.cuda.empty_cache()
    return rec


def uniform_kernel_checks(card: str) -> dict:
    """K5 and K5b at one view of the flagship step (timed) and on 4,097
    rows (two chunks of K5b, the last ragged) at D = 768 and 2048, in bf16
    and in f32 (the f32 configuration's SIMT tiles)."""
    recs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for name, n, D, dtype, timed in (("flagship_bf16", 43264, 768, bf16, True),
                                     ("ragged4097_bf16", 4097, 768, bf16, False),
                                     ("ragged4097_d2048_bf16", 4097, 2048, bf16, False),
                                     ("flagship_f32", 43264, 768, f32, True),
                                     ("ragged4097_f32", 4097, 768, f32, False),
                                     ("ragged4097_d2048_f32", 4097, 2048, f32, False)):
        recs[name] = check_uniform_pairs(n, D, seed=40 + len(recs), dtype=dtype, timed=timed)
        say(f"kernel uniform_pairs {name}: {json.dumps(recs[name])} [{card}]")
    return recs


def _dw_inputs(shape, dtype, seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    k = torch.from_numpy((r.standard_normal((7, 7, shape[-1])) / 7).astype(np.float32))
    return x.to("cuda", dtype), k.to("cuda", dtype)


def _rel_check(what: str, got, want, rel: float, rec: dict) -> None:
    """Fill ``rec`` with the largest error and the output's scale, and fail
    unless ``got`` is finite, of ``want``'s shape and dtype, and within
    ``rel`` of the scale."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rec.update({"max_abs_err": err, "scale": scale})
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got.float()).all() or err > rel * scale:
        fail(f"{what} disagrees with its plain version: {rec}, tolerance {rel} of the scale")


def check_dwconv(shape, dtype, seed, timed=False, baseline=None):
    """K3 against its plain version on the card; the library call is cuDNN's
    depthwise convolution (``F.conv2d(groups=C)``) on the same input (with
    ``baseline``, as ``check_fused_head``)."""
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7, dwconv7x7_reference
    x, k = _dw_inputs(shape, dtype, seed)
    rec = {"shape": list(shape), "dtype": _dtype_name(dtype)}
    with torch.inference_mode():
        out = dwconv7x7(x, k)
        torch.cuda.synchronize()
        _rel_check("depthwise conv (K3)", out, dwconv7x7_reference(x, k), DW_REL[dtype], rec)
        if timed:
            C = shape[-1]
            xc, kc = x.permute(0, 3, 1, 2), k.permute(2, 0, 1).unsqueeze(1).contiguous()
            rec["ms"] = time_ms(lambda: dwconv7x7(x, k))
            rec["plain_ms"] = time_ms(lambda: dwconv7x7_reference(x, k), iters=5)
            rec["library_ms"] = time_ms(lambda: F.conv2d(xc, kc, padding=3, groups=C))
            if baseline is not None:
                rec.update(in_turns(lambda: dwconv7x7(x, k), baseline))
            rec.update(bound((2 * x.numel() + k.numel()) * x.element_size(), 0.0, dtype,
                             f32_ops=2.0 * 49 * x.numel()))
    return rec


def check_dwconv_grad(shape, seed):
    """``DwConv7x7``'s dx (K3 on the flipped kernel) and dw (the plain 49-tap
    reduction) against autograd through cuDNN's depthwise conv, f32 with
    TF32 off: within 1e-4 of the largest gradient (sums of the same products
    in another order)."""
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    x, k = _dw_inputs(shape, torch.float32, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(x.shape, generator=gen, device="cuda")
    C = shape[-1]
    grads = []
    for conv in (dwconv7x7, lambda a, b: F.conv2d(
            a.permute(0, 3, 1, 2), b.permute(2, 0, 1).unsqueeze(1), padding=3,
            groups=C).permute(0, 2, 3, 1)):
        xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
        (conv(xg, kg) * g).sum().backward()
        grads.append((xg.grad, kg.grad))
    rec = {"shape": list(shape), "dtype": "float32"}
    for name, got, want in zip(("dx", "dw"), *grads):
        rec[f"{name}_max_err_over_max"] = ((got - want).abs().max() / want.abs().max()).item()
    if max(rec["dx_max_err_over_max"], rec["dw_max_err_over_max"]) > 1e-4:
        fail(f"depthwise conv gradients disagree with cuDNN's: {rec}")
    return rec


def _block_inputs(shape, dtype, seed):
    """x and the branch's nine parameters at the scales of
    ``random_jax_params``, in the layout ``CNBlock`` passes them: the dense
    kernels w1 (C, 4C) and w2 (4C, C) are views of nn.Linear's weights."""
    r = np.random.default_rng(seed)
    C = shape[-1]

    def n(s, std):
        return torch.from_numpy((r.standard_normal(s) * std).astype(np.float32))
    ts = [n(shape, 1.0), n((7, 7, C), 49 ** -0.5), n((C,), 0.02), 1.0 + n((C,), 0.05),
          n((C,), 0.02), n((4 * C, C), C ** -0.5), n((4 * C,), 0.02),
          n((C, 4 * C), (4 * C) ** -0.5), n((C,), 0.02),
          torch.from_numpy(r.uniform(0.05, 0.2, C).astype(np.float32))]
    ts = [t.to("cuda", dtype) for t in ts]
    ts[5], ts[7] = ts[5].t(), ts[7].t()
    return ts


def check_cnblock(shape, dtype, fast_gelu, seed, timed=False, baseline=None):
    """K4 against its plain version (the Pallas kernel's rounding order) on
    the card, and each of its three launches (``cnblock_dwln``,
    ``cnblock_up``, ``cnblock_down``) against its plain piece on the same
    inputs, at the same bar.  No PyTorch call computes the branch
    (``library_ms`` None); ``unfused_ms`` is the eager composition K4
    replaces; ``parts_ms`` and ``parts_bound_ms`` time each launch alone
    (with ``baseline``, as ``check_fused_head``)."""
    from pipnet_tpu_torch.ops import cnblock as cb
    args = _block_inputs(shape, dtype, seed)
    x, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = args
    rec = {"shape": list(shape), "dtype": _dtype_name(dtype),
           "gelu": "tanh" if fast_gelu else "erf"}
    with torch.inference_mode():
        out = cb.cnblock_branch(*args, fast_gelu=fast_gelu)
        torch.cuda.synchronize()
        _rel_check("fused block (K4)", out,
                   cb.cnblock_branch_reference(*args, fast_gelu=fast_gelu), BLOCK_REL[dtype], rec)
        z = cb.cnblock_dwln_reference(x, dwk, dwb, lns, lnb)
        h1 = cb.cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu)
        parts = {"dwln": (lambda: cb.cnblock_dwln(x, dwk, dwb, lns, lnb), z),
                 "up": (lambda: cb.cnblock_up(z, w1, b1, fast_gelu=fast_gelu), h1),
                 "down": (lambda: cb.cnblock_down(h1, w2, b2, ls),
                          cb.cnblock_down_reference(h1, w2, b2, ls))}
        rec["parts"] = {}
        for name, (launch, want) in parts.items():
            rec["parts"][name] = {}
            _rel_check(f"K4's {name} launch", launch(), want, BLOCK_REL[dtype],
                       rec["parts"][name])
        if timed:
            rec["ms"] = time_ms(lambda: cb.cnblock_branch(*args, fast_gelu=fast_gelu))
            rec["plain_ms"] = time_ms(lambda: cb.cnblock_branch_reference(
                *args, fast_gelu=fast_gelu), iters=5)
            rec["unfused_ms"] = time_ms(lambda: cb.cnblock_branch_unfused(
                *args, fast_gelu=fast_gelu))
            rec["library_ms"] = None       # no single PyTorch call computes the branch
            if baseline is not None:
                rec.update(in_turns(lambda: cb.cnblock_branch(*args, fast_gelu=fast_gelu),
                                    baseline))
            npix, C = x.numel() // shape[-1], shape[-1]
            es = x.element_size()
            nbytes = (2 * x.numel() + sum(a.numel() for a in args[1:])) * es
            # the two products on the tensor cores (bf16) or SIMT units (f32),
            # the 49 depthwise taps in f32
            rec.update(bound(nbytes, 16.0 * npix * C * C, dtype, f32_ops=2.0 * 49 * npix * C))
            rec["parts_ms"] = {name: time_ms(launch) for name, (launch, _) in parts.items()}
            product = 8.0 * npix * C * C
            rec["parts_bound_ms"] = {
                "dwln": bound((2 * x.numel() + 52 * C) * es, 0.0, dtype,
                              f32_ops=2.0 * 49 * npix * C)["bound_ms"],
                "up": bound((5 * npix * C + 4 * C * C + 4 * C) * es, product,
                            dtype)["bound_ms"],
                "down": bound((5 * npix * C + 4 * C * C + 2 * C) * es, product,
                              dtype)["bound_ms"]}
    return rec


def block_kernel_phase(card: str, baseline=None):
    """K3 and K4 against their plain versions (TF32 off, as ``kernel_phase``
    left it): the four stage maps at B=128 in bf16 (timed), f32 shapes,
    small ragged shapes (odd H and W, C not a multiple of the channel tile,
    a ragged last pixel tile), K4 at every map of fused serving (B=8), and
    K3's gradient."""
    last = STAGES[-1]
    dw = {}
    for i, hwc in enumerate(STAGES):
        dw[f"stage{i}_bf16"] = check_dwconv((STEP_IMAGES, *hwc), torch.bfloat16, 30 + i,
                                            timed=True, baseline=baseline)
    dw["stage3_f32"] = check_dwconv((STEP_IMAGES, *last), torch.float32, 34, timed=True)
    # odd maps, C not a multiple of the 32-channel tile; C = 12 and 100 rows
    # that are not 16-byte multiples in bf16 (the direct-load kernel); a map
    # smaller than the 7x7 window
    for shape in ((3, 9, 11, 40), (1, 3, 5, 12), (1, 27, 27, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            dw[f"ragged_{'x'.join(map(str, shape))}_{_dtype_name(dtype)}"] = check_dwconv(
                shape, dtype, 35)
    for name, rec in dw.items():
        say(f"kernel dwconv {name}: {json.dumps(rec)} [{card}]")
    grad = check_dwconv_grad((SERVE_IMAGES, *last), seed=36)
    say(f"kernel dwconv gradients: {json.dumps(grad)} [{card}]")
    blocks = {}
    for i, hwc in enumerate(STAGES):
        blocks[f"stage{i}_bf16"] = check_cnblock((STEP_IMAGES, *hwc), torch.bfloat16, True,
                                                 40 + i, timed=True)
    # every map fused serving gives K4 (B=8; stages 2 and 3 leave a ragged
    # last row tile of the products)
    for i, hwc in enumerate(STAGES):
        blocks[f"stage{i}_b8_bf16"] = check_cnblock((SERVE_IMAGES, *hwc), torch.bfloat16, True,
                                                    (47, 48, 49, 44)[i], timed=True)
    blocks.update(f32_block_checks(baseline))
    for fast_gelu in (True, False):
        g = "tanh" if fast_gelu else "erf"
        for dtype in (torch.float32, torch.bfloat16):
            blocks[f"ragged_{_dtype_name(dtype)}_{g}"] = check_cnblock(
                (2, 9, 11, 40), dtype, fast_gelu, 46)
    for name, rec in blocks.items():
        say(f"kernel cnblock {name}: {json.dumps(rec)} [{card}]")
    return dw, blocks


def f32_block_checks(baseline=None) -> dict:
    """K4 in f32 (TF32 off) at the four stage maps at the training batch and
    at the serving batch (the flagship's tanh GELU; stage 3 at B=8 also
    with erf), and at the ragged shapes of ``tests/test_torch_cuda.py``
    (odd maps, C = 40, one partial tile of the widest stage), each launch
    against its plain piece; the stage maps timed, in turns with an older
    checkout's K4 with ``baseline``."""
    f32, blocks = torch.float32, {}
    for i, hwc in enumerate(STAGES):
        for B, tag in ((STEP_IMAGES, ""), (SERVE_IMAGES, "_b8")):
            blocks[f"stage{i}{tag}_f32"] = check_cnblock((B, *hwc), f32, True, 50 + i,
                                                        timed=True, baseline=baseline)
    blocks["stage3_b8_f32_erf"] = check_cnblock((SERVE_IMAGES, *STAGES[-1]), f32, False, 45,
                                                timed=True)
    for shape in ((1, 7, 5, 768), (2, 27, 27, 96), (1, 3, 5, 16)):
        for fast_gelu in (True, False):
            blocks[f"ragged_{'x'.join(map(str, shape))}_f32_{'tanh' if fast_gelu else 'erf'}"] = \
                check_cnblock(shape, f32, fast_gelu, 47)
    return blocks


def dwconv_op_path(card: str):
    """K3's own path, as a caller of the op takes it (no model of either
    package runs K3): ``dwconv7x7`` forward and backward at the four stage
    maps at B=128 in bf16; each launches K3 twice (forward, and dx on the
    flipped kernel), and nothing else."""
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    inputs = [_dw_inputs((STEP_IMAGES, *hwc), torch.bfloat16, 50 + i)
              for i, hwc in enumerate(STAGES)]
    zero_counts()
    for x, k in inputs:
        xg, kg = x.requires_grad_(), k.requires_grad_()
        out = dwconv7x7(xg, kg)
        out.float().square().mean().backward()
        if not (torch.isfinite(xg.grad.float()).all() and torch.isfinite(kg.grad.float()).all()):
            fail("depthwise conv op path: non-finite gradients")
    torch.cuda.synchronize()
    launches = counts()
    say(f"depthwise conv op path: launches {launches} [{card}]")
    check_launches("depthwise conv op path", launches, {**NO_LAUNCHES, "dwconv": 2 * len(STAGES)})
    return launches


def run_config(setup: Setup, align_eps_unset: bool = False, fused_backbone: bool = False):
    """The flagship run config with ``setup``'s model changes; with
    ``align_eps_unset`` the reference align_pf epsilon, as bench.py's
    training config leaves it; with ``fused_backbone`` the fused-backbone
    configuration."""
    from pipnet_tpu_torch.run_io import load_run_config
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    model = dict(setup.model, use_pallas_backbone=fused_backbone)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))
    if align_eps_unset:
        loss = dataclasses.replace(cfg.train.loss, align_eps=None)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, loss=loss))
    return cfg


def build_model(setup: Setup, cfg, seed: int = 0, device: str = "cuda"):
    """``setup``'s PIPNet for ``cfg`` on the card (or ``device``) at full
    width and depth, with seeded random weights and BatchNorm statistics in
    the JAX layout (``random_jax_variables``; the add-on kernel scaled to
    ``setup.logit_std`` where that is set) converted to the port's:
    (model, tree, weights in the JAX layout)."""
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_variables
    from pipnet_tpu_torch.tree import Node
    model, tree = build_pipnet(Node.from_dict(setup.tree_json), cfg.model,
                               weighted=cfg.train.loss.weighted_ce,
                               class_names=setup.classes, device=device)
    variables = random_jax_variables(cfg.model, tree, seed=seed, backbone=model.backbone)
    params, stats = variables["params"], variables["batch_stats"]
    if setup.logit_std is not None:
        if setup.kernel_scale is None:
            model.load_state_dict(params_from_jax(params, batch_stats=stats))
            std = served_logit_std(model, cfg)
            setup.kernel_scale = setup.logit_std / std
            say(f"{setup.name} weights: add-on kernel scaled by {setup.kernel_scale} "
                f"(logit std {std} -> {setup.logit_std})")
        params["head"]["add_on_kernel"] = params["head"]["add_on_kernel"] * setup.kernel_scale
    model.load_state_dict(params_from_jax(params, batch_stats=stats))
    return model, tree, params


def served_logit_std(model, cfg) -> float:
    """The standard deviation of F K over the served batch's images."""
    from PIL import Image
    from pipnet_tpu_torch.data.augment import EvalTransform
    xs = np.stack([EvalTransform(cfg.model.image_size)(Image.fromarray(im))
                   for im in synthetic_images(8, 256, seed=2)])
    with torch.inference_mode():
        feats = model.features(torch.from_numpy(xs).cuda())
        return (feats.float() @ model.head.add_on_kernel.float()).std().item()


def write_run_dir(run_dir: str, setup: Setup, fused: bool, seed: int = 0) -> None:
    """``setup``'s run directory: the flagship config with its model changes
    (with ``fused``, ``"use_pallas_backbone": true``; the parameter tree is
    the same), its classes and tree, and its seeded weights converted to
    the port's state_dict (``checkpoints/net_trained_last.pt``)."""
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(os.path.join(run_dir, "metadata"))
    os.makedirs(os.path.join(run_dir, "checkpoints"))
    with open(os.path.join(FLAGSHIP_META, "config.json")) as f:
        config = json.load(f)
    config["model"].update(setup.model, use_pallas_backbone=fused)
    for name, obj in (("config.json", config), ("classes.json", setup.classes),
                      ("tree.json", setup.tree_json)):
        with open(os.path.join(run_dir, "metadata", name), "w") as f:
            json.dump(obj, f, indent=2)
    model, _, _ = build_model(setup, run_config(setup, fused_backbone=fused), seed)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(run_dir, "checkpoints", "net_trained_last.pt"))
    del model


def synthetic_images(n: int, size: int, seed: int):
    """Seeded RGB images: three colour ramps per image plus noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size][..., None] / size
    out = []
    for _ in range(n):
        c = r.uniform(0, 255, (3, 3))
        base = (c[0] * xx + c[1] * yy + c[2] * (1 - xx) * (1 - yy)) / 2
        out.append(np.clip(base + r.normal(0, 20, (size, size, 3)), 0, 255)
                   .astype(np.uint8))
    return out


def png_bytes(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def http(url: str, data: bytes = None):
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as r:
        return r.status, json.loads(r.read())


@contextlib.contextmanager
def plain_blocks():
    """Every fused block's branch through K4's plain version
    (``cnblock_branch_reference``) instead of the kernel."""
    import pipnet_tpu_torch.models.convnext as convnext
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch_reference
    kernel = convnext.cnblock_branch
    convnext.cnblock_branch = cnblock_branch_reference
    try:
        yield
    finally:
        convnext.cnblock_branch = kernel


def serving_phase(card: str, setup: Setup, fused: bool = False):
    """Serve ``setup``'s run directory over HTTP; ``fused`` takes the
    fused-backbone configuration (every block's branch through K4)."""
    from PIL import Image
    from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    from pipnet_tpu_torch.serve import Predictor, serve_http

    t0 = time.perf_counter()
    label = ", ".join(["serving"] + ["fused backbone"] * fused + [setup.name] * bool(setup.name))
    run_dir = "_".join([RUN_DIR] + ["fused"] * fused + [setup.name] * bool(setup.name))
    write_run_dir(run_dir, setup, fused)
    pred = Predictor(run_dir, batch_size=8, device="cuda")
    if pred.bundle.cfg.model.use_pallas_backbone != fused:
        fail(f"{label}: the run directory's config did not carry use_pallas_backbone")
    say(f"{label}: run dir written and loaded in {time.perf_counter() - t0:.1f} s "
        f"({len(pred.classes)} classes, P={pred.tree.num_protos_padded}, "
        f"{pred.bundle.cfg.model.backbone}, {pred.bundle.cfg.model.compute_dtype})")
    S = pred.image_size
    single = synthetic_images(3, 256, seed=1)
    batch = synthetic_images(8, 256, seed=2)
    paths = []
    for i, im in enumerate(batch):
        paths.append(os.path.join(run_dir, f"request_{i}.png"))
        Image.fromarray(im).save(paths[-1])

    srv = serve_http(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        zero_counts()
        status, health = http(base + "/healthz")
        served = [http(base + "/predict?topk=3", png_bytes(im)) for im in single]
        status_b, served_b = http(base + "/predict_batch",
                                  json.dumps({"paths": paths, "topk": 3}).encode())
        launches = counts()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("HTTP server thread did not stop")
    if status != 200 or not health.get("ok") or status_b != 200 or \
            any(s != 200 for s, _ in served) or len(served_b) != len(batch):
        fail(f"HTTP answers: healthz {status} {health}, predict "
             f"{[s for s, _ in served]}, predict_batch {status_b}")
    say(f"{label}: /healthz {health}; /predict x3 and /predict_batch x{len(batch)} "
        f"answered; kernel launches during the requests: {launches}")
    # per served forward: one K1 launch (on a wide node two, the row
    # statistics over its parts, then the normalised pass), and with the
    # fused backbone three K4 launches per block (bf16: depthwise +
    # LayerNorm, then the two products); nothing of the training kernels,
    # no K3
    forwards = len(single) + 1
    blocks = sum(pred.model.backbone.depths) if fused else 0
    k1 = 2 if setup.wide_node else 1
    check_launches(label, launches, {**NO_LAUNCHES, "fused_head": k1 * forwards,
                                     "cnblock": 3 * blocks * forwards})
    answers = [body for _, body in served] + served_b

    # the same images through the backbone in the batches the server formed
    # (each single image padded to 8), then the head on the features: the
    # kernels, and the plain composition (the same features through the
    # plain head; with the fused backbone, features from K4's plain version)
    from pipnet_tpu_torch.data.augment import EvalTransform
    xs = np.stack([EvalTransform(S)(Image.fromarray(im)) for im in single + batch])
    head, tree = pred.model.head, pred.tree

    def features():
        chunks = []
        for i in range(len(single)):
            x = np.zeros((8,) + xs.shape[1:], xs.dtype)
            x[0] = xs[i]
            chunks.append(pred.model.features(torch.from_numpy(x).cuda())[:1])
        chunks.append(pred.model.features(torch.from_numpy(xs[len(single):]).cuda()))
        return torch.cat(chunks)

    with torch.inference_mode():
        feats = features()
        if fused:
            with plain_blocks():
                feats_p = features()
        else:
            feats_p = feats
        k = head.add_on_kernel.to(feats.dtype)
        pf_k, pooled_k = fused_head(feats, k, tree, tau=head.cfg.softmax_tau)
        pf_p, pooled_p = fused_head_reference(feats_p, k, tree, tau=head.cfg.softmax_tau)
        # a pooled value within a bf16 ulp of the 0.1 inference cut may round
        # to either side of it (with the fused backbone: within the pooled
        # tolerance); take the plain side there so the logits compare the
        # kernels' values, not the cut
        thr = head.cfg.inference_threshold
        pooled_tol = FUSED_SERVING_TOL["pooled"] if fused else SERVED_POOLED_TOL
        near = (pooled_p - thr).abs() < (pooled_tol if fused else 2.0 ** -9)
        pooled_k = torch.where(near, pooled_p, pooled_k)
        pk, logits_k = head.classify(pooled_k.to(feats.dtype), inference=True)
        pp, logits_p = head.classify(pooled_p.to(feats.dtype), inference=True)
        tau = pred.path_prob_softmax_tau
        logp_k = joint_leaf_log_distribution(logits_k, tree, softmax_tau=tau).float()
        logp_p = joint_leaf_log_distribution(logits_p, tree, softmax_tau=tau).float()
    if not (torch.isfinite(logits_k.float()).all() and torch.isfinite(logp_k).all()):
        fail("served logits or leaf distribution not finite")
    pooled_err = (pooled_k - pooled_p).abs().max().item()
    lk, lp = logits_k.float(), logits_p.float()
    logit_err = (lk - lp).abs().max().item()
    if fused:
        logit_tol = FUSED_SERVING_TOL["logits_rel"] * lp.abs().max() + 2.0 ** -7
    else:
        logit_tol = 2.0 ** -6 * lp.abs() + 2.0 ** -7   # two bf16 ulps
        if setup.wide_node:
            # a logit of a wide node sums its many pooled values (flat: all
            # 768), each of which may round to bf16 one ulp (at most 2^-8
            # below 1) from the plain one
            w = head.effective_cls_weight().float()
            logit_tol = logit_tol + 2.0 ** -8 * w.sum(-1)
    top2 = torch.topk(logp_p, 2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 0.1
    plain_top1 = logp_p.argmax(-1)
    agree_kernel = (logp_k.argmax(-1) == plain_top1)[confident]
    served_top1 = torch.tensor([pred.classes.index(a["class"]) for a in answers]).cuda()
    agree_served = (served_top1 == plain_top1)[confident]
    rec = {"images": len(answers), "pooled_max_abs_err": pooled_err,
           "logits_max_abs_err": logit_err, "near_threshold": int(near.sum().item()),
           "confident_images": int(confident.sum().item()),
           "top1_agree_kernel_vs_plain": int(agree_kernel.sum().item()),
           "top1_agree_served_vs_plain": int(agree_served.sum().item()),
           "active_prototypes_mean": float((pk > 0).sum(-1).float().mean().item())}
    if fused:
        rec["features_rel_l2"] = ((feats.float() - feats_p.float()).norm()
                                  / feats_p.float().norm()).item()
        rec["features_max_abs_err"] = (feats.float() - feats_p.float()).abs().max().item()
    say(f"{label} parity: {json.dumps(rec)} [{card}]")
    if pooled_err > pooled_tol or bool(((lk - lp).abs() > logit_tol).any()):
        fail(f"{label}: served head disagrees with the plain composition: {rec}")
    if rec["confident_images"] == 0 or not bool(agree_kernel.all()) or \
            not bool(agree_served.all()):
        fail(f"{label}: served top-1 disagrees with the plain composition: {rec}")

    bench = pred.bench(iters=30)
    say(f"{label} bench: {json.dumps(bench)} [{card}]")
    breakdown(pred, card, label)
    del pred
    torch.cuda.empty_cache()
    return launches


def breakdown(pred, card: str, label: str) -> None:
    """Where the serving forward's time goes at B=8: device time of each
    stage by CUDA events (back to back, so host gaps count), and the kernel
    time the profiler records for whole forwards (busy share = kernel time
    over forward time)."""
    from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution
    S, tau = pred.image_size, pred.path_prob_softmax_tau
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (pred.batch_size, S, S, 3)).astype(np.float32)).cuda()
    model = pred.model
    with torch.inference_mode():
        feats = model.features(x)
        logits = model.head(feats, inference=True)["logits"]
        rec = {"forward_ms": time_ms(lambda: pred.forward(x), iters=10),
               "backbone_ms": time_ms(lambda: model.features(x), iters=10),
               "head_ms": time_ms(lambda: model.head(feats, inference=True), iters=10),
               "decode_ms": time_ms(lambda: joint_leaf_log_distribution(
                   logits, pred.tree, softmax_tau=tau), iters=10)}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        n = 5
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                pred.forward(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    rec["kernel_ms_per_forward"] = busy_ms if kernels else "not measured"
    if kernels:
        rec["busy_share"] = busy_ms / rec["forward_ms"]
        rec["kernels_per_forward"] = sum(e.count for e in kernels) / n
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        rec["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top}
    rec["host_waits_per_step"] = host_waits(prof, n)
    say(f"{label} breakdown B={pred.batch_size}: {json.dumps(rec)} [{card}]")


def _wrappers() -> dict:
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    from pipnet_tpu_torch.ops.uniform_pairs import uniform_pairs, uniform_pairs_backward
    return {"fused_head": fused_head, "head_backward": head_backward,
            "fused_head_nopf": fused_head_nopf, "dwconv": dwconv7x7, "cnblock": cnblock_branch,
            "uniform_pairs": uniform_pairs, "uniform_pairs_backward": uniform_pairs_backward}


def counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def train_batch(cfg, tree, seed: int = 1):
    """Two views of TRAIN_BATCH seeded images (float, the JAX step's layout)
    and their labels, on the card."""
    r = np.random.default_rng(seed)
    S = cfg.model.image_size
    xs = torch.from_numpy(r.standard_normal((2, TRAIN_BATCH, S, S, 3)).astype(np.float32))
    ys = torch.from_numpy(r.integers(0, tree.num_classes, TRAIN_BATCH))
    return xs[0].cuda(), xs[1].cuda(), ys.cuda()


def train_step(cfg, model, tree, fuse: bool):
    """The joint phase at epoch 20: backbone unfrozen (freeze_epochs 8),
    mask-prune on (mask_prune_start_epoch 20), the unfreeze ramp over."""
    from pipnet_tpu_torch.train import (Scalars, StepStatics, make_train_step,
                                        phase_for_epoch)
    statics = StepStatics(phase=phase_for_epoch(20, cfg.train, pretrain=False),
                          mask_prune_active=True, eta_min_net=5e-6)
    scalars = Scalars(net_t=0.0, net_T=10000.0, epoch_frac=0.5, align_pf_weight=5.0,
                      tanh_weight=2.0)
    return make_train_step(model, tree, cfg, statics, fuse_align_pf=fuse), scalars


WATCHED = ("head.add_on_kernel", "head.cls_weight", "head.proto_presence",
           "backbone.stage3_block2.mlp_in.weight", "backbone.down2_conv.weight")


def watched_params(model, cfg) -> tuple:
    """(parameters the joint step must move, parameters it must not): for
    the ConvNeXt, ``WATCHED`` and the frozen stem; for another backbone the
    head's, the first backbone parameter of the 'train' group and of the
    'backbone' group, and the first of the 'frozen' group (resnet50's stem)
    if it has one."""
    from pipnet_tpu_torch.train import label_params
    if cfg.model.backbone.startswith("convnext"):
        return WATCHED, ("backbone.stem_conv.weight",)
    names = [n for n, _ in model.named_parameters() if n.startswith("backbone.")]
    labels = label_params(names, cfg.model.backbone)
    first = {}
    for n in names:
        first.setdefault(labels[n], n)
    moving = WATCHED[:3] + tuple(first[g] for g in ("train", "backbone") if g in first)
    return moving, tuple(first[g] for g in ("frozen",) if g in first)


def training_phase(card: str, setup: Setup, fuse: bool, fused_backbone: bool = False):
    """One training path of ``setup`` at full width: warm-up steps, then
    timed steps with the kernels' launch counts, then the profiler and a
    breakdown."""
    from pipnet_tpu_torch.train import init_train_state
    name = ("C (K4 backbone, K1, pf materialised)" if fused_backbone else
            "B (K2, fuse_align_pf)" if fuse else "A (K1, pf materialised)")
    name = " ".join([setup.name] * bool(setup.name) + [name])
    t0 = time.perf_counter()
    cfg = run_config(setup, align_eps_unset=fuse, fused_backbone=fused_backbone)
    model, tree, _ = build_model(setup, cfg)
    xs1, xs2, ys = train_batch(cfg, tree)
    step, scalars = train_step(cfg, model, tree, fuse)
    state = init_train_state(model, seed=0)
    params = dict(model.named_parameters())
    watched, still = watched_params(model, cfg)
    before = {n: params[n].detach().clone() for n in watched + still}
    first = None
    for _ in range(WARMUP_STEPS):
        state, m = step(state, xs1, xs2, ys, scalars)
        first = first or {k: float(v) for k, v in m.items()
                          if k == "loss" or k.startswith("loss/")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    acc = None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_counts()
    t1 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        state, acc = step(state, xs1, xs2, ys, scalars, acc=acc)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    launches = counts()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    mean = {k: float(v) / TIMED_STEPS for k, v in acc.items()
            if k == "loss" or k.startswith("loss/") or k == "grad_norm"}
    rec = {"path": name, "batch": TRAIN_BATCH, "views": 2, "timed_steps": TIMED_STEPS,
           "step_ms": step_ms, "images_per_s": TRAIN_BATCH * TIMED_STEPS / host_s,
           "host_step_ms": host_s * 1e3 / TIMED_STEPS,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / TIMED_STEPS for k, v in launches.items()},
           "fine_correct": int(acc["fine_correct"].item()), "n_fine": int(acc["n_fine"].item()),
           "first_step_losses": first, "mean_losses": mean, "setup_s": setup_s}
    bad = [k for k, v in list(first.items()) + list(mean.items()) if not np.isfinite(v)]
    if bad:
        fail(f"training path {name}: non-finite {bad}: {rec}")
    moved = {n: (params[n].detach() - before[n]).abs().max().item() for n in before}
    rec["max_param_change"] = moved
    if any(moved[n] == 0 for n in watched) or any(moved[n] != 0 for n in still):
        fail(f"training path {name}: trainable parameters did not move, or the "
             f"frozen ones did: {moved}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = 3
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            state, _ = step(state, xs1, xs2, ys, scalars)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    rec["kernel_ms_per_step"] = busy_ms if kernels else "not measured"
    if kernels:
        rec["busy_share"] = busy_ms / step_ms
        rec["kernels_per_step"] = sum(e.count for e in kernels) / n
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        rec["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top}
    rec["host_waits_per_step"] = host_waits(prof, n)
    rec["breakdown_ms"] = train_breakdown(cfg, model, tree, state, xs1, xs2, ys, fuse, step_ms)
    say(f"training path {name}: {json.dumps(rec)} [{card}]")
    del model, state, step, acc
    torch.cuda.empty_cache()
    return rec


def train_breakdown(cfg, model, tree, state, xs1, xs2, ys, fuse, step_ms):
    """Where a train step's time goes: each part timed alone by CUDA events,
    back to back (so each part's host launch time counts), with the
    trainable flags the step set; the rest of the step is host gaps and
    the metrics."""
    from pipnet_tpu_torch.losses import LossWeights, compute_total_loss, make_tree_consts
    from pipnet_tpu_torch.train import adam_update, clip_gradients, label_params
    from pipnet_tpu_torch.train.optimizer import base_lrs
    head = model.head
    xs = torch.cat([xs1, xs2])
    ys2 = torch.cat([ys, ys])
    with torch.no_grad():
        feats = model.features(xs)
        out = head(feats, fuse_align_pf=fuse)
    gen = torch.Generator(device="cuda").manual_seed(7)
    g_feats = torch.randn(feats.shape, generator=gen, device="cuda").to(feats.dtype)
    f_in = feats.detach().requires_grad_()

    def backbone():
        model.features(xs, train=True, generator=state.generator).backward(g_feats)

    def head_part():
        o = head(f_in, fuse_align_pf=fuse)
        side = o["align_pf_logsum"] if fuse else o["proto_features"]
        (o["pooled"].float().sum() + side.float().mean()).backward()

    tc = make_tree_consts(tree, xs.device)
    lcfg = dataclasses.replace(cfg.train.loss, mask_prune_overspecific=True,
                               mask_prune_start_epoch=0)

    def losses():
        o = {k: v.detach().requires_grad_(v.is_floating_point()) for k, v in out.items()}
        o["features"] = feats
        loss, _ = compute_total_loss(
            tc, o, ys2, head.effective_cls_weight(), head.add_on_kernel,
            head.proto_presence, head.multiplier[0].detach(), lcfg,
            LossWeights(align_pf=5.0, byol=2.0, tanh=2.0, cl=cfg.train.loss.cl_weight),
            tree=tree, pretrain=False, finetune=False, generator=state.generator)
        loss.backward()

    labels = label_params(state.params, cfg.model.backbone)
    lrs = {n: base_lrs(cfg.train.optim)[labels[n]] for n in labels}
    masks = {n: p.grad is not None for n, p in state.params.items()}

    def optimiser():
        grads = {n: p.grad for n, p in state.params.items()}
        grads, _ = clip_gradients(grads, labels, cfg.train.optim.clip_grad, per_group=True)
        adam_update(state.params, grads, state.opt, lrs, masks)

    parts = {name: time_ms(fn, iters=5, warmup=1) for name, fn in (
        ("backbone_fwd_bwd", backbone), ("head_fwd_bwd", head_part),
        ("losses_fwd_bwd", losses), ("optimiser", optimiser))}
    parts["rest_host_gaps_metrics"] = step_ms - sum(parts.values())
    return parts


def profile_ms(fn, n: int = 3, top: int = 8) -> dict:
    """Device time of ``fn`` by the profiler, per call: the kernels' total,
    their count, and the largest by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"kernel_ms": "not measured"}
    big = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / n,
            "kernels": sum(e.count for e in kernels) / n,
            "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 / n for e in big}}


def host_waits(prof, n: int) -> dict:
    """Where the host waited for the card in a profile of ``n`` steps: the
    count and host ms of each kind of wait, per step.  A stream wait drains
    the queue the host had run ahead with."""
    return {e.key: {"count": e.count / n, "ms": e.cpu_time_total / 1e3 / n}
            for e in prof.key_averages()
            if e.key in ("cudaStreamSynchronize", "cudaEventSynchronize",
                         "aten::_local_scalar_dense")}


def sync_points(fn) -> list:
    """Where ``fn`` makes a synchronizing CUDA call
    (``torch.cuda.set_sync_debug_mode``'s warnings): for each, the innermost
    frame of the port's own code on the stack when it warned, as
    ``path:line (function)`` (the warning itself may point into torch)."""
    import traceback
    import warnings
    port = os.path.join(REPO, "pipnet_tpu_torch") + os.sep
    found = set()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return              # e.g. the debug mode's own notice as it turns on
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(port)]
        where = ours[-1] if ours else None
        found.add(f"{os.path.relpath(where.filename, REPO)}:{where.lineno} ({where.name})"
                  if where else f"{os.path.relpath(filename, REPO)}:{lineno} (outside the port)")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted(found)


def data_phase(card: str):
    """Training from data: the flagship's synthetic dataset cut to
    ``DATA_FIXTURE``, its loaders as the JAX package's CLI builds them, the
    device-resident uint8 cache, and path A's step fed the cache's 232^2
    bases (device transform1 and transform2 in the step); then the
    augmentation on the card against the same functions on the CPU for the
    same draws, and the eval cache against the host ``EvalTransform``."""
    from PIL import Image
    from pipnet_tpu_torch.data import EvalTransform, build_device_cache, build_loaders
    from pipnet_tpu_torch.datasets import resolve_dataset
    from pipnet_tpu_torch.device import host_to_device
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.ops.device_augment import two_view_transform2
    from pipnet_tpu_torch.ops.device_geometric import transform1_batch
    from pipnet_tpu_torch.train import augment_views, init_train_state, sample_augment
    from pipnet_tpu_torch.tree import build_tree_from_config
    rec = {"dataset": DATA_FIXTURE, "batch": TRAIN_BATCH, "views": 2,
           "timed_steps": TIMED_STEPS}
    t0 = time.perf_counter()
    train_dir, test_dir, _, dkw = resolve_dataset(DATA_FIXTURE)
    rec["fixture_s"] = time.perf_counter() - t0
    cfg = run_config(flagship_setup())
    S = cfg.model.image_size
    with open(os.path.join(REPO, cfg.leave_out_classes)) as f:
        leave_out = [line.strip() for line in f if line.strip()]
    # as pipnet_tpu/main.py builds them, with --device_augment full (its default)
    loaders = build_loaders(
        train_dir, test_dir, image_size=S, batch_size=TRAIN_BATCH,
        batch_size_pretrain=cfg.train.batch_size_pretrain, seed=cfg.train.seed,
        weighted=cfg.weighted_sampler, leave_out_classes=leave_out,
        disable_transform2=cfg.disable_transform2, validation_size=cfg.validation_size,
        num_workers=cfg.num_workers, device_photometric=True, device_geometric=True)
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        if loaders.classes != json.load(f):
            fail("the fixture's classes differ from the flagship's metadata/classes.json")
    model, tree = build_pipnet(build_tree_from_config(dkw["phylo_path"], None), cfg.model,
                               weighted=cfg.train.loss.weighted_ce,
                               class_names=loaders.classes, device="cuda")
    flagship, _ = flagship_tree()
    rec["tree"] = {"nodes": tree.num_nodes, "prototypes": int(tree.node_num_protos.sum())}
    same = (tree.node_names == flagship.node_names
            and np.array_equal(tree.node_num_protos, flagship.node_num_protos)
            and np.array_equal(tree.leaf_child_slot, flagship.leaf_child_slot))
    if rec["tree"] != {"nodes": 189, "prototypes": 3780} or not same:
        fail(f"the fixture's phylogeny is not the flagship's tree: {rec['tree']}")
    model.load_state_dict(params_from_jax(random_jax_params(cfg.model, tree, seed=0)))

    t1 = time.perf_counter()
    cache = build_device_cache(loaders.train, device="cuda")
    torch.cuda.synchronize()
    rec.update(cache_build_s=time.perf_counter() - t1, cache_gb=cache.nbytes / 1e9,
               cache_images=int(cache.array.shape[0]), base=int(cache.array.shape[1]),
               train_batches_per_epoch=len(loaders.train))
    batches = list(loaders.train.epoch_index_batches(20))[:WARMUP_STEPS + TIMED_STEPS]
    step, scalars = train_step(cfg, model, tree, fuse=False)
    state = init_train_state(model, seed=0)
    for rows, ys in batches[:WARMUP_STEPS]:
        state, _ = step(state, cache.fetch(rows), None, host_to_device(ys, "cuda"), scalars)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc = None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_counts()
    t2 = time.perf_counter()
    start.record()
    for rows, ys in batches[WARMUP_STEPS:]:
        state, acc = step(state, cache.fetch(rows), None, host_to_device(ys, "cuda"), scalars,
                          acc=acc)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t2
    rec["launches"] = counts()
    rec.update(step_ms=start.elapsed_time(end) / TIMED_STEPS,
               images_per_s=TRAIN_BATCH * TIMED_STEPS / host_s,
               host_step_ms=host_s * 1e3 / TIMED_STEPS,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               mean_losses={k: float(v) / TIMED_STEPS for k, v in acc.items()
                            if k == "loss" or k.startswith("loss/")})
    if not all(np.isfinite(v) for v in rec["mean_losses"].values()):
        fail(f"training from data: non-finite losses {rec}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows, ys = batches[-1]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            state, _ = step(state, cache.fetch(rows), None, host_to_device(ys, "cuda"), scalars)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    rec["kernel_ms_per_step"] = busy_ms if kernels else "not measured"
    if kernels:
        rec["busy_share"] = busy_ms / rec["step_ms"]
    rec["host_waits_per_step"] = host_waits(prof, 3)
    rec["sync_points"] = sync_points(lambda: step(state, cache.fetch(rows), None,
                                                  host_to_device(ys, "cuda"), scalars))

    # the augmentation alone, and on the card against the CPU for the same draws
    x = cache.fetch(batches[0][0])
    draws = sample_augment(TRAIN_BATCH, x.shape[1], S, torch.Generator(device="cuda")
                           .manual_seed(11))
    v1, v2 = augment_views(x, S, draws)
    rec["views_differ_share"] = (v1 != v2).float().mean().item()
    if not rec["views_differ_share"] > 0.5:
        fail(f"the two views of a batch do not differ: {rec}")
    rec["augment_ms"] = time_ms(lambda: augment_views(x, S, draws), iters=10)
    rec["transform1_ms"] = time_ms(lambda: transform1_batch(x, draws.geometric, S + 4),
                                   iters=10)
    shared = transform1_batch(x, draws.geometric, S + 4)
    rec["transform2_ms"] = time_ms(lambda: two_view_transform2(shared, S, draws.views,
                                                               counts=draws.op_counts),
                                   iters=10)
    rec["augment_profile"] = profile_ms(lambda: augment_views(x, S, draws))
    shared_cpu = transform1_batch(x.cpu(), draws.geometric.to("cpu"), S + 4)
    rec["transform1_max_grey_err"] = (shared.cpu() - shared_cpu).abs().max().item()
    std = torch.tensor([0.229, 0.224, 0.225]) * 255.0
    views = two_view_transform2(shared_cpu.cuda(), S, draws.views)
    views_cpu = two_view_transform2(shared_cpu, S, [d.to("cpu") for d in draws.views])
    rec["transform2_max_grey_err"] = max(((g.cpu() - c) * std).abs().max().item()
                                         for g, c in zip(views, views_cpu))
    # one grey level: the bound of the RRC's rounding (device_geometric's
    # float64 products make the card and the CPU agree exactly) and of the
    # photometric ops' f32 blends
    if not (rec["transform1_max_grey_err"] <= 1.0 and rec["transform2_max_grey_err"] <= 1.0 + 1e-3):
        fail(f"the augmentation on the card disagrees with the CPU on the same draws: {rec}")

    eval_cache = build_device_cache(loaders.test, device="cuda")
    rows = np.arange(0, len(loaders.test.dataset), 7)[:16]
    want = np.stack([EvalTransform(S)(Image.open(loaders.test.dataset.folder.samples[i][0])
                                      .convert("RGB")) for i in rows])
    rec["eval_cache_max_abs_err"] = float(np.abs(eval_cache.fetch(rows).cpu().numpy()
                                                 - want).max())
    if not rec["eval_cache_max_abs_err"] <= 2e-6:
        fail(f"the eval cache's normalized batch disagrees with EvalTransform: {rec}")
    say(f"training from data: {json.dumps(rec)} [{card}]")
    del model, state, step, acc, cache, eval_cache
    torch.cuda.empty_cache()
    return rec


def flagship_cli_argv(log_dir: str) -> list:
    """The flag list of ``scripts/runs/run_lou_190.sh`` with ``CLI_CHANGES``,
    the leave-out list as an absolute path and ``log_dir``."""
    with open(FLAGSHIP_SCRIPT) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("python -m pipnet_tpu.main"))
    argv = [a for a in shlex.split(line)[3:] if a != "$@"]
    leave_out = argv[argv.index("--leave_out_classes") + 1]
    changes = dict(CLI_CHANGES, **{"--log_dir": log_dir, "--leave_out_classes":
                                   os.path.normpath(os.path.join(REPO, leave_out))})
    for flag, value in changes.items():
        argv[argv.index(flag) + 1] = value
    return argv


def upstream_trains(trainer, phase) -> bool:
    """Whether a parameter upstream of the pooled prototype scores (the
    backbone or the add-on) trains in ``phase``: only then does the step's
    backward reach the head, and K1b launch."""
    from pipnet_tpu_torch.train import group_trainable, label_params
    labels = label_params([n for n, _ in trainer.model.named_parameters()],
                          trainer.cfg.model.backbone)
    return any(group_trainable(lab, phase) for lab in labels.values()
               if lab not in ("classifier", "presence"))


def uniform_on_kernels(trainer, phase) -> tuple:
    """Whether the steps of ``phase`` run K5 (the uniformity loss: ``--uni
    y`` outside the fine-tuning phases, bf16 or f32 features) and K5b (K5
    where a backbone parameter trains, so the features take a gradient)."""
    from pipnet_tpu_torch.train import group_trainable, label_params
    cfg = trainer.cfg
    k5 = cfg.train.loss.uni and not phase.finetune
    labels = label_params([n for n, _ in trainer.model.named_parameters()],
                          cfg.model.backbone)
    return k5, k5 and any(group_trainable(lab, phase) for n, lab in labels.items()
                          if n.startswith("backbone."))


def expected_launches(rec: dict) -> dict:
    """The kernel launches of one recorded epoch or evaluation: K1 once a
    forward (the flagship tree has no node wider than a tile), K1b once a
    step where the backward reaches the head, K5 and K5b once a view and
    step where the step runs them."""
    if rec["call"] == "evaluate":
        return {**NO_LAUNCHES, "fused_head": rec["batches"]}
    return {**NO_LAUNCHES, "fused_head": rec["steps"],
            "head_backward": rec["steps"] if rec["k1b"] else 0,
            "uniform_pairs": 2 * rec["steps"] if rec["k5"] else 0,
            "uniform_pairs_backward": 2 * rec["steps"] if rec["k5b"] else 0}


@contextlib.contextmanager
def recorded_trainer(calls: list, trainers: list):
    """While the block runs, every ``Trainer``'s ``fit`` is recorded in
    ``trainers`` and each ``run_epoch`` and ``evaluate`` in ``calls``, with
    the kernel launches it made (the counts set to 0 just before it and
    read just after)."""
    from pipnet_tpu_torch.train import Trainer, phase_for_epoch
    fit, run_epoch, evaluate = Trainer.fit, Trainer.run_epoch, Trainer.evaluate

    def fit_recorded(self, **kw):
        trainers.append(self)
        return fit(self, **kw)

    def run_epoch_recorded(self, epoch, *, pretrain, loader, **kw):
        phase = phase_for_epoch(epoch, self.cfg.train, pretrain=pretrain)
        zero_counts()
        info = run_epoch(self, epoch, pretrain=pretrain, loader=loader, **kw)
        losses = {k: v for k, v in info.items() if k == "loss" or k.startswith("loss/")}
        k5, k5b = uniform_on_kernels(self, phase)
        calls.append({"call": "run_epoch", "epoch": epoch, "phase": phase.name,
                      "batch": loader.batch_size, "steps": len(loader),
                      "k1b": upstream_trains(self, phase), "k5": k5, "k5b": k5b,
                      "launches": counts(),
                      "epoch_s": info["epoch_seconds"], "images_per_s": info["images_per_sec"],
                      "loss": info["loss"], "finite": all(np.isfinite(list(losses.values()))),
                      "nonzero_protos": info["nonzero_protos"]})
        return info

    def evaluate_recorded(self, loader, **kw):
        zero_counts()
        out = evaluate(self, loader, **kw)
        calls.append({"call": "evaluate", "batches": len(loader), "launches": counts(), **out})
        return out

    Trainer.fit, Trainer.run_epoch, Trainer.evaluate = (fit_recorded, run_epoch_recorded,
                                                        evaluate_recorded)
    try:
        yield
    finally:
        Trainer.fit, Trainer.run_epoch, Trainer.evaluate = fit, run_epoch, evaluate


def check_run_dir(run_dir: str, tree) -> dict:
    """The files a CLI run leaves, as ``pipnet_tpu.main`` leaves them."""
    from pipnet_tpu_torch.train import checkpoint_meta
    names = {os.path.relpath(os.path.join(p, f), run_dir)
             for p, _, fs in os.walk(run_dir) for f in fs}
    want = {f"metadata/{n}.json" for n in ("config", "classes", "tree")}
    want |= {f"checkpoints/{c}{suffix}" for c in ("net_pretrained", "net_trained",
                                                 "net_trained_last")
             for suffix in (".pt", ".state.pt")}
    want |= {"log_epoch_overview.csv", "epoch_wise_metrics_pretrain.csv",
             "epoch_wise_metrics_train.csv", "metrics_pretrain.jsonl", "metrics_train.jsonl",
             "out.txt", "log.txt"}
    want |= {f"node_wise_metrics_{split}/{n}_losses.csv" for n in tree.node_names
             for split in ("pretrain", "train")}
    if not want <= names:
        fail(f"the CLI's run directory lacks {sorted(want - names)[:10]}")
    meta = {c: checkpoint_meta(os.path.join(run_dir, "checkpoints", c))
            for c in ("net_pretrained", "net_trained", "net_trained_last")}
    if None in meta.values():
        fail(f"a checkpoint of the CLI run has no complete train state: {meta}")
    return {"files": len(names), "checkpoint_meta": meta,
            "node_csvs": sum(n.startswith("node_wise_metrics_train/") for n in names),
            "checkpoint_mb": {c: os.path.getsize(os.path.join(run_dir, "checkpoints",
                                                              c + ".pt")) / 2**20
                              for c in meta}}


def trainer_phase(card: str, log_dir: str):
    """Training through the CLI: ``run_pipnet`` in-process with the
    flagship's flags (``flagship_cli_argv``) into ``log_dir``, then
    ``--resume --epochs 3`` on the same directory; what it trained served
    by ``Predictor`` against the trainer's own model; ``Trainer.evaluate``
    from the test cache against the host-streamed loader; then
    ``Trainer.run_epoch`` at the joint phase from the cache, timed,
    profiled and watched for host synchronisations."""
    from PIL import Image
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.train import Trainer
    rec = {"argv": None}
    argv = flagship_cli_argv(log_dir)
    rec["argv"] = " ".join(argv)
    calls, trainers = [], []
    stdout = sys.stdout
    with recorded_trainer(calls, trainers):
        t0 = time.perf_counter()
        if run_pipnet(argv) != 0:
            fail("the CLI run returned non-zero")
        rec["cli_s"] = time.perf_counter() - t0
        first = len(calls)
        t0 = time.perf_counter()
        if run_pipnet(argv + ["--resume", "--epochs", "3"]) != 0:
            fail("the resumed CLI run returned non-zero")
        rec["resume_s"] = time.perf_counter() - t0
    if sys.stdout is not stdout:
        fail("run_pipnet left sys.stdout replaced")
    rec["calls"] = calls
    say(f"training through the CLI, calls: {json.dumps(calls)} [{card}]")
    shape = [(c["call"], c.get("epoch"), c.get("phase")) for c in calls]
    want_shape = [("run_epoch", 1, "pretrain"),
                  ("run_epoch", 1, "finetune_classifier"), ("evaluate", None, None),
                  ("run_epoch", 2, "finetune_classifier"), ("evaluate", None, None),
                  ("run_epoch", 3, "finetune"), ("evaluate", None, None)]
    if shape != want_shape or first != 5:
        fail(f"the CLI runs' epochs and evaluations {shape} (first run {first} calls), "
             f"expected {want_shape} with the resume starting at epoch 3")
    for c in calls:
        check_launches(f"CLI {c['call']} {c.get('epoch')} {c.get('phase')}",
                       c["launches"], expected_launches(c))
        if c["call"] == "run_epoch" and not c["finite"]:
            fail(f"CLI epoch with non-finite losses: {c}")
    trainer = trainers[-1]
    rec["run_dir"] = check_run_dir(log_dir, trainer.tree)
    # seconds of each checkpoint the two CLI runs wrote, in order
    rec["run_dir"]["save_s"] = [[name, s] for t in trainers for name, s in t.save_seconds]

    # serve what was trained: the run directory through Predictor against
    # the trainer's own model, on the same padded batch
    from pipnet_tpu_torch.serve import Predictor
    pred = Predictor(log_dir, "net_trained_last", device="cuda")
    image = synthetic_images(1, 256, seed=5)[0]
    answer = pred.predict([Image.fromarray(image)])[0]
    chunk = pred._prep([Image.fromarray(image)])
    chunk = np.concatenate([chunk, np.zeros((pred.batch_size - 1,) + chunk.shape[1:],
                                            chunk.dtype)])
    xs = torch.from_numpy(chunk).cuda()
    served, _, _ = pred.forward(xs)
    with torch.inference_mode():
        own = trainer.model(xs, inference=True)["logits"]
    rec["served"] = {"class": answer["class"], "prob": answer["prob"],
                     "logits_equal": bool(torch.equal(served, own)),
                     "logits_max_abs_diff": (served.float() - own.float()).abs().max().item()}
    if not rec["served"]["logits_equal"]:
        fail(f"the served run directory's logits differ from the trainer's: {rec['served']}")

    # the test set from the eval cache and streamed from the host loader
    cached = trainer.evaluate(trainer.loaders.test)
    os.environ["PIPNET_DEVICE_DATA"] = "0"
    try:
        streamed = trainer.evaluate(trainer.loaders.test)
    finally:
        del os.environ["PIPNET_DEVICE_DATA"]
    rec["evaluate"] = {"cached": cached, "streamed": streamed}
    if cached != streamed:
        fail(f"Trainer.evaluate from the cache and streamed disagree: {rec['evaluate']}")
    del pred

    rec["joint_epoch"] = joint_epoch(trainer)
    say(f"training through the CLI: {json.dumps(rec)} [{card}]")
    launches = {k: sum(c["launches"][k] for c in calls) + rec["joint_epoch"]["launches"][k]
                for k in NO_LAUNCHES}
    del trainers, trainer
    torch.cuda.empty_cache()
    return rec, launches


def joint_epoch(trained) -> dict:
    """``Trainer.run_epoch`` at ``JOINT_EPOCH`` of the flagship's 40 (the
    joint phase: backbone unfrozen, mask-prune on) from the device cache, on
    the CLI's trained state: once to warm up, once timed by CUDA events, once
    profiled, once under the sync debug mode."""
    from pipnet_tpu_torch.runtime.log import RunLog
    from pipnet_tpu_torch.train import Trainer, phase_for_epoch
    cfg = dataclasses.replace(trained.cfg, train=dataclasses.replace(trained.cfg.train,
                                                                     epochs=40))
    log_dir = tempfile.mkdtemp(prefix="pipnet_joint_")
    trainer = Trainer(trained.model, trained.tree, cfg, trained.loaders,
                      log=RunLog(log_dir))
    trainer.adopt_state(trained.state)
    loader = trainer.loaders.train
    n = len(loader)
    phase = phase_for_epoch(JOINT_EPOCH, cfg.train, pretrain=False)

    def epoch():
        return trainer.run_epoch(JOINT_EPOCH, pretrain=False, net_t0=(JOINT_EPOCH - 1) * n,
                                 net_T=cfg.train.epochs * n, loader=loader)
    rec = {"epoch": JOINT_EPOCH, "phase": phase.name, "backbone_frozen": phase.backbone_frozen,
           "steps": n, "batch": loader.batch_size}
    t0 = time.perf_counter()
    epoch()
    rec["warmup_epoch_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    zero_counts()
    t1 = time.perf_counter()
    start.record()
    info = epoch()
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    rec["launches"] = counts()
    check_launches("Trainer.run_epoch at the joint phase", rec["launches"],
                   {**NO_LAUNCHES, "fused_head": n, "head_backward": n})
    losses = {k: v for k, v in info.items() if k == "loss" or k.startswith("loss/")}
    if not (info["nonzero_protos"] > 0 and all(np.isfinite(list(losses.values())))):
        fail(f"Trainer.run_epoch at the joint phase: {info}")
    rec.update(step_ms=start.elapsed_time(end) / n,
               images_per_s=n * loader.batch_size / host_s, host_epoch_s=host_s,
               trainer_images_per_s=info["images_per_sec"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               mean_losses=losses, nonzero_protos=info["nonzero_protos"],
               nonzero_connections=info["nonzero_connections"])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        epoch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    rec["kernel_ms_per_step"] = busy_ms if kernels else "not measured"
    if kernels:
        rec["busy_share"] = busy_ms / rec["step_ms"]
    rec["host_waits_per_step"] = host_waits(prof, n)
    rec["host_waits_per_epoch"] = host_waits(prof, 1)
    rec["sync_points"] = sync_points(epoch)
    # allowed: the one read at the end of the epoch, and the wait for the
    # augmentation's op counts on its side stream (the one wait a step holds)
    allowed = {"_read_epoch_metrics", "sample_augment"}
    stream_syncs = rec["host_waits_per_epoch"].get("cudaStreamSynchronize", {}).get("count", 0)
    if ({p.rsplit("(", 1)[-1].rstrip(")") for p in rec["sync_points"]} - allowed
            or stream_syncs > 1):
        fail(f"Trainer.run_epoch synchronises inside the epoch: {rec}")
    shutil.rmtree(log_dir, ignore_errors=True)
    return rec


@contextlib.contextmanager
def scratch_dir(prefix: str):
    """A temporary directory, removed when the block ends."""
    path = tempfile.mkdtemp(prefix=prefix)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


# evaluation: the flagship's leave-out report, whose keys each report must
# carry (beside the per-node sweep's)
EVAL_REPORT = os.path.join(REPO, "artifacts", "lou_190_s2", "eval_report_lou.json")


def flagship_leave_out() -> str:
    """The flagship's leave-out list (``run_lou_190.sh``) as an absolute path."""
    argv = flagship_cli_argv(tempfile.gettempdir())
    return argv[argv.index("--leave_out_classes") + 1]


@contextlib.contextmanager
def recorded_evaluate(trainers: list):
    """While the block runs, every ``Trainer.evaluate`` records its trainer
    and its host seconds (the pass ends in the read of its counts)."""
    from pipnet_tpu_torch.train import Trainer
    evaluate = Trainer.evaluate

    def evaluate_recorded(self, loader, **kw):
        t0 = time.perf_counter()
        out = evaluate(self, loader, **kw)
        trainers.append((self, loader, kw, time.perf_counter() - t0))
        return out

    Trainer.evaluate = evaluate_recorded
    try:
        yield
    finally:
        Trainer.evaluate = evaluate


def masked_parity(trainer, loader, keep) -> dict:
    """One evaluation batch's masked forward (its 2B rows, as the eval step
    runs them) through K1 against the plain composition on the same
    features and presence sample ``keep``: pooled, logits within two bf16
    ulps, top-1 of the masked decode equal on every confident image."""
    from pipnet_tpu_torch.models.pipnet import (joint_leaf_log_distribution,
                                                masked_decode_degenerates)
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    model, tree, head = trainer.model, trainer.tree, trainer.model.head
    xs, _ = next(iter(trainer.eval_batches(loader)))
    with torch.inference_mode():
        feats = model.features(torch.cat([xs, xs]))
        k = head.add_on_kernel.to(feats.dtype)
        _, pooled_k = fused_head(feats, k, tree, tau=head.cfg.softmax_tau)
        _, pooled_p = fused_head_reference(feats, k, tree, tau=head.cfg.softmax_tau)
        # a pooled value within a bf16 ulp of the 0.1 cut may round to either
        # side of it: take the plain side there (as the serving check does)
        near = (pooled_p - head.cfg.inference_threshold).abs() < 2.0 ** -9
        pooled_k = torch.where(near, pooled_p, pooled_k)
        masked_k, logits_k = head.classify(pooled_k.to(feats.dtype), inference=True, keep=keep)
        _, logits_p = head.classify(pooled_p.to(feats.dtype), inference=True, keep=keep)
        deg = masked_decode_degenerates(model, tree, keep)
        logp_k = joint_leaf_log_distribution(logits_k, tree, degenerate_nodes=deg).float()
        logp_p = joint_leaf_log_distribution(logits_p, tree, degenerate_nodes=deg).float()
    lk, lp = logits_k.float(), logits_p.float()
    top2 = torch.topk(logp_p, 2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 0.1
    agree = (logp_k.argmax(-1) == logp_p.argmax(-1))[confident]
    rec = {"rows": int(lk.shape[0]),
           "pooled_max_abs_err": (pooled_k - pooled_p).abs().max().item(),
           "logits_max_abs_err": (lk - lp).abs().max().item(),
           "near_threshold": int(near.sum().item()),
           "pruned_prototypes_zero": bool((masked_k[:, keep == 0] == 0).all().item()),
           "confident_rows": int(confident.sum().item()),
           "top1_agree": int(agree.sum().item())}
    if not (torch.isfinite(lk).all() and torch.isfinite(logp_k).all()
            and rec["pruned_prototypes_zero"]):
        fail(f"evaluation: masked logits not finite or a pruned prototype scored: {rec}")
    if rec["pooled_max_abs_err"] > SERVED_POOLED_TOL or \
            bool(((lk - lp).abs() > 2.0 ** -6 * lp.abs() + 2.0 ** -7).any()):
        fail(f"evaluation: the masked forward through K1 disagrees with the plain "
             f"composition: {rec}")
    if rec["confident_rows"] == 0 or not bool(agree.all()):
        fail(f"evaluation: masked top-1 disagrees with the plain composition: {rec}")
    return rec


def eval_phase(card: str, run_dir: str, dataset=None):
    """``evaluate.run`` on ``run_dir`` (with ``dataset`` in place of the
    run's own) with the flagship's leave-out list, unmasked and masked (one
    fixed sample, seed 0): the reports, their launches and seconds; then
    one masked pass timed and profiled, the masked forward against the
    plain composition, the presence samples on the card against the CPU's,
    and a masked ``Predictor`` against the eval step."""
    from PIL import Image
    from pipnet_tpu_torch.evaluate import run as evaluate_run
    from pipnet_tpu_torch.models.pipnet import masked_decode_degenerates, presence_keep
    from pipnet_tpu_torch.serve import Predictor
    from pipnet_tpu_torch.train import make_eval_step
    with open(EVAL_REPORT) as f:
        want_keys = set(json.load(f)) | {"per_node"}
    base = ["--run_dir", run_dir, "--device", "cuda", "--leave_out_classes",
            flagship_leave_out()] + (["--dataset", dataset] if dataset else [])
    rec, launches = {"run_dir": run_dir, "dataset": dataset}, dict(NO_LAUNCHES)
    for name, extra, suffix in (
            ("leave-out", [], "_lou"),
            ("leave-out, masked", ["--apply_overspecificity_mask", "--fixed_mask_seed", "0"],
             "_masked_lou")):
        path = os.path.join(run_dir, f"eval_report{suffix}.json")
        if os.path.exists(path):
            os.remove(path)            # no merge with an earlier report
        trainers = []
        stdout = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with recorded_evaluate(trainers), contextlib.redirect_stdout(stdout):
            code = evaluate_run(base + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        if code != 0:
            fail(f"evaluation {name}: evaluate.run returned {code}")
        with open(path) as f:
            report = json.load(f)
        trainer, loader, kw, pass_s = trainers[0]
        batches = len(loader)
        # one K1 launch an evaluation batch (a forward of its 2B rows; the
        # flagship tree has no node wider than a tile), in each of the three
        # passes: Trainer.evaluate, the collecting sweep, evaluate_per_node
        check_launches(f"evaluation {name}", got, {**NO_LAUNCHES, "fused_head": 3 * batches})
        launches = {k: launches[k] + got[k] for k in NO_LAUNCHES}
        if set(report) != want_keys:
            fail(f"evaluation {name}: report keys {sorted(report)}, expected "
                 f"{sorted(want_keys)}")
        if len(report["per_node"]) != trainer.tree.num_nodes or trainer.tree.num_nodes != 189:
            fail(f"evaluation {name}: {len(report['per_node'])} per-node entries, expected 189")
        numbers = [v for v in report.values() if isinstance(v, (int, float))]
        if not all(np.isfinite(numbers)) or report["n"] != report["left_out_n"] or \
                report["n"] == 0 or report["held_in_n"] == 0:
            fail(f"evaluation {name}: report {report}")
        images = len(loader.dataset)
        rec[name] = {"report": {k: v for k, v in report.items() if k != "per_node"},
                     "per_node_entries": len(report["per_node"]), "launches": got,
                     "run_s": seconds, "batches": batches, "images": images,
                     "first_pass_s": pass_s, "first_pass_images_per_s": images / pass_s}
        say(f"evaluation {name}: {json.dumps(rec[name])} [{card}]")

    # one masked pass, warm: timed by CUDA events, then profiled
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    start.record()
    trainer.evaluate(loader, **kw)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    pass_ms = start.elapsed_time(end)
    prof = profile_ms(lambda: trainer.evaluate(loader, **kw), n=1)
    keep = presence_keep(trainer.model.head.proto_presence, 0)
    with torch.inference_mode():
        degenerate = masked_decode_degenerates(trainer.model, trainer.tree, keep)
    valid = torch.as_tensor(trainer.tree.proto_valid, device=keep.device)
    rec["masked_pass"] = {
        "pass_ms": pass_ms, "host_s": host_s, "images_per_s": images / host_s,
        "kernel_ms": prof["kernel_ms"], "kernels": prof.get("kernels"),
        "busy_share": (prof["kernel_ms"] / pass_ms if prof.get("kernels") else "not measured"),
        "top_ms": prof.get("top_ms"),
        "degenerate_nodes": int(degenerate.sum().item()),
        "kept_prototypes": int((keep * valid).sum().item()),
        "prototypes": int(valid.sum().item())}

    # the presence samples: the card's equal the CPU's for the same seeds
    presence_cpu = trainer.model.head.proto_presence.detach().cpu()
    samples_equal = {
        "fixed_seed_0": torch.equal(keep.cpu(), presence_keep(presence_cpu, 0)),
        "per_batch_seed_0": torch.equal(trainer.mask_samples(batches).cpu(),
                                        presence_keep(presence_cpu, 0, num=batches))}
    rec["samples_card_equal_cpu"] = samples_equal
    if not all(samples_equal.values()):
        fail(f"evaluation: the card's presence samples differ from the CPU's: {samples_equal}")
    rec["masked_parity"] = masked_parity(trainer, loader, keep)

    # the pruned model served: a masked Predictor (mask_seed 0, the fixed
    # sample above) answers requests; its logits equal the eval step's
    pred = Predictor(run_dir, "net_trained_last", batch_size=8, apply_overspecificity_mask=True,
                     mask_seed=0, device="cuda")
    if not torch.equal(pred.keep, keep):
        fail("evaluation: the masked Predictor's sample differs from the evaluation's")
    requests = synthetic_images(4, 256, seed=7)
    answers = [pred.predict([Image.fromarray(im)])[0] for im in requests[:2]]
    answers += pred.predict([Image.fromarray(im) for im in requests])
    xs = torch.from_numpy(pred._prep([Image.fromarray(im) for im in requests])).cuda()
    served, _, served_logp = pred.forward(torch.cat([xs, xs]))
    step = make_eval_step(pred.model, pred.tree, apply_overspecificity_mask=True)(xs, pred.keep)
    rec["predictor"] = {"answers": len(answers), "classes": [a["class"] for a in answers],
                        "logits_equal": bool(torch.equal(served[:4], step["logits"])),
                        "log_joint_equal": bool(torch.equal(served_logp[:4], step["log_joint"]))}
    if not (rec["predictor"]["logits_equal"] and rec["predictor"]["log_joint_equal"]):
        fail(f"evaluation: the masked Predictor's logits differ from the eval step's: "
             f"{rec['predictor']}")
    say(f"evaluation: {json.dumps({k: v for k, v in rec.items() if not k.startswith('leave')})}"
        f" [{card}]")
    del pred, trainer, trainers
    torch.cuda.empty_cache()
    return rec, launches


# interpretability: the flagship evaluation script's pruning sweep
# (scripts/runs/eval_full_phase_190.sh) and the report it wrote, whose keys
# the phase's reports must carry (the OOD check aside: the phase runs none)
PRUNE_THRESHOLDS = "0.1,0.2,0.3,0.4,0.5"
SPARSE_REPORT = os.path.join(REPO, "artifacts", "sparse_190", "eval_report.json")
# the projection's batch (interp/topk.py::run_projection's default)
PROJECTION_BATCH = 32
ATTACK_STEPS, IG_STEPS, MIPS_IMAGES = 40, 50, 256


def write_part_annotations(folder, out_dir: str) -> list:
    """CUB-style part files for ``folder``'s images (a beak at the centre, a
    left wing near a corner, merged into the right wing by the purity
    score): [parts_loc, parts_name, images_id]."""
    from PIL import Image
    paths = [os.path.join(out_dir, n) for n in ("part_locs.txt", "parts.txt", "images.txt")]
    with open(paths[2], "w") as f:
        for i, (p, _) in enumerate(folder.samples):
            f.write(f"{i} {'/'.join(p.split('/')[-2:])}\n")
    with open(paths[0], "w") as f:
        for i, (p, _) in enumerate(folder.samples):
            with Image.open(p) as im:
                w, h = im.size
            f.write(f"{i} 1 {w / 2:.1f} {h / 2:.1f} 1\n{i} 2 2.0 2.0 1\n")
    with open(paths[1], "w") as f:
        f.write("1 beak\n2 left wing\n3 right wing\n")
    return paths


def gallery_nodes(tree) -> list:
    """A leaf-parent node (the first) and the smallest node with an internal
    child: galleries over a few leaves each (the root's alone would gather
    top-k images over every leaf)."""
    leaf_parent = [ni for ni in range(tree.num_nodes)
                   if tree.child_is_leaf[tree.node_child_slice(ni)].all()]
    internal = [ni for ni in range(tree.num_nodes) if ni not in leaf_parent]
    return [leaf_parent[0], min(internal, key=lambda ni: (int(tree.node_num_leaves[ni]), ni))]


def gallery_launches(proj, tree, w_eff, nodes, k: int = 10) -> int:
    """K1 launches of ``save_hierarchy_galleries`` with a heatmap forward on
    ``nodes``: one re-forward per prototype with a gallery, over its
    distinct images in chunks of ``hierarchy_viz.MAX_BATCH``."""
    from pipnet_tpu_torch.interp import topk_per_prototype_per_leaf
    from pipnet_tpu_torch.interp.hierarchy_viz import MAX_BATCH
    per_leaf = topk_per_prototype_per_leaf(proj, tree, w_eff, k=k)
    n = 0
    for ni in nodes:
        sl = tree.node_proto_slice(ni)
        for p in range(sl.start, sl.stop):
            if per_leaf.get(p):
                images = {i for entries in per_leaf[p].values() for i, _ in entries}
                n += -(-len(images) // MAX_BATCH)
    return n


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at ``x`` (8 significant bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def projection_parity(model, tree, loader) -> dict:
    """The projection step (K1) on one batch of ``PROJECTION_BATCH``
    projection images against the plain composition on the same features:
    pooled within two bf16 ulps of the plain value, and the plain map's
    value at each chosen index within two bf16 ulps of its maximum (bf16 pf
    saturates near 1, where a one-ulp difference may move the first
    maximum, so the index itself is not compared)."""
    from pipnet_tpu_torch.interp import make_projection_step
    from pipnet_tpu_torch.ops.fused_head import fused_head_reference
    images = []
    for batch in loader.epoch(0):
        images.append(batch.xs1[0])
        if len(images) == PROJECTION_BATCH:
            break
    xs = torch.from_numpy(np.stack(images)).cuda()
    with torch.inference_mode():
        out = make_projection_step(model, tree)(xs)
        feats = model.features(xs)
        pf_p, pooled_p = fused_head_reference(feats, model.head.add_on_kernel.to(feats.dtype),
                                              tree, tau=model.head.cfg.softmax_tau)
    valid = torch.as_tensor(tree.proto_valid, device="cuda")
    B, H, W, P = pf_p.shape
    flat = pf_p.float().reshape(B, H * W, P)
    idx = out["h_idx"] * W + out["w_idx"]
    at = flat.gather(1, idx[:, None, :])[:, 0][:, valid]
    top = flat.amax(dim=1)[:, valid]
    pooled = out["pooled"].float()[:, valid]
    ref = pooled_p[:, valid]
    rec = {"images": B,
           "pooled_max_abs_err": (pooled - ref).abs().max().item(),
           "pooled_max_err_ulps": ((pooled - ref).abs() / bf16_ulp(ref)).max().item(),
           "value_at_index_max_err_ulps": ((top - at) / bf16_ulp(top)).max().item(),
           "same_index_share": (idx == flat.argmax(dim=1))[:, valid].float().mean().item(),
           "cs_at_max_finite": bool(torch.isfinite(out["cs_at_max"].float()).all().item())}
    if not (rec["pooled_max_err_ulps"] <= 2 and rec["value_at_index_max_err_ulps"] <= 2
            and rec["cs_at_max_finite"]):
        fail(f"interpretability: the projection through K1 disagrees with the plain "
             f"composition: {rec}")
    return rec


def explanation_layout(out_dir: str, top_classes: int = 3) -> dict:
    """An ``explain_image`` folder as the JAX package writes it:
    ``<rank>_<class>_<prob:.3f>/`` for each of the top classes, each holding
    ``p<p>_sim<s>_w<w>_patch.png``, ``..._rect.png`` and ``heatmap_p<p>.png``
    for every evidence prototype (a class may have none: every pooled value
    under the inference threshold)."""
    import re
    folders = sorted(os.listdir(out_dir))
    files = {d: sorted(os.listdir(os.path.join(out_dir, d))) for d in folders}
    ok = len(folders) == top_classes and all(
        re.fullmatch(rf"{rank}_.+_\d\.\d{{3}}", d) for rank, d in enumerate(folders))
    evidence = 0
    for names in files.values():
        protos = sorted(int(n.split("_")[0][1:]) for n in names if n.endswith("_patch.png"))
        rects = sorted(int(n.split("_")[0][1:]) for n in names if n.endswith("_rect.png"))
        maps = sorted(int(n[len("heatmap_p"):-4]) for n in names if n.startswith("heatmap_p"))
        ok &= protos == rects == maps and len(names) == 3 * len(protos)
        evidence += len(protos)
    if not ok:
        fail(f"interpretability: explanation folder {out_dir} has layout {files}")
    return {"classes": folders, "evidence": evidence}


def interp_phase(card: str, run_dir: str, dataset=None):
    """Interpretability on ``run_dir`` (with ``dataset`` in place of the
    run's own): the projection timed and profiled, then held against the
    plain composition; ``evaluate.run`` with the pruning sweep and part
    purity, with the leaf-parent A/B, and with node galleries; the final
    galleries of ``main.py``; ``Predictor.explain`` and the serve CLI's
    ``--explain``; the adversarial attack and integrated gradients; MIPS
    over the test images.  Every part's K1 and K1b launches are derived from
    the code before it runs and checked exactly."""
    from PIL import Image
    from pipnet_tpu_torch.data import build_loaders
    from pipnet_tpu_torch.data.augment import EvalTransform
    from pipnet_tpu_torch.datasets import resolve_dataset
    from pipnet_tpu_torch.evaluate import run as evaluate_run
    from pipnet_tpu_torch.interp import (adversarial_attack, build_patch_index, mips_query,
                                         run_projection)
    from pipnet_tpu_torch.interp.adversarial import integrated_gradients_patch
    from pipnet_tpu_torch.main import final_galleries
    from pipnet_tpu_torch.run_io import load_run, load_run_config
    from pipnet_tpu_torch.serve import Predictor, run as serve_run
    cfg = load_run_config(run_dir)
    ds = dataset or cfg.dataset
    train_dir, test_dir, project_dir, _ = resolve_dataset(ds, seed=cfg.train.seed)
    loaders = build_loaders(train_dir, test_dir, project_dir=project_dir,
                            image_size=cfg.model.image_size, batch_size=cfg.train.batch_size,
                            batch_size_pretrain=cfg.train.batch_size_pretrain,
                            seed=cfg.train.seed)
    bundle = load_run(run_dir, dataset=ds, classes=loaders.classes, device="cuda")
    model, tree, size = bundle.model, bundle.tree, cfg.model.image_size
    n_proj = len(loaders.project.dataset)
    proj_batches = -(-n_proj // PROJECTION_BATCH)
    test_batches = len(loaders.test)
    rec = {"run_dir": run_dir, "dataset": ds, "projection_images": n_proj,
           "test_images": len(loaders.test.dataset), "test_batches": test_batches}
    launches = dict(NO_LAUNCHES)

    def measured(what: str, fn, want: dict):
        """``fn()`` between the counts set to 0 and read, its host seconds
        (the card drained at both ends) and its launches checked."""
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        check_launches(f"interpretability, {what}", got, {**NO_LAUNCHES, **want})
        for k in NO_LAUNCHES:
            launches[k] += got[k]
        return out, seconds, got

    # the projection: timed by CUDA events and the host clock, then profiled
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    proj, proj_s, _ = measured("projection", lambda: run_projection(
        model, tree, loaders.project, image_size=size), {"fused_head": proj_batches})
    end.record()
    torch.cuda.synchronize()
    pass_ms = start.elapsed_time(end)
    prof = profile_ms(lambda: run_projection(model, tree, loaders.project, image_size=size), n=1)
    rec["projection"] = {
        "s": proj_s, "images_per_s": n_proj / proj_s, "pass_ms": pass_ms,
        "batches": proj_batches, "kernel_ms": prof["kernel_ms"],
        "busy_share": (prof["kernel_ms"] / pass_ms if prof.get("kernels") else "not measured"),
        "top_ms": prof.get("top_ms"), "latent_hw": list(proj.latent_hw)}
    # where the sweep waits for the card: one read, after the sweep
    rec["projection"]["sync_points"] = sync_points(lambda: run_projection(
        model, tree, loaders.project, image_size=size))
    rec["projection_parity"] = projection_parity(model, tree, loaders.project)
    say(f"interpretability, projection: {json.dumps(rec['projection'])}; parity "
        f"{json.dumps(rec['projection_parity'])} [{card}]")

    # evaluate.run: the sweep with part purity, the leaf-parent A/B, galleries
    with torch.no_grad():
        w_eff = model.head.effective_cls_weight().float().cpu().numpy()
    nodes = gallery_nodes(tree)
    names = [tree.node_names[ni] for ni in nodes]
    heatmap_batches = gallery_launches(proj, tree, w_eff, nodes)
    parts = write_part_annotations(loaders.project.dataset.folder, run_dir)
    thresholds = [float(t) for t in PRUNE_THRESHOLDS.split(",")]
    ckpt = torch.load(os.path.join(run_dir, "checkpoints", "net_trained_last.pt"),
                      map_location="cuda", weights_only=True)
    base = ["--run_dir", run_dir, "--device", "cuda"] + (["--dataset", dataset] if dataset else [])
    report_path = os.path.join(run_dir, "eval_report.json")
    if os.path.exists(report_path):
        os.remove(report_path)             # no merge with an earlier report
    runs = [("pruning sweep, part purity",
             ["--threshold_prune", PRUNE_THRESHOLDS, "--part_purity_csv", "--parts_loc", parts[0],
              "--parts_name", parts[1], "--images_id", parts[2]],
             # Trainer.evaluate, the collecting sweep, evaluate_per_node, the
             # projection, one Trainer.evaluate a threshold
             test_batches * (3 + len(thresholds)) + proj_batches),
            ("leaf-parent A/B", ["--threshold_prune", "0.4", "--prune_leaf_parents",
                                 "--skip_per_node"], test_batches * 3 + proj_batches),
            ("node galleries", ["--galleries_nodes", ",".join(names), "--skip_per_node"],
             test_batches * 2 + proj_batches + heatmap_batches)]
    rec["reports"] = {}
    for name, extra, k1 in runs:
        trainers = []

        def evaluate(argv=base + extra):
            with recorded_evaluate(trainers), contextlib.redirect_stdout(io.StringIO()):
                return evaluate_run(argv)
        code, seconds, got = measured(f"evaluate.run ({name})", evaluate, {"fused_head": k1})
        if code != 0:
            fail(f"interpretability: evaluate.run ({name}) returned {code}")
        # the sweep swapped pruned weights in and must have put back the
        # checkpoint's tensor bit for bit
        restored = torch.equal(trainers[0][0].model.head.cls_weight.detach(),
                               ckpt["head.cls_weight"])
        if not restored:
            fail(f"interpretability: head.cls_weight differs after evaluate.run ({name})")
        with open(report_path) as f:
            report = json.load(f)
        rec["reports"][name] = {"run_s": seconds, "launches": got, "keys": sorted(report)}
        del trainers
    with open(SPARSE_REPORT) as f:
        sparse = json.load(f)
    want_keys = (set(sparse) - {"ood"}) | {"checkpoint_id", "threshold_prune_leaf_parents_ab",
                                           "part_purity", "topk_patch_csv"}
    if set(report) != want_keys:
        fail(f"interpretability: report keys {sorted(report)}, expected {sorted(want_keys)}")
    for key in ("threshold_prune", "node_galleries"):
        if not set(sparse[key]) <= set(report[key]):
            fail(f"interpretability: report[{key!r}] keys {sorted(report[key])} lack "
                 f"{sorted(set(sparse[key]) - set(report[key]))}")
    sweep = report["threshold_prune"]["sweep"]
    pruned = [t["pruned_columns"] for t in sweep]
    if [t["threshold"] for t in sweep] != thresholds or pruned != sorted(pruned) or \
            report["threshold_prune"]["top1_before"] != report["top1"]:
        fail(f"interpretability: pruning sweep {report['threshold_prune']}")
    with open(report["threshold_prune"]["prototype_report"]) as f:
        report_lines = f.read().splitlines()
    galleries = report["node_galleries"]
    if len(report_lines) != tree.num_nodes or galleries["nodes"] != names or \
            galleries["files"] == 0 or report["part_purity"]["num_prototypes"] == 0:
        fail(f"interpretability: prototype report of {len(report_lines)} lines, galleries "
             f"{galleries}, part purity {report['part_purity']}")
    rec["sweep"] = {k: v for k, v in report["threshold_prune"].items() if k != "sweep"}
    rec["sweep"]["pruned_columns_by_threshold"] = dict(zip(thresholds, pruned))
    rec["sweep"]["top1_after_by_threshold"] = {t["threshold"]: t["top1_after"] for t in sweep}
    rec["leaf_parents_ab"] = {k: v for k, v in report["threshold_prune_leaf_parents_ab"].items()
                              if k != "sweep"}
    rec["part_purity"] = report["part_purity"]
    rec["node_galleries"] = galleries
    shown = ("reports", "sweep", "leaf_parents_ab", "part_purity", "node_galleries")
    say(f"interpretability, reports: {json.dumps({k: rec[k] for k in shown})} [{card}]")

    # the final galleries a training run draws (main.py), on the same nodes
    gallery_dir = os.path.join(run_dir, "final_galleries")
    written, seconds, _ = measured("final galleries", lambda: final_galleries(
        model, tree, loaders.project, gallery_dir, image_size=size, nodes=nodes),
        {"fused_head": proj_batches + heatmap_batches})
    if len(written) != galleries["files"]:
        fail(f"interpretability: main.py's galleries wrote {len(written)} files, "
             f"evaluate.run's {galleries['files']}")
    rec["final_galleries"] = {"s": seconds, "files": len(written), "nodes": names,
                              "heatmap_forwards": heatmap_batches}

    # explanations: Predictor.explain on two images, the serve CLI on one
    pred = Predictor(run_dir, device="cuda")
    paths = [p for p, _ in loaders.test.dataset.folder.samples[:2]]
    explain_dir = os.path.join(run_dir, "explanations")
    results, seconds, _ = measured("Predictor.explain", lambda: [
        pred.explain(p, os.path.join(explain_dir, str(i))) for i, p in enumerate(paths)],
        {"fused_head": len(paths)})
    layouts = [explanation_layout(os.path.join(explain_dir, str(i))) for i in range(len(paths))]
    stdout = io.StringIO()

    def cli():
        with contextlib.redirect_stdout(stdout):
            return serve_run(["--run_dir", run_dir, "--images", paths[0], "--explain",
                              os.path.join(explain_dir, "cli"), "--device", "cuda"])
    # the CLI's Predictor serves the image (one forward at its batch of 8)
    # and explains it (one at B = 1)
    code, cli_s, _ = measured("serve --explain", cli, {"fused_head": 2})
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    stem = os.path.splitext(os.path.basename(paths[0]))[0]
    if code != 0 or line["explanation_dir"] != os.path.join(explain_dir, "cli", f"000_{stem}"):
        fail(f"interpretability: serve --explain returned {code}: {line}")
    layouts.append(explanation_layout(line["explanation_dir"]))
    rec["explain"] = {"ms_per_image": seconds * 1e3 / len(paths), "cli_s": cli_s,
                      "layouts": layouts,
                      "top_class": [r["classes"][0]["name"] for r in results]}
    say(f"interpretability, galleries and explanations: "
        f"{json.dumps({k: rec[k] for k in ('final_galleries', 'explain')})} [{card}]")

    # the adversarial attack and integrated gradients on the first
    # projection image and its most active prototype
    with Image.open(proj.paths[0]) as im:
        x = EvalTransform(size)(im.convert("RGB"))
    proto = int(np.argmax(np.where(tree.proto_valid, proj.pooled[0], -1.0)))
    # two steps of each first: the first backward at B = 1 loads its kernels
    warm = {}
    _, warm["attack_2_steps_s"], _ = measured("adversarial attack, warm-up", lambda: (
        adversarial_attack(model, x, proto, num_steps=2)), {"fused_head": 4, "head_backward": 2})
    _, warm["integrated_gradients_2_steps_s"], _ = measured(
        "integrated gradients, warm-up", lambda: integrated_gradients_patch(
            model, x, proto, num_steps=2), {"fused_head": 2, "head_backward": 2})
    # where the attack waits for the card (none inside its steps)
    warm["attack_sync_points"] = sync_points(
        lambda: adversarial_attack(model, x, proto, num_steps=2))
    (moved, adv), attack_s, _ = measured("adversarial attack", lambda: adversarial_attack(
        model, x, proto, num_steps=ATTACK_STEPS),
        {"fused_head": ATTACK_STEPS + 2, "head_backward": ATTACK_STEPS})
    x01 = np.clip(x * np.asarray((0.229, 0.224, 0.225), np.float32)
                  + np.asarray((0.485, 0.456, 0.406), np.float32), 0, 1)
    ig, ig_s, _ = measured("integrated gradients", lambda: integrated_gradients_patch(
        model, x, proto, num_steps=IG_STEPS), {"fused_head": IG_STEPS, "head_backward": IG_STEPS})
    ig = ig.float().cpu()
    rec["attack"] = {"prototype": proto, "moved": moved, "s": attack_s, **warm,
                     "ms_per_step": attack_s * 1e3 / ATTACK_STEPS,
                     "max_perturbation": float(np.abs(adv - x01).max())}
    rec["integrated_gradients"] = {"s": ig_s, "ms_per_step": ig_s * 1e3 / IG_STEPS,
                                   "shape": list(ig.shape), "max": ig.max().item()}
    if not (np.isfinite(adv).all() and rec["attack"]["max_perturbation"] <= 8 / 255 + 1e-6
            and torch.isfinite(ig).all() and tuple(ig.shape) == (size, size)
            and rec["integrated_gradients"]["max"] > 0):
        fail(f"interpretability: attack {rec['attack']}, integrated gradients "
             f"{rec['integrated_gradients']}")

    # MIPS: the backbone's patch features of test images, the add-on
    # kernel's columns as queries on the card, held to the CPU's product
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        queries = model.head.add_on_kernel.detach().float()[:, torch.as_tensor(
            tree.proto_valid, device="cuda")].T.cpu().numpy()
        def mips():
            index = build_patch_index(model, loaders.test, max_images=MIPS_IMAGES)
            return index, mips_query(index, queries, k=10, device="cuda")
        # the index is the backbone's features only: no head kernel launches
        (index, hits), mips_s, _ = measured("MIPS", mips, {})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    q = torch.from_numpy(queries[:32])
    scores = q @ torch.from_numpy(index.features).T                  # (32, n) on the CPU
    vals = torch.topk(scores, 10, dim=1).values
    tol = 1e-4 * scores.abs().max().item()
    flat = {(int(i), int(h), int(w)): n for n, (i, h, w) in enumerate(zip(
        index.image_idx, index.h_idx, index.w_idx))}
    got_vals = torch.tensor([[v for *_, v in row] for row in hits[:32]])
    at = torch.stack([scores[r, [flat[hit[:3]] for hit in hits[r]]] for r in range(32)])
    rec["mips"] = {"s": mips_s, "images": int(index.image_idx.max()) + 1,
                   "patches": len(index), "queries": len(queries),
                   "max_abs_err_vs_cpu": (got_vals - vals).abs().max().item(), "tolerance": tol}
    if rec["mips"]["images"] != MIPS_IMAGES or (got_vals - vals).abs().max() > tol or \
            (at - got_vals).abs().max() > tol:
        fail(f"interpretability: MIPS on the card disagrees with the CPU's product: {rec['mips']}")
    say(f"interpretability, attack, integrated gradients, MIPS: "
        f"{json.dumps({k: rec[k] for k in ('attack', 'integrated_gradients', 'mips')})} [{card}]")
    rec["launches"] = launches
    del model, pred, bundle
    torch.cuda.empty_cache()
    return rec, launches


def cross_checks(card: str, setup: Setup):
    """From the same parameters and batch of ``setup``, with align_eps unset:
    path A's and path B's first-step losses; then the head gradients
    through the kernels against autograd through the plain composition, on
    the step's own features, for both paths, in bf16 and in f32 (TF32
    off)."""
    from pipnet_tpu_torch.train import init_train_state
    cfg = run_config(setup, align_eps_unset=True)
    model, tree, _ = build_model(setup, cfg)
    batch = train_batch(cfg, tree)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    loss = {}
    for fuse in (False, True):
        model.load_state_dict(snapshot)
        step, scalars = train_step(cfg, model, tree, fuse)
        _, m = step(init_train_state(model, seed=0), *batch, scalars)
        loss["B" if fuse else "A"] = float(m["loss"])
    rel = abs(loss["A"] - loss["B"]) / abs(loss["A"])
    rec = {"step1_loss_path_a": loss["A"], "step1_loss_path_b": loss["B"], "rel_diff": rel}
    # path A's align_pf reads bf16 pf (each value rounded by up to 2^-9), K2
    # keeps pf in f32; the per-patch inner products and their logs move by
    # ~2^-8 relative at most, far below 1% of the total loss
    if not rel < 0.01:
        fail(f"path A and path B disagree on the first step's loss: {rec}")
    model.load_state_dict(snapshot)
    with torch.no_grad():
        feats = model.features(torch.cat(batch[:2]))
    kernel = model.head.add_on_kernel.detach()
    rec["grads"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        for fuse in (False, True):
            key = f"{'nopf' if fuse else 'fused'}_{_dtype_name(dtype)}"
            rec["grads"][key] = head_grad_check(feats.to(dtype), kernel.to(dtype), tree, fuse)
    say(f"{', '.join(['cross-checks'] + [setup.name] * bool(setup.name))}: "
        f"{json.dumps(rec)} [{card}]")
    del model
    torch.cuda.empty_cache()
    return rec


def fused_backbone_checks(card: str, setup: Setup):
    """From the same parameters and batch of ``setup``: path A's and path C's first-step
    losses; then one stage-3 block's gradients (its input and nine
    parameters) through ``FusedCNBlock`` (K4 forward, the unfused
    composition's VJP by recompute) against autograd through
    ``cnblock_branch_unfused``, on the block's input from the batch."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch, cnblock_branch_unfused
    from pipnet_tpu_torch.train import init_train_state
    batch, loss = None, {}
    for fused in (False, True):
        cfg = run_config(setup, fused_backbone=fused)
        model, tree, _ = build_model(setup, cfg)
        if batch is None:
            batch = train_batch(cfg, tree)
        step, scalars = train_step(cfg, model, tree, fuse=False)
        _, m = step(init_train_state(model, seed=0), *batch, scalars)
        loss["C" if fused else "A"] = float(m["loss"])
        if not fused:
            del model, step
    rel = abs(loss["A"] - loss["C"]) / abs(loss["A"])
    rec = {"step1_loss_path_a": loss["A"], "step1_loss_path_c": loss["C"], "rel_diff": rel}
    # the two backbones round apart in bf16 (K4 keeps the depthwise output,
    # the LayerNorm's scale and bias and the products' epilogues in f32), so
    # the features move by bf16 ulps; the loss, a mean over 128 images of
    # smooth terms, moves far less than 1%
    if not rel < 0.01:
        fail(f"path A and path C disagree on the first step's loss: {rec}")
    block = model.backbone.stage3_block0
    seen = {}

    def keep_input(module, args):
        seen["x"] = args[0].detach()

    hook = block.register_forward_pre_hook(keep_input)
    with torch.no_grad():
        model.features(batch[0][:16])
    hook.remove()
    gen = torch.Generator(device="cuda").manual_seed(12)
    r = torch.randn(seen["x"].shape, generator=gen, device="cuda")
    names = ("x", "dw_kernel", "dw_bias", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2",
             "layer_scale")
    rec["block_grads"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        inputs = [seen["x"].to(dtype)] + [p.detach() for p in block.branch_params(dtype)]
        grads = []
        for fn in (cnblock_branch, cnblock_branch_unfused):
            ins = [t.clone().requires_grad_() for t in inputs]
            (fn(*ins, fast_gelu=block.fast_gelu).float() * r).sum().backward()
            grads.append([t.grad.float() for t in ins])
        per = {}
        for name, got, want in zip(names, *grads):
            per[name] = {"rel_l2": ((got - want).norm() / want.norm().clamp(min=1e-30)).item(),
                         "mass_ratio": (got.abs().sum() / want.abs().sum()).item(),
                         "max_err_over_max": ((got - want).abs().max()
                                              / want.abs().max()).item()}
            ok = (per[name]["max_err_over_max"] <= 1e-4 if dtype == torch.float32 else
                  per[name]["rel_l2"] < 0.2 and abs(per[name]["mass_ratio"] - 1) < 0.05)
            if not ok:
                fail(f"block gradients through FusedCNBlock disagree with the unfused "
                     f"composition ({dtype}, {name}): {per[name]}")
        rec["block_grads"][_dtype_name(dtype)] = per
    say(f"fused-backbone cross-checks: {json.dumps(rec)} [{card}]")
    del model
    torch.cuda.empty_cache()
    return rec


def head_grad_check(f, k, tree, fuse):
    """dF and dK through the kernels (K1/K1b, or K2 with its K1 recompute and
    K1b) against autograd through the plain composition, for random linear
    cotangents.  bf16: relative L2 < 0.2 and gradient mass within 5% (the
    kernels' adjoint runs in f32 where the plain composition rounds pf to
    bf16, and near-max values tie differently); f32: max error within 1e-4
    of the largest gradient."""
    from pipnet_tpu_torch.losses.catalog import ALIGN_EPS
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    from pipnet_tpu_torch.ops.segment import segment_softmax, segment_sum_to_nodes
    B, P = f.shape[0], tree.num_protos_padded
    gen = torch.Generator(device="cuda").manual_seed(9)
    r_pooled = torch.randn((B, P), generator=gen, device="cuda")
    r_side = torch.randn((B // 2, tree.num_nodes) if fuse else f.shape[:3] + (P,),
                         generator=gen, device="cuda")

    def kernels(f, k):
        if fuse:
            return fused_head_nopf(f, k, tree, eps=ALIGN_EPS)
        return fused_head(f, k, tree)

    def plain(f, k):
        if not fuse:
            return fused_head_reference(f, k, tree)
        p = segment_softmax(f.float() @ k.float(), tree)
        n = B // 2
        prod = 0.5 * (p[:n] * p[n:].detach() + p[:n].detach() * p[n:])
        return p.amax(dim=(1, 2)), torch.log(segment_sum_to_nodes(prod, tree) + ALIGN_EPS).sum((1, 2))

    grads = []
    for fn in (kernels, plain):
        fg, kg = f.detach().requires_grad_(), k.detach().requires_grad_()
        a, b = fn(fg, kg)
        pooled, side = (a, b) if fuse else (b, a)
        ((pooled * r_pooled).sum() + (side.float() * r_side).sum()).backward()
        grads.append((fg.grad.float(), kg.grad.float()))
    rec = {}
    for name, got, want in zip(("dF", "dK"), *grads):
        rel_l2 = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
        mass = (got.abs().sum() / want.abs().sum()).item()
        err = ((got - want).abs().max() / want.abs().max()).item()
        rec[name] = {"rel_l2": rel_l2, "mass_ratio": mass, "max_err_over_max": err}
        ok = err <= 1e-4 if f.dtype == torch.float32 else (rel_l2 < 0.2 and abs(mass - 1) < 0.05)
        if not ok:
            fail(f"head gradients through the kernels disagree with the plain "
                 f"composition ({'nopf' if fuse else 'fused'}, {f.dtype}): {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 14: the other backbones, BYOL and torch import/export
# ---------------------------------------------------------------------------

# the head's input on the other backbones at 224^2: ResNet-50/101/152 give
# D = 2048 over 28x28 patches (stride-1 layer3/4), DINOv2 ViT-S/14 D = 384
# over 16x16
BACKBONE_SHAPES = {"resnet50": (28, 28, 2048), "dinov2": (16, 16, 384)}
# the seeded ResNet and ViT heads' add-on kernels are scaled so that F K
# spreads with this standard deviation over the served images (as the flat
# setup's, FLAT_LOGIT_STD): the backbones' seeded features differ in scale
# from the ConvNeXt's, and the serving check needs images whose top class
# is clear
BACKBONE_LOGIT_STD = 6.0
# BatchNorm running statistics after one f32 step on the card against the
# same step on the CPU's plain path (TF32 off): the two runs' features differ
# by their convolutions' summation order, f32 rounding carried through 53
# BatchNorms, so each buffer within 1e-4 of its largest value
BN_STATS_REL = 1e-4


def backbone_kernel_checks(card: str):
    """K1, K1b and K2 on the flagship tree at the other backbones' shapes
    (bf16 at the serving B = 8 and the training B = 128, f32 at B = 8), each
    against its plain version, timed beside its bound, the plain version's
    time and ``torch.matmul`` F K's: (K1, K1b, K2) records by name."""
    flag, _ = flagship_tree()
    bf16, f32 = torch.bfloat16, torch.float32
    records, backward, nopf = {}, {}, {}
    for net, (H, W, D) in BACKBONE_SHAPES.items():
        for B, dtype in ((8, bf16), (128, bf16), (8, f32)):
            name = f"{net}_b{B}_{_dtype_name(dtype)}"
            records[name] = check_fused_head(flag, B, H, W, D, dtype, seed=40 + len(records),
                                             timed=True)
            say(f"kernel fused_head {name}: {json.dumps(records[name])} [{card}]")
        for B, dtype in ((128, bf16), (8, f32)):
            name = f"{net}_b{B}_{_dtype_name(dtype)}"
            backward[name] = check_head_backward(flag, B, H, W, D, dtype,
                                                 seed=50 + len(backward), timed=True)
            say(f"kernel head_backward {name}: {json.dumps(backward[name])} [{card}]")
    H, W, D = BACKBONE_SHAPES["resnet50"]
    for pairs, dtype in ((64, bf16), (4, f32)):
        name = f"resnet50_{pairs}pairs_{_dtype_name(dtype)}"
        nopf[name] = check_nopf(flag, pairs, H, W, D, dtype, seed=60 + len(nopf), timed=True)
        say(f"kernel fused_head_nopf {name}: {json.dumps(nopf[name])} [{card}]")
    return records, backward, nopf


def backbone_setup(backbone: str) -> Setup:
    """The flagship run config and tree with another backbone."""
    flag = flagship_setup()
    return Setup(backbone, {"backbone": backbone}, flag.tree_json, flag.classes,
                 logit_std=BACKBONE_LOGIT_STD)


def check_path_launches(label: str, rec: dict, per_step: dict) -> dict:
    check_launches(label, rec["launches"], {**NO_LAUNCHES, **{
        k: v * TIMED_STEPS for k, v in per_step.items()}})
    return rec["launches"]


def bn_statistics_check(card: str, setup: Setup) -> dict:
    """One joint-phase step of ``setup`` in f32 (TF32 off) at 4 images in
    two views, on the card through the kernels and on the CPU through
    their plain versions, from the same weights, statistics and batch:
    every BatchNorm's running statistics moved, and equal on both within
    ``BN_STATS_REL`` of their largest value; the losses within 1e-4."""
    from pipnet_tpu_torch.train import init_train_state
    cfg = run_config(setup)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            model, tree, _ = build_model(setup, cfg, device=dev)
            start = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
            r = np.random.default_rng(5)
            S = cfg.model.image_size
            xs = torch.from_numpy(r.standard_normal((2, 4, S, S, 3)).astype(np.float32))
            ys = torch.from_numpy(r.integers(0, tree.num_classes, 4))
            step, scalars = train_step(cfg, model, tree, fuse=False)
            _, m = step(init_train_state(model, seed=0), xs[0].to(dev), xs[1].to(dev),
                        ys.to(dev), scalars, presence_noise=torch.zeros(
                            (tree.num_protos_padded, 2), device=dev))
            out[dev] = (float(m["loss"]), start, {k: v.detach().cpu().clone()
                                                  for k, v in model.state_dict().items()
                                                  if "running_" in k})
            del model
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (loss_c, start, card_stats), (loss_p, _, cpu_stats) = out["cuda"], out["cpu"]
    errs = {k: ((card_stats[k] - cpu_stats[k]).abs().max()
                / cpu_stats[k].abs().max().clamp(min=1.0)).item() for k in cpu_stats}
    moved = sum(not torch.equal(card_stats[k], start[k].cpu()) for k in start)
    rec = {"buffers": len(errs), "moved": moved, "max_rel_err": max(errs.values()),
           "worst": max(errs, key=errs.get), "loss_card": loss_c, "loss_cpu": loss_p}
    say(f"BatchNorm statistics after one f32 step, {setup.name}, card vs CPU: "
        f"{json.dumps(rec)} [{card}]")
    if moved != len(start) or rec["max_rel_err"] > BN_STATS_REL or \
            abs(loss_c - loss_p) > 1e-4 * abs(loss_p):
        fail(f"{setup.name}: BatchNorm statistics or loss after one step disagree "
             f"between the card and the CPU: {rec}")
    torch.cuda.empty_cache()
    return rec


def pos_embed_check(card: str) -> dict:
    """DINOv2's position-embedding resize (37 -> 16, antialiased bicubic)
    on the card against the CPU's."""
    from pipnet_tpu_torch.models.vit import resize_pos_embed
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 37, 37, 384))
                         .astype(np.float32))
    err = (resize_pos_embed(x.cuda(), 16).cpu() - resize_pos_embed(x, 16)).abs().max().item()
    say(f"DINOv2 pos-embed resize 37 -> 16, card vs CPU: max abs err {err} [{card}]")
    if err > 1e-5:
        fail(f"the position-embedding resize differs on the card: {err}")
    return {"max_abs_err": err}


def byol_phase(card: str) -> dict:
    """BYOL on the flagship ConvNeXt (``use_byol``, the ``byol`` loss):
    path A steps in the pretraining phase (epoch 1) and the joint phase
    (epoch 20), each timed with its launches (K1 1, K1b 1 a step, as
    without BYOL: the target projection runs no head); the BYOL loss
    finite; after a step, the EMA target equals tau * t + (1 - tau) * theta
    recomputed from the step's parameters."""
    from pipnet_tpu_torch.models import byol_tau_schedule
    from pipnet_tpu_torch.train import (Scalars, StepStatics, init_train_state,
                                        make_train_step, phase_for_epoch)
    t0 = time.perf_counter()
    setup = dataclasses.replace(flagship_setup(), name="byol", model={"use_byol": True})
    cfg = run_config(setup)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss=dataclasses.replace(cfg.train.loss, byol=True)))
    model, tree, _ = build_model(setup, cfg)
    xs1, xs2, ys = train_batch(cfg, tree)
    state = init_train_state(model, seed=0)
    out = {}
    for phase_name, epoch, pretrain in (("pretrain", 1, True), ("joint", JOINT_EPOCH, False)):
        statics = StepStatics(phase=phase_for_epoch(epoch, cfg.train, pretrain=pretrain),
                              mask_prune_active=not pretrain, eta_min_net=5e-6)
        scalars = Scalars(net_t=5.0, net_T=100.0, epoch_frac=0.5,
                          align_pf_weight=0.5 if pretrain else 5.0,
                          tanh_weight=5.0 if pretrain else 2.0)
        step = make_train_step(model, tree, cfg, statics)
        for _ in range(WARMUP_STEPS):
            state, m = step(state, xs1, xs2, ys, scalars)
        target0 = {k: v.clone() for k, v in state.byol.items()}
        state, m = step(state, xs1, xs2, ys, scalars)
        tau = byol_tau_schedule(scalars.net_t, scalars.net_T, cfg.train.loss.byol_tau_base,
                                cfg.train.loss.byol_tau_max)
        ema_err = max(((state.byol[k] - (tau * target0[k] + (1 - tau) * state.params[k]))
                       .abs().max() / target0[k].abs().max().clamp(min=1e-30)).item()
                      for k in target0)
        torch.cuda.synchronize()
        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        acc = None
        for _ in range(TIMED_STEPS):
            state, acc = step(state, xs1, xs2, ys, scalars, acc=acc)
        end.record()
        torch.cuda.synchronize()
        rec = {"phase": phase_name, "step_ms": start.elapsed_time(end) / TIMED_STEPS,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts(), "loss_byol": float(acc["loss/byol"]) / TIMED_STEPS,
               "loss": float(acc["loss"]) / TIMED_STEPS, "tau": tau,
               "ema_max_rel_err": ema_err, "target_entries": len(target0)}
        say(f"BYOL path A, {phase_name}: {json.dumps(rec)} [{card}]")
        if not (np.isfinite(rec["loss_byol"]) and np.isfinite(rec["loss"])) or \
                rec["loss_byol"] <= 0 or ema_err > 1e-6:
            fail(f"BYOL {phase_name}: {rec}")
        out[phase_name] = check_path_launches(f"BYOL path A, {phase_name}", rec,
                                              {"fused_head": 1, "head_backward": 1})
    say(f"BYOL: {time.perf_counter() - t0:.1f} s")
    del model, state
    torch.cuda.empty_cache()
    return out


def interop_check(card: str, run_dir: str) -> dict:
    """The port's export CLI on ``run_dir`` (a seeded ResNet-50 run), the
    reference checkpoint re-imported by ``convert_reference_pipnet`` into a
    fresh model on the card: its logits on the served batch equal the run's
    bit for bit (K1 launches: one forward each)."""
    from PIL import Image
    from pipnet_tpu_torch.data.augment import EvalTransform
    from pipnet_tpu_torch.models import build_pipnet
    from pipnet_tpu_torch.models.torch_export import run as export_cli
    from pipnet_tpu_torch.models.torch_import import (convert_reference_pipnet,
                                                      load_torch_state_dict)
    from pipnet_tpu_torch.run_io import load_run
    from pipnet_tpu_torch.tree import Node
    t0 = time.perf_counter()
    out = os.path.join(run_dir, "reference_net.pth")
    if export_cli(["--run_dir", run_dir, "--out", out]) != 0:
        fail("the export CLI failed")
    t_export = time.perf_counter() - t0
    bundle = load_run(run_dir, device="cuda")
    sd = load_torch_state_dict(out)
    with open(os.path.join(run_dir, "metadata", "tree.json")) as f:
        root = Node.from_dict(json.load(f))
    model, tree = build_pipnet(root, bundle.cfg.model, weighted=bundle.cfg.train.loss.weighted_ce,
                               class_names=bundle.classes, device="cuda")
    model.load_state_dict(convert_reference_pipnet(sd, tree, bundle.cfg.model.backbone))
    S = bundle.cfg.model.image_size
    xs = torch.from_numpy(np.stack([EvalTransform(S)(Image.fromarray(im))
                                    for im in synthetic_images(8, 256, seed=2)])).cuda()
    zero_counts()
    with torch.inference_mode():
        want = bundle.model(xs, inference=True)["logits"]
        got = model(xs, inference=True)["logits"]
    torch.cuda.synchronize()
    launches = counts()
    rec = {"tensors": len(sd), "export_s": t_export, "logits_equal": bool(torch.equal(got, want)),
           "logits_max_abs": want.float().abs().max().item(),
           "seconds": time.perf_counter() - t0}
    say(f"interop, export -> import, resnet50: {json.dumps(rec)} [{card}]")
    if not rec["logits_equal"]:
        fail(f"re-imported logits differ from the run's: {rec}")
    check_launches("interop", launches, {**NO_LAUNCHES, "fused_head": 2})
    return launches


def backbones_phase(card: str) -> dict:
    """Phase 14: ResNet-50 served and trained (paths A and B, the
    cross-checks, BatchNorm statistics against the CPU), DINOv2 ViT-S/14
    served and trained (path A), BYOL on the flagship ConvNeXt, and the
    export/import round trip; returns the launches by path."""
    t0 = time.perf_counter()
    paths, seconds = {}, {}
    resnet, vit = backbone_setup("resnet50"), backbone_setup("dinov2_vits14")
    for setup in (resnet, vit):
        t = time.perf_counter()
        paths[f"serving, {setup.name}"] = serving_phase(card, setup)
        seconds[f"serving, {setup.name}"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["interop"] = interop_check(card, "_".join([RUN_DIR, resnet.name]))
    seconds["interop"] = time.perf_counter() - t
    pos_embed_check(card)
    for setup, fuse in ((resnet, False), (resnet, True), (vit, False)):
        t = time.perf_counter()
        if fuse:
            cross_checks(card, setup)
        rec = training_phase(card, setup, fuse=fuse)
        per_step = {"fused_head": 1, "head_backward": 1, **({"fused_head_nopf": 1} if fuse else {})}
        label = f"training {'B' if fuse else 'A'}, {setup.name}"
        paths[label] = check_path_launches(label, rec, per_step)
        seconds[label] = time.perf_counter() - t
    t = time.perf_counter()
    bn_statistics_check(card, resnet)
    seconds["BatchNorm statistics"] = time.perf_counter() - t
    t = time.perf_counter()
    for phase_name, launches in byol_phase(card).items():
        paths[f"training A, BYOL {phase_name}"] = launches
    seconds["BYOL"] = time.perf_counter() - t
    say(f"phase 14 (other backbones and interop): {time.perf_counter() - t0:.1f} s; "
        f"seconds by part: {json.dumps(seconds)}")
    return paths


# ---------------------------------------------------------------------------
# phase 15: the options that once raised (ROADMAP item 11)
# ---------------------------------------------------------------------------

# --stage4_reducer_net 768,256,gelu|256,128 (the reference's DSL; the head
# then reads D = 128) and --basic_cnext_gaussian_multiplier 3,4|1.0|50
REDUCER_LAYERS = ((768, 256, True), (256, 128, False))
GAUSSIAN = {"gaussian_stages": (3, 4), "gaussian_sigma": 1.0, "gaussian_factor": 50.0}
REDUCER_D = REDUCER_LAYERS[-1][1]
# the OOD set of scripts/runs/eval_full_phase_190.sh
OOD_FIXTURE = "synthetic:20:24:s9"
# the head variants (HeadConfig changes), each served at B = 8 off K1
VARIANT_HEADS = {
    "unit": {"add_on_type": "unit"}, "unit_bias": {"add_on_type": "unit", "add_on_bias": True},
    "project": {"add_on_type": "project"}, "l2": {"add_on_type": "l2"},
    "conv_bias": {"add_on_bias": True}, "no_softmax": {"softmax_tau": None},
    "gumbel": {"softmax_tau": None, "gumbel_softmax": True},
    "spatial": {"softmax_over_channel": True}, "cosine": {"multiply_cs_softmax": True},
    "focal": {"focal": True}}
TRAINED_VARIANT = "unit"
# timed steps of each phase-15 path (each after 2 warm-up steps)
OPTION_STEPS = 5
# a variant head's f32 logits on the card against the CPU's on the same
# features (TF32 off): the two differ by summation order over D = 768, so
# within 1e-5 of the largest logit, and pooled within 1e-5
VARIANT_TOL = 1e-5
# the f32 step of phase 15's cross-check, card against CPU: its losses within
# 1e-4 relative (the bar of phase 14's BatchNorm check; summation order over
# 18 blocks, the reducer and 2,704 patch rows a view)
OPTION_LOSS_REL = 1e-4


def with_loss(cfg, **loss):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, loss=dataclasses.replace(cfg.train.loss, **loss)))


def option_step(cfg, model, tree, epoch: int, pretrain: bool, has_ood: bool = False):
    """``make_train_step`` at ``epoch`` (1 with ``pretrain``: the
    pretraining phase; 20: the joint phase, mask-prune on) with the
    Trainer's scalars for it."""
    from pipnet_tpu_torch.train import (Scalars, StepStatics, make_train_step,
                                        phase_for_epoch)
    statics = StepStatics(phase=phase_for_epoch(epoch, cfg.train, pretrain=pretrain),
                          mask_prune_active=not pretrain, has_ood=has_ood, eta_min_net=5e-6)
    nr = cfg.train.epochs_pretrain
    scalars = Scalars(net_t=5.0, net_T=100.0, epoch_frac=0.5,
                      align_pf_weight=epoch / nr if pretrain else 5.0,
                      tanh_weight=5.0 if pretrain else 2.0)
    return make_train_step(model, tree, cfg, statics), scalars


def timed_steps(card: str, label: str, step, state, batch, scalars, per_step: dict,
                n: int = OPTION_STEPS):
    """2 warm-up steps, then ``n`` timed by CUDA events with the kernels'
    launches (exactly ``per_step`` a step), peak memory and the mean
    losses; returns (state, record)."""
    for _ in range(2):
        state, _ = step(state, *batch, scalars)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    acc = None
    for _ in range(n):
        state, acc = step(state, *batch, scalars, acc=acc)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    rec = {"path": label, "rows": int(batch[2].shape[0]), "timed_steps": n,
           "step_ms": start.elapsed_time(end) / n, "host_step_ms": host_s * 1e3 / n,
           "images_per_s": int(batch[2].shape[0]) * n / host_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts(),
           "mean_losses": {k: float(v) / n for k, v in acc.items()
                           if k == "loss" or k.startswith("loss/")}}
    say(f"phase 15, {label}: {json.dumps(rec)} [{card}]")
    if not all(np.isfinite(list(rec["mean_losses"].values()))):
        fail(f"{label}: non-finite losses {rec}")
    check_launches(label, rec["launches"], {**NO_LAUNCHES, **{
        k: v * n for k, v in per_step.items()}})
    return state, rec


def option_kernel_checks(card: str):
    """K1, K1b and K2 on the flagship tree at the reducer's width D = 128
    (26x26 patches): K1 bf16 at B = 8 and 128 and f32 at 8, K1b bf16 at
    128 and f32 at 8, K2 bf16 at 64 pairs and f32 at 4, each against its
    plain version and timed beside its bound and the plain version's and
    ``torch.matmul``'s times."""
    flag, _ = flagship_tree()
    bf16, f32 = torch.bfloat16, torch.float32
    H, W, D = 26, 26, REDUCER_D
    records, backward, nopf = {}, {}, {}
    for B, dtype in ((8, bf16), (128, bf16), (8, f32)):
        name = f"reducer{D}_b{B}_{_dtype_name(dtype)}"
        records[name] = check_fused_head(flag, B, H, W, D, dtype, seed=70 + len(records),
                                         timed=True)
        say(f"kernel fused_head {name}: {json.dumps(records[name])} [{card}]")
    for B, dtype in ((128, bf16), (8, f32)):
        name = f"reducer{D}_b{B}_{_dtype_name(dtype)}"
        backward[name] = check_head_backward(flag, B, H, W, D, dtype, seed=80 + len(backward),
                                             timed=True)
        say(f"kernel head_backward {name}: {json.dumps(backward[name])} [{card}]")
    for pairs, dtype in ((64, bf16), (4, f32)):
        name = f"reducer{D}_{pairs}pairs_{_dtype_name(dtype)}"
        nopf[name] = check_nopf(flag, pairs, H, W, D, dtype, seed=90 + len(nopf), timed=True)
        say(f"kernel fused_head_nopf {name}: {json.dumps(nopf[name])} [{card}]")
    return records, backward, nopf


def align_uniform_parts(card: str, model, image_size: int) -> dict:
    """Where the align/uniform losses' time goes: random features of the
    step's shape (flagship: 128 x 26 x 26 x 768 bf16, 43,264 rows a view),
    the losses' forward and backward alone, timed by CUDA events and
    profiled, with their own peak memory."""
    from pipnet_tpu_torch.losses.catalog import align_and_uniform
    with torch.inference_mode():
        _, H, W, D = model.features(torch.zeros((1, image_size, image_size, 3),
                                                device="cuda")).shape
    r = np.random.default_rng(3)
    f0 = torch.from_numpy(r.standard_normal((2 * TRAIN_BATCH, H, W, D)).astype(np.float32))
    f0 = f0.to("cuda", model.dtype)

    def run():
        f = f0.detach().requires_grad_(True)
        a, u = align_and_uniform(f, align=True, uni=True)
        (0.5 * a + 3.0 * u).backward()
        return a, u

    zero_counts()
    a, u = run()
    launches = {k: v for k, v in counts().items() if v}
    if launches != {"uniform_pairs": 2, "uniform_pairs_backward": 2}:
        fail(f"the align/uniform losses alone launched {launches}: K5 and K5b once a view")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n = TRAIN_BATCH * H * W
    rec = {"rows_per_view": n, "align": float(a), "uniform": float(u), "launches": launches,
           "ms": time_ms(run, iters=3, warmup=1),
           "peak_extra_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    rec["profile"] = profile_ms(run, n=2)
    # the products: the forward's upper half and the backward's two full
    # products, both views
    rec["product_tflop"] = 2 * (2.0 * n * n * D / 2 + 2 * 2.0 * n * n * D) / 1e12
    say(f"phase 15, align/uniform losses alone: {json.dumps(rec)} [{card}]")
    return rec


def ood_chunk(size: int, image_size: int):
    """One chunk of ``size`` OOD images in two views (the host's
    augmentation) from the OOD fixture's train loader, as
    ``Trainer.run_epoch`` draws it (``_ood_chunks``)."""
    from pipnet_tpu_torch.data import build_loaders
    from pipnet_tpu_torch.datasets import resolve_dataset
    from pipnet_tpu_torch.train.trainer import _ood_chunks
    t0 = time.perf_counter()
    otrain, otest, oproj, _ = resolve_dataset(OOD_FIXTURE, seed=1)
    loaders = build_loaders(otrain, otest, project_dir=oproj, image_size=image_size,
                            batch_size=size,
                            batch_size_pretrain=size, seed=1, num_workers=4)
    x1, x2 = next(_ood_chunks(loaders.train, 1, size))
    return x1, x2, time.perf_counter() - t0


def variant_heads_check(card: str, model, tree, cfg) -> dict:
    """Each head variant on the flagship backbone's served features at
    B = 8 (bf16): launches (K1 none), finite logits, the forward's time;
    then in f32 on the same features, card (TF32 off) against CPU.
    Restores the model's own head."""
    from PIL import Image
    from pipnet_tpu_torch.data.augment import EvalTransform
    from pipnet_tpu_torch.models.heads import PrototypeHead
    own = model.head
    S = cfg.model.image_size
    xs = torch.from_numpy(np.stack([EvalTransform(S)(Image.fromarray(im))
                                    for im in synthetic_images(SERVE_IMAGES, 256, seed=2)])).cuda()
    with torch.inference_mode():
        f32_features = model.features(xs).float()
    bias = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.02, tree.num_protos_padded).astype(np.float32))
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, changes in VARIANT_HEADS.items():
            hcfg = dataclasses.replace(cfg.model.head, **changes)
            head = PrototypeHead(tree, hcfg, own.add_on_kernel.shape[0])
            state = {k: v.detach().cpu() for k, v in own.state_dict().items()}
            if hcfg.add_on_bias:
                state["add_on_bias"] = bias
            head.load_state_dict(state)
            model.head = head.cuda()
            zero_counts()
            with torch.inference_mode():
                served = model(xs, inference=True)
            torch.cuda.synchronize()
            launches = counts()
            rec = {"launches": launches, "fused": head.fused,
                   "logits_finite": bool(torch.isfinite(served["logits"].float()).all()),
                   "top1": served["logits"].float().argmax(-1).tolist()}
            with torch.inference_mode():
                rec["forward_ms"] = time_ms(lambda: model(xs, inference=True), iters=5)
            torch.backends.cuda.matmul.allow_tf32 = False
            with torch.inference_mode():
                card_out = head(f32_features)
                cpu_out = head.cpu()(f32_features.cpu())
            model.head = own
            scale = cpu_out["logits"].abs().max().clamp(min=1e-30)
            rec["logits_max_rel_err"] = ((card_out["logits"].cpu() - cpu_out["logits"]).abs()
                                         .max() / scale).item()
            rec["pooled_max_abs_err"] = (card_out["pooled"].cpu()
                                         - cpu_out["pooled"]).abs().max().item()
            torch.backends.cuda.matmul.allow_tf32 = tf32
            say(f"phase 15, head variant {name} served at B = {SERVE_IMAGES}: "
                f"{json.dumps(rec)} [{card}]")
            if not rec["logits_finite"] or rec["fused"] or \
                    rec["logits_max_rel_err"] > VARIANT_TOL or \
                    rec["pooled_max_abs_err"] > VARIANT_TOL:
                fail(f"head variant {name}: {rec}")
            check_launches(f"head variant {name}", launches, NO_LAUNCHES)
            out[name] = rec
    finally:
        model.head = own
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def option_cross_check(card: str) -> dict:
    """One joint step in f32 (TF32 off) of the flagship with the Gaussian
    multiplier, the reducer, the CLI's default align and uniformity losses
    and one OOD row in each view's 2 images, on the card through the
    kernels and on the CPU through their plain versions, from the same
    weights and batch, stochastic depth off (the card's generator and the
    CPU's draw different streams): every loss within ``OPTION_LOSS_REL``."""
    from pipnet_tpu_torch.models.convnext import CNBlock
    from pipnet_tpu_torch.train import init_train_state
    setup = dataclasses.replace(flagship_setup(), name="options",
                                model={"stage4_reducer": REDUCER_LAYERS, **GAUSSIAN})
    cfg = with_loss(run_config(setup), align=True, uni=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    r = np.random.default_rng(6)
    S = cfg.model.image_size
    xs = torch.from_numpy(r.standard_normal((2, 2, S, S, 3)).astype(np.float32))
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model, tree, _ = build_model(setup, cfg, device=dev)
            for block in model.modules():
                if isinstance(block, CNBlock):
                    block.sd_prob = 0.0
            ys = torch.tensor([int(r.integers(0, tree.num_classes)), -1]) if dev == "cuda" \
                else out["cuda"][1]
            step, scalars = option_step(cfg, model, tree, JOINT_EPOCH, False, has_ood=True)
            zero_counts()
            _, m = step(init_train_state(model, seed=0), xs[0].to(dev), xs[1].to(dev),
                        ys.to(dev), scalars, presence_noise=torch.zeros(
                            (tree.num_protos_padded, 2), device=dev))
            out[dev] = ({k: float(v) for k, v in m.items()
                         if k == "loss" or k.startswith("loss/")}, ys, counts())
            del model
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    card_l, cpu_l = out["cuda"][0], out["cpu"][0]
    errs = {k: abs(card_l[k] - cpu_l[k]) / max(abs(cpu_l[k]), 1e-30) for k in cpu_l}
    rec = {"losses_card": card_l, "losses_cpu": cpu_l, "rel_errs": errs,
           "launches_card": out["cuda"][2]}
    say(f"phase 15, f32 step with every option, card vs CPU: {json.dumps(rec)} [{card}]")
    if set(card_l) != set(cpu_l) or max(errs.values()) > OPTION_LOSS_REL or \
            not {"loss/align", "loss/uniform", "loss/ood_bce"} <= set(card_l):
        fail(f"the options' f32 step disagrees between the card and the CPU: {rec}")
    # the joint phase trains the backbone: K5 and K5b once a view in f32
    check_launches("phase 15 cross-check", out["cuda"][2],
                   {**NO_LAUNCHES, "fused_head": 1, "head_backward": 1, "uniform_pairs": 2,
                    "uniform_pairs_backward": 2})
    torch.cuda.empty_cache()
    return rec


def options_cli(card: str, log_dir: str) -> dict:
    """``run_pipnet`` with the flagship's flags, the JAX CLI's own defaults
    for ``--align`` and ``--uni`` (the flags left out) and ``--OOD_dataset``:
    one pretraining epoch and two joint epochs (no classifier-only epochs,
    backbone unfrozen) on ``synthetic:190:2``, a quarter of the training
    images a class of phase 11's set (the same test set); each epoch's
    launches as derived (K1 and K1b once a step) and its align, uniformity
    and OOD losses finite."""
    from pipnet_tpu_torch.main import run_pipnet
    argv = flagship_cli_argv(log_dir)
    for flag in ("--align", "--uni"):
        i = argv.index(flag)
        del argv[i:i + 2]
    changes = {"--dataset": "synthetic:190:2", "--epochs_finetune_classifier": "0",
               "--epochs_finetune": "0", "--freeze_epochs": "0"}
    for flag, value in changes.items():
        argv[argv.index(flag) + 1] = value
    argv += ["--OOD_dataset", OOD_FIXTURE]
    calls, trainers = [], []
    stdout = sys.stdout
    t0 = time.perf_counter()
    with recorded_trainer(calls, trainers):
        if run_pipnet(argv) != 0:
            fail("the options' CLI run returned non-zero")
    if sys.stdout is not stdout:
        fail("run_pipnet left sys.stdout replaced")
    rec = {"argv": " ".join(argv), "cli_s": time.perf_counter() - t0, "calls": calls}
    shape = [(c["call"], c.get("epoch"), c.get("phase")) for c in calls]
    if shape != [("run_epoch", 1, "pretrain"), ("run_epoch", 1, "train"),
                 ("evaluate", None, None), ("run_epoch", 2, "train"), ("evaluate", None, None)]:
        fail(f"the options' CLI run's epochs {shape}")
    for c in calls:
        check_launches(f"options CLI {c['call']} {c.get('epoch')} {c.get('phase')}",
                       c["launches"], expected_launches(c))
    parts = {}
    for split, want in (("pretrain", ("loss/align", "loss/uniform")),
                        ("train", ("loss/align", "loss/uniform", "loss/ood_bce"))):
        with open(os.path.join(log_dir, f"metrics_{split}.jsonl")) as f:
            row = json.loads(f.read().splitlines()[-1])
        parts[split] = {k: row.get(k) for k in want}
        if any(v is None or not np.isfinite(v) for v in parts[split].values()):
            fail(f"the options' CLI run's {split} losses: {parts[split]}")
    rec["losses"] = parts
    rec["run_dir"] = check_run_dir(log_dir, trainers[-1].tree)
    say(f"phase 15, the CLI with --align/--uni defaults and --OOD_dataset: "
        f"{json.dumps(rec)} [{card}]")
    launches = {k: sum(c["launches"][k] for c in calls) for k in NO_LAUNCHES}
    del trainers
    torch.cuda.empty_cache()
    return launches


def options_phase(card: str) -> dict:
    """Phase 15: the CLI's default align/uniform losses (path A, pretraining
    and joint), an OOD step, the head variants served and one trained, the
    Gaussian-multiplier and reducer model served and trained (and with the
    fused backbone, which the multiplier leaves), the f32 cross-check
    against the CPU and a CLI run; returns the launches by path."""
    from pipnet_tpu_torch.train import init_train_state
    t0 = time.perf_counter()
    paths, seconds, recs = {}, {}, {}
    flagship = flagship_setup()

    # the CLI's default feature losses on path A, and path A without them
    t = time.perf_counter()
    cfg = with_loss(run_config(flagship), align=True, uni=True)
    model, tree, _ = build_model(flagship, cfg)
    batch = train_batch(cfg, tree)
    state = init_train_state(model, seed=0)
    for label, epoch, pretrain, c in (
            ("align/uniform, pretraining", 1, True, cfg),
            ("align/uniform, joint", JOINT_EPOCH, False, cfg),
            ("path A without them, joint", JOINT_EPOCH, False, run_config(flagship))):
        step, scalars = option_step(c, model, tree, epoch, pretrain)
        # K5 and K5b once a view and step where the uniformity loss is on
        k5 = {"uniform_pairs": 2, "uniform_pairs_backward": 2} if c.train.loss.uni else {}
        state, recs[label] = timed_steps(card, label, step, state, batch, scalars,
                                         {"fused_head": 1, "head_backward": 1, **k5})
        paths[label] = recs[label]["launches"]
    recs["align/uniform alone"] = align_uniform_parts(card, model, cfg.model.image_size)
    seconds["align/uniform"] = time.perf_counter() - t

    # a step with an OOD chunk: 64 labelled and 64 OOD images in two views
    t = time.perf_counter()
    ox1, ox2, ood_s = ood_chunk(TRAIN_BATCH, cfg.model.image_size)
    xs1, xs2, ys = batch
    ood_batch = (torch.cat([xs1, torch.from_numpy(ox1).cuda()]),
                 torch.cat([xs2, torch.from_numpy(ox2).cuda()]),
                 torch.cat([ys, torch.full((TRAIN_BATCH,), -1, device="cuda")]))
    step, scalars = option_step(run_config(flagship), model, tree, JOINT_EPOCH, False,
                                has_ood=True)
    state, recs["OOD"] = timed_steps(card, "path A with an OOD chunk, joint", step, state,
                                     ood_batch, scalars, {"fused_head": 1, "head_backward": 1})
    recs["OOD"]["fixture_and_chunk_s"] = ood_s
    if "loss/ood_bce" not in recs["OOD"]["mean_losses"]:
        fail(f"the OOD step has no OOD loss: {recs['OOD']}")
    paths["OOD"] = recs["OOD"]["launches"]
    del ood_batch
    seconds["OOD"] = time.perf_counter() - t

    # the head variants off K1: served, then one trained for a few steps
    t = time.perf_counter()
    recs["variants"] = variant_heads_check(card, model, tree, run_config(flagship))
    from pipnet_tpu_torch.models.heads import PrototypeHead
    own = model.head
    vcfg = run_config(flagship)
    vcfg = dataclasses.replace(vcfg, model=dataclasses.replace(vcfg.model, head=dataclasses.replace(
        vcfg.model.head, **VARIANT_HEADS[TRAINED_VARIANT])))
    head = PrototypeHead(tree, vcfg.model.head, own.add_on_kernel.shape[0])
    head.load_state_dict({k: v.detach().cpu() for k, v in own.state_dict().items()})
    model.head = head.cuda()
    step, scalars = option_step(vcfg, model, tree, JOINT_EPOCH, False)
    _, recs["variant step"] = timed_steps(card, f"head variant {TRAINED_VARIANT}, joint step",
                                          step, init_train_state(model, seed=0), batch,
                                          scalars, {}, n=3)
    paths["variant step"] = recs["variant step"]["launches"]
    model.head = own
    seconds["variants"] = time.perf_counter() - t
    del model, state, step, head
    torch.cuda.empty_cache()

    # the Gaussian multiplier and the reducer: served and trained; with the
    # fused backbone configuration the multiplier leaves K4 out
    t = time.perf_counter()
    # the add-on kernel scaled as the other backbones' (the seeded reducer's
    # features differ in scale from the backbone's), so that the served
    # images have a clear top class
    options = dataclasses.replace(flagship, name="gaussian_reducer",
                                  model={"stage4_reducer": REDUCER_LAYERS, **GAUSSIAN},
                                  logit_std=BACKBONE_LOGIT_STD)
    paths["serving, gaussian + reducer"] = serving_phase(card, options)
    cfg = run_config(options)
    model, tree, _ = build_model(options, cfg)
    if model.head.add_on_kernel.shape[0] != REDUCER_D:
        fail(f"the reducer's head reads D = {model.head.add_on_kernel.shape[0]}")
    step, scalars = option_step(cfg, model, tree, JOINT_EPOCH, False)
    _, recs["gaussian + reducer"] = timed_steps(
        card, "gaussian + reducer, path A joint", step, init_train_state(model, seed=0),
        train_batch(cfg, tree), scalars, {"fused_head": 1, "head_backward": 1})
    paths["training A, gaussian + reducer"] = recs["gaussian + reducer"]["launches"]
    del model, step
    torch.cuda.empty_cache()
    fcfg = run_config(options, fused_backbone=True)
    model, tree, _ = build_model(options, fcfg)
    xs = train_batch(fcfg, tree)[0][:SERVE_IMAGES]
    zero_counts()
    with torch.inference_mode():
        model(xs, inference=True)
    torch.cuda.synchronize()
    paths["fused backbone with the multiplier"] = counts()
    check_launches("fused backbone with the Gaussian multiplier", counts(),
                   {**NO_LAUNCHES, "fused_head": 1})
    del model
    torch.cuda.empty_cache()
    seconds["gaussian + reducer"] = time.perf_counter() - t

    t = time.perf_counter()
    recs["cross-check"] = option_cross_check(card)
    seconds["cross-check"] = time.perf_counter() - t
    t = time.perf_counter()
    with scratch_dir("pipnet_options_") as log_dir:
        paths["options CLI"] = options_cli(card, log_dir)
    seconds["CLI"] = time.perf_counter() - t
    say(f"phase 15 (the options): {time.perf_counter() - t0:.1f} s; seconds by part: "
        f"{json.dumps(seconds)}")
    return paths


# ---------------------------------------------------------------------------
# phase 16: the train step on a data mesh (runtime/mesh.py)
# ---------------------------------------------------------------------------

# the world-1 mesh step against path A's on the same parameters and batch:
# the mesh step reduces align_pf from each row's log sums (the rows' maps
# stay on their rank) and normalises nothing else differently, so its loss
# and metrics differ from path A's by f32 summation order only (1e-5
# relative); its head gradients pass through the same kernels on the same
# bf16 pf, whose gradient may round one bf16 ulp apart (relative L2 1e-2)
MESH_LOSS_REL, MESH_GRAD_REL = 1e-5, 1e-2
# two ranks of 32 images against one process of 64: the backbone runs at
# another batch, and cuDNN may pick other algorithms, whose bf16 outputs
# round apart over the blocks; the loss within 2e-3 relative, the head
# gradients within the kernels' bf16 bar of the cross-checks (relative L2
# < 0.2, mass within 5%)
RANKS_LOSS_REL = 2e-3
# steps a timed turn of phase 16 (four turns: plain, mesh, mesh, plain)
MESH_TIMED_STEPS = 5
HEAD_GRADS = ("head.add_on_kernel", "head.cls_weight", "head.proto_presence")


def _head_grads(model) -> dict:
    params = dict(model.named_parameters())
    return {n: params[n].grad.detach().float().clone() for n in HEAD_GRADS}


def _grad_gap(got: dict, want: dict) -> dict:
    out = {}
    for n, w in want.items():
        g = got[n].to(w.device)
        out[n] = {"rel_l2": ((g - w).norm() / w.norm().clamp(min=1e-30)).item(),
                  "mass_ratio": (g.abs().sum() / w.abs().sum().clamp(min=1e-30)).item()}
    return out


def mesh_one_rank(card: str, setup: Setup) -> dict:
    """Path A's flagship step through the mesh step on a process group of
    one rank through NCCL, against path A's step without a mesh on the
    same parameters and batch (first step's loss, metrics and head
    gradients), then both timed in turns (plain, mesh, mesh, plain) with
    the mesh step's launches and its busy share."""
    from pipnet_tpu_torch.runtime.mesh import close_ranks, data_mesh, init_ranks
    from pipnet_tpu_torch.train import init_train_state, make_train_step
    with scratch_dir("pipnet_mesh_") as tmp:
        init_ranks(1, 0, "cuda:0",
                   store=torch.distributed.FileStore(os.path.join(tmp, "store"), 1))
        try:
            backend = torch.distributed.get_backend()
            mesh = data_mesh(1, device="cuda:0")
            cfg = run_config(setup)
            model, tree, _ = build_model(setup, cfg)
            xs1, xs2, ys = train_batch(cfg, tree)
            plain, scalars = train_step(cfg, model, tree, fuse=False)
            meshed = make_train_step(model, tree, cfg, _joint_statics(cfg), mesh=mesh)
            snapshot = {k: v.clone() for k, v in model.state_dict().items()}
            first = {}
            for name, step in (("plain", plain), ("plain again", plain), ("mesh", meshed)):
                model.load_state_dict(snapshot)
                _, m = step(init_train_state(model, seed=0), xs1, xs2, ys, scalars)
                first[name] = ({k: v.detach().cpu() for k, v in m.items()}, _head_grads(model))
            (mp, gp), (mq, _), (mm, gm) = first["plain"], first["plain again"], first["mesh"]

            def rel(a, b):
                return {k: ((a[k].double() - b[k].double()).abs().max()
                            / b[k].double().abs().max().clamp(min=1e-30)).item() for k in b}
            # path A against itself: the card's atomics (index_add, scatter)
            # add in another order each run, which the per-node terms
            # amplify (log(tanh(s) + eps) near s = 0); a metric is held at
            # 1e-5, or 4x path A's own spread where that is larger (the
            # gradient norm at the gradients' bar)
            spread, gap = rel(mq, mp), rel(mm, mp)
            bar = {k: max(MESH_GRAD_REL if k == "grad_norm" else MESH_LOSS_REL, 4 * spread[k])
                   for k in gap}
            gaps = _grad_gap(gm, gp)
            rec = {"backend": backend, "world": mesh.world, "loss_plain": float(mp["loss"]),
                   "loss_mesh": float(mm["loss"]), "metric_rel_diff": gap,
                   "plain_rerun_rel_diff": spread, "head_grads": gaps}
            if (set(mm) != set(mp) or any(gap[k] > bar[k] for k in gap)
                    or any(g["rel_l2"] > MESH_GRAD_REL for g in gaps.values())):
                fail(f"mesh: the world-1 mesh step disagrees with path A's: {rec}")

            # both steps ran once above: one more each settles them
            model.load_state_dict(snapshot)
            state = init_train_state(model, seed=0)
            for step in (plain, meshed):
                state, _ = step(state, xs1, xs2, ys, scalars)
            times = {"plain": [], "mesh": []}
            for name in ("plain", "mesh", "mesh", "plain"):
                step = plain if name == "plain" else meshed
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if name == "mesh":
                    zero_counts()
                start.record()
                for _ in range(MESH_TIMED_STEPS):
                    state, _ = step(state, xs1, xs2, ys, scalars)
                end.record()
                torch.cuda.synchronize()
                if name == "mesh":
                    rec.setdefault("launches", counts())
                    check_launches("mesh, one rank", counts(), {
                        **NO_LAUNCHES, "fused_head": MESH_TIMED_STEPS,
                        "head_backward": MESH_TIMED_STEPS})
                times[name].append(start.elapsed_time(end) / MESH_TIMED_STEPS)
            rec["step_ms"] = times
            for name, step in (("plain", plain), ("mesh", meshed)):
                def run(step=step):
                    nonlocal state
                    state, _ = step(state, xs1, xs2, ys, scalars)
                prof = profile_ms(run)
                rec[f"{name}_kernel_ms"] = prof["kernel_ms"]
                if prof["kernel_ms"] != "not measured":
                    rec[f"{name}_busy_share"] = prof["kernel_ms"] / np.mean(times[name])
            ratio = np.mean(times["mesh"]) / np.mean(times["plain"])
            rec["mesh_over_plain"] = ratio
            say(f"mesh, one rank through {backend}: {json.dumps(rec)} [{card}]")
        finally:
            close_ranks()
    del model, state
    torch.cuda.empty_cache()
    # path A's first step, the one-process step the two ranks are held to
    return rec, (float(mp["loss"]), gp)


def _joint_statics(cfg):
    from pipnet_tpu_torch.train import StepStatics, phase_for_epoch
    return StepStatics(phase=phase_for_epoch(20, cfg.train, pretrain=False),
                       mask_prune_active=True, eta_min_net=5e-6)


def mesh_rank(job_path: str, rank: int) -> int:
    """One of two ranks on the one card through gloo (``mesh_two_ranks``):
    joins the group and builds the model, waits for ``<job>.go``, then runs
    the flagship's path A step from seeded weights on this rank's 32 rows
    of the 64, plain and with ZeRO-1 from the same state; writes the loss,
    the metrics, the head gradients, the launches and how far the ZeRO-1
    update is from the plain one to ``<job>.rank<rank>``."""
    import datetime
    from pipnet_tpu_torch.runtime.mesh import (Mesh, close_ranks, data_mesh, init_ranks,
                                               shard_batch, split_moments, state_shardings)
    from pipnet_tpu_torch.train import init_train_state, make_train_step
    sys.path.insert(0, FIXTURES)
    store = torch.distributed.FileStore(job_path + ".store", 2)
    init_ranks(2, rank, "cuda:0", store=store, backend="gloo",
               timeout=datetime.timedelta(seconds=300))
    try:
        mesh = data_mesh(2, device="cuda:0")
        setup = flagship_setup()
        cfg = run_config(setup)
        model, tree, _ = build_model(setup, cfg)
        xs1, xs2, ys = shard_batch(mesh, *train_batch(cfg, tree))
        _, scalars = train_step(cfg, model, tree, fuse=False)
        snapshot = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        deadline = time.monotonic() + 900
        while not os.path.exists(job_path + ".go"):   # the one-rank part times the card
            if time.monotonic() > deadline:
                raise TimeoutError("no go from the parent within 900 s")
            time.sleep(0.05)
        out, updated = {}, {}
        # the card's atomics (index_add, scatter) add in another order each
        # run, so two runs' gradients differ at f32 rounding, and Adam's
        # first step, ~lr sign(g), flips where g is at that rounding: the
        # ZeRO-1 step records its summed gradients and the plain step takes
        # them, so the two updates start from the same gradients
        recorded, all_reduce = {}, Mesh.all_reduce_grads

        def record(self, params):
            all_reduce(self, params)
            recorded.update({n: p.grad.clone() for n, p in params.items() if p.grad is not None})

        def replay(self, params):
            all_reduce(self, params)
            for n, g in recorded.items():
                params[n].grad.copy_(g)
        try:
            for zero1 in (True, False):
                Mesh.all_reduce_grads = record if zero1 else replay
                model.load_state_dict(snapshot)
                state = init_train_state(model, seed=0)
                if zero1:
                    state.opt = split_moments(mesh, state.opt, state_shardings(mesh, state, True))
                step = make_train_step(model, tree, cfg, _joint_statics(cfg), mesh=mesh,
                                       zero1=zero1)
                zero_counts()
                state, m = step(state, xs1, xs2, ys, scalars)
                torch.cuda.synchronize()
                key = "zero1" if zero1 else "plain"
                out[key] = {"loss": float(m["loss"]), "launches": counts(),
                            "metrics": {k: v.detach().cpu() for k, v in m.items()},
                            "head_grads": {n: g.cpu() for n, g in _head_grads(model).items()}}
                updated[key] = {n: p.detach().clone() for n, p in model.named_parameters()}
        finally:
            Mesh.all_reduce_grads = all_reduce
        out["zero1_max_param_diff"] = max(
            (updated["zero1"][n] - p).abs().max().item() for n, p in updated["plain"].items())
        out["zero1_split_moments"] = sum(
            1 for s in state_shardings(mesh, state, True)["mu"].values() if s)
    finally:
        close_ranks()
    torch.save(out, f"{job_path}.rank{rank}")
    return 0


def start_mesh_ranks(job: str) -> list:
    """Start the two ranks of ``mesh_two_ranks`` (``mesh_rank``): they join
    their group and build the model while this process runs the one-rank
    part, then wait for ``<job>.go``.  Each writes its output to
    ``<job>.log<rank>``."""
    code = ("import sys; sys.path.insert(0, {!r}); import chip_smoke; "
            "sys.exit(chip_smoke.mesh_rank({!r}, {}))")
    procs = []
    for r in range(2):
        with open(f"{job}.log{r}", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code.format(REPO, job, r)],
                                          cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return procs


def mesh_two_ranks(card: str, procs: list, job: str, want_loss: float,
                   want_grads: dict) -> dict:
    """Path A's flagship step on two ranks sharing the one card through
    gloo on CUDA tensors (NCCL takes one rank a card), 32 images a rank,
    against the one-process step on the 64 (its loss ``want_loss`` and head
    gradients ``want_grads``, from the same seeded weights and batch): loss
    and head gradients; each rank's K1 and K1b launches in each of its two
    steps; ZeRO-1's update against the plain one from the same gradients,
    bit for bit, on each rank.  A rank that fails fails the phase.
    ``procs`` (``start_mesh_ranks``) start their steps here."""
    t0 = time.perf_counter()
    with open(job + ".go", "w"):
        pass
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        tail = "\n".join(open(f"{job}.log{r}").read()[-3000:] for r in range(2))
        fail(f"mesh: a rank of two failed:\n{tail}")
    ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(2)]
    got = ranks[0]
    rec = {"backend": "gloo", "images_per_rank": TRAIN_BATCH // 2, "steps_s": seconds,
           "loss_one_process": want_loss, "loss_ranks": [r["plain"]["loss"] for r in ranks],
           "loss_zero1_ranks": [r["zero1"]["loss"] for r in ranks],
           "launches_per_rank": [r["plain"]["launches"] for r in ranks],
           "zero1_launches_per_rank": [r["zero1"]["launches"] for r in ranks],
           "zero1_max_param_diff_ranks": [r["zero1_max_param_diff"] for r in ranks],
           "zero1_split_moments": got["zero1_split_moments"],
           "head_grads": _grad_gap(got["plain"]["head_grads"], want_grads)}
    rec["loss_rel_diff"] = abs(got["plain"]["loss"] - want_loss) / abs(want_loss)
    for r, ran in enumerate(ranks):
        for key in ("plain", "zero1"):
            check_launches(f"mesh, two ranks, rank {r}, {key}", ran[key]["launches"],
                           {**NO_LAUNCHES, "fused_head": 1, "head_backward": 1})
    same = all(torch.equal(ranks[1]["plain"]["head_grads"][n], g)
               for n, g in got["plain"]["head_grads"].items())
    rec["ranks_agree"] = same
    if (not same or rec["loss_rel_diff"] > RANKS_LOSS_REL
            or any(g["rel_l2"] >= 0.2 or abs(g["mass_ratio"] - 1) >= 0.05
                   for g in rec["head_grads"].values())
            or any(r["zero1_max_param_diff"] != 0.0 for r in ranks)
            or any(abs(r["zero1"]["loss"] - r["plain"]["loss"]) > 1e-6 * abs(r["plain"]["loss"])
                   for r in ranks)):
        fail(f"mesh: two ranks disagree with the one-process step: {rec}")
    say(f"mesh, two ranks on one card through gloo: {json.dumps(rec)} [{card}]")
    return rec


def mesh_phase(card: str) -> dict:
    """Phase 16: the world-1 mesh step through NCCL, then two ranks on the
    card through gloo (started first, so that their start and build overlap
    the one-rank part); returns the launches of each (the two ranks' as
    their processes counted them, both steps of each rank)."""
    t0 = time.perf_counter()
    with scratch_dir("pipnet_ranks_") as tmp:
        job = os.path.join(tmp, "job")
        procs = start_mesh_ranks(job)
        try:
            one, reference = mesh_one_rank(card, flagship_setup())
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        two = mesh_two_ranks(card, procs, job, *reference)
    ranks = dict(NO_LAUNCHES)
    for launches in two["launches_per_rank"] + two["zero1_launches_per_rank"]:
        for k, v in launches.items():
            ranks[k] += v
    say(f"mesh phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"mesh, one rank": one["launches"], "mesh, two ranks": ranks}


# ---------------------------------------------------------------------------
# phase 17: the train step on a model axis (runtime/mesh.py, --model_parallel)
# ---------------------------------------------------------------------------

# the f32 check's images: on a (1, 2) mesh both ranks run the backbone on
# the same rows, so two f32 ranks hold two whole backbones' activations on
# the one card (~0.3 GB an image in f32 at 224^2): 64 images would not fit
# beside each other; 32 do.  bf16 runs the 64 of path A.
MODEL_F32_IMAGES = 32
# steps timed on each path of phase 17, after the two compared steps
MODEL_TIMED_STEPS = 3
# the evaluation pass: batches of seeded images at 224^2
MODEL_EVAL_BATCHES, MODEL_EVAL_IMAGES = 2, 32
# the model-axis step against the one-process composed step on the same
# parameters and batch.  f32 (TF32 off): the column split changes only the
# summation order of the logits (two partial products summed) and of the
# cut nodes' statistics (none at the flagship), so loss and metrics within
# 1e-5 relative, or 4x the one-process step's own spread where the card's
# atomics (index_add, scatter) make that larger; head gradients within
# 1e-4 relative L2.  bf16: the logits' partial products are each rounded to
# bf16 before they are summed (one bf16 ulp, 2^-8 relative, of each), which
# moves the per-node losses that read them: the loss, and each loss term
# against the loss it adds into, within 2e-3 relative, and the head gradients within the cross-checks' bf16 bar (relative L2 <
# 0.2, mass within 5%).  Updated head parameters: Adam's first steps move a
# parameter by at most ~lr a step, and its sign follows the gradient's,
# which may flip where the gradient is at rounding: every change within
# 2 lr a step of the one-process step's, and (f32) within 1e-6 where the
# first gradient is larger than 1e-3 in magnitude.
MODEL_F32_REL, MODEL_F32_GRAD_REL, MODEL_BF16_LOSS_REL = 1e-5, 1e-4, 2e-3


def model_configs(setup: Setup) -> dict:
    """The flagship run config of phase 17's paths, ``use_pallas_head`` off
    (the JAX Trainer refuses it on a model axis): bf16 (path A's), f32 and
    the fused-backbone configuration (bf16)."""
    def head_off(cfg, **model):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_pallas_head=False, **model))
    cfg = run_config(setup)
    return {"bf16": head_off(cfg), "f32": head_off(cfg, compute_dtype="float32"),
            "fused": head_off(run_config(setup, fused_backbone=True))}


def model_batch(cfg, tree, images: int):
    xs1, xs2, ys = train_batch(cfg, tree)
    return xs1[:images], xs2[:images], ys[:images]


def _whole_param(mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    from pipnet_tpu_torch.runtime.mesh import PROTO_AXIS_PARAMS
    if mesh is not None and name in PROTO_AXIS_PARAMS:
        t = mesh.all_gather(t.contiguous(), dim=PROTO_AXIS_PARAMS[name], axis="model")
    return t.detach().float().cpu()


def composed_steps(cfg, model, tree, batch, steps: int, mesh=None, timed: int = 0,
                   fused_head: bool = False) -> dict:
    """``steps`` joint steps from the seeded state with the head's composed
    operations: its columns on each model rank of ``mesh``, or without one
    the whole head with K1 off (``fused_head``: path A, K1 on); each step's
    metrics, whole head gradients and launches, the whole head parameters
    after them; then ``timed`` more steps timed by CUDA events with the
    peak memory they take."""
    from pipnet_tpu_torch.train import init_train_state, make_train_step
    head = model.head
    scalars = train_step(cfg, model, tree, False)[1]
    if mesh is not None:
        head.shard_columns(mesh)
    else:
        head.fused = fused_head
    try:
        xs1, xs2, ys = batch
        step = make_train_step(model, tree, cfg, _joint_statics(cfg), mesh=mesh)
        state = init_train_state(model, seed=0)
        params = dict(model.named_parameters())
        rec = {"metrics": [], "head_grads": [], "launches": []}
        for _ in range(steps):
            zero_counts()
            state, m = step(state, xs1, xs2, ys, scalars)
            torch.cuda.synchronize()
            rec["launches"].append(counts())
            rec["metrics"].append({k: v.detach().double().cpu() for k, v in m.items()})
            rec["head_grads"].append({n: _whole_param(mesh, n, params[n].grad)
                                      for n in HEAD_GRADS})
        rec["head_params"] = {n: _whole_param(mesh, n, params[n]) for n in HEAD_GRADS}
        if timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            zero_counts()
            start.record()
            for _ in range(timed):
                state, _ = step(state, xs1, xs2, ys, scalars)
            end.record()
            torch.cuda.synchronize()
            rec["timed_launches"] = counts()
            rec["step_ms"] = start.elapsed_time(end) / timed
            rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        if mesh is not None:
            head.gather_columns()
        head.fused = True
    del state, step
    torch.cuda.empty_cache()
    return rec


class ArrayLoader:
    """A loader over fixed host batches ``(xs, ys)``, as ``Trainer.evaluate``
    reads one (no device cache: its dataset is a range)."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = range(sum(len(ys) for _, ys in batches))

    def __len__(self) -> int:
        return len(self.batches)

    def epoch(self, epoch: int):
        from types import SimpleNamespace
        for xs, ys in self.batches:
            yield SimpleNamespace(xs1=xs, xs2=None, ys=ys)


def model_eval(cfg, model, tree, mesh=None) -> dict:
    """One ``Trainer.evaluate`` pass over seeded images, on the whole head
    (gathered from the model ranks of ``mesh`` by ``whole_model``), with its
    launches; beside it on a model rank the same pass by a Trainer without
    a mesh on the gathered model.  Half the images are labelled with the
    class the whole model decodes for them, the other half at random, so
    that the report counts hits and misses."""
    from pipnet_tpu_torch.runtime.log import NullRunLog
    from pipnet_tpu_torch.train.step import make_eval_step
    from pipnet_tpu_torch.train.trainer import Trainer
    r = np.random.default_rng(3)
    S = cfg.model.image_size
    batches = []
    for _ in range(MODEL_EVAL_BATCHES):
        xs = r.standard_normal((MODEL_EVAL_IMAGES, S, S, 3)).astype(np.float32)
        ys = r.integers(0, tree.num_classes, MODEL_EVAL_IMAGES)
        pred = make_eval_step(model, tree)(torch.from_numpy(xs).cuda())["pred"].cpu().numpy()
        ys[::2] = pred[::2]
        batches.append((xs, ys))
    loader = ArrayLoader(batches)
    log = NullRunLog(tempfile.gettempdir())
    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_parallel=1))
    out = {}
    if mesh is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, data_parallel=1, model_parallel=mesh.n_model))
        trainer = Trainer(model, tree, cfg, None, log=log, mesh=mesh)
        model.head.shard_columns(mesh)
        zero_counts()
        out["report"] = trainer.evaluate(loader)
        out["launches"] = counts()
        out["split_after"] = model.head.columns is not None
        model.head.gather_columns()
    zero_counts()
    out["one_process_report"] = Trainer(model, tree, one, None, log=log).evaluate(loader)
    out["one_process_launches"] = counts()
    return out


def model_rank(job_path: str, rank: int) -> int:
    """One of the two ranks of a (1, 2) mesh on the one card through gloo
    (``model_phase``): joins the group and builds phase 17's three models,
    waits for ``<job>.go``, then on its half of the head's columns runs the
    evaluation pass, the bf16 and f32 steps and the fused-backbone step, and
    writes their records to ``<job>.rank<rank>``."""
    import datetime
    from pipnet_tpu_torch.runtime.mesh import close_ranks, dp_mp_mesh, init_ranks
    sys.path.insert(0, FIXTURES)
    store = torch.distributed.FileStore(job_path + ".store", 2)
    init_ranks(2, rank, "cuda:0", store=store, backend="gloo",
               timeout=datetime.timedelta(seconds=300))
    try:
        mesh = dp_mp_mesh(1, 2, device="cuda:0")
        laps = Laps(time.perf_counter())
        setup = flagship_setup()
        cfgs = model_configs(setup)
        built = {k: build_model(setup, cfg)[:2] for k, cfg in cfgs.items()}
        torch.cuda.synchronize()
        laps.lap("build")
        with open(f"{job_path}.ready{rank}", "w"):
            pass
        deadline = time.monotonic() + 900
        while not os.path.exists(job_path + ".go"):   # the parent's part times the card
            if time.monotonic() > deadline:
                raise TimeoutError("no go from the parent within 900 s")
            time.sleep(0.05)
        laps.lap("wait")
        out = {"eval": model_eval(cfgs["bf16"], *built["bf16"], mesh=mesh)}
        laps.lap("eval")
        cfg, (model, tree) = cfgs["bf16"], built.pop("bf16")
        out["bf16"] = composed_steps(cfg, model, tree, model_batch(cfg, tree, TRAIN_BATCH), 2,
                                     mesh=mesh, timed=MODEL_TIMED_STEPS)
        laps.lap("bf16")
        del model
        cfg, (model, tree) = cfgs["f32"], built.pop("f32")
        with tf32_off():
            out["f32"] = composed_steps(cfg, model, tree,
                                        model_batch(cfg, tree, MODEL_F32_IMAGES), 2, mesh=mesh)
        laps.lap("f32")
        del model
        cfg, (model, tree) = cfgs["fused"], built.pop("fused")
        out["fused"] = composed_steps(cfg, model, tree, model_batch(cfg, tree, TRAIN_BATCH), 1,
                                      mesh=mesh)
        laps.lap("fused")
        out["seconds"] = laps.seconds
    finally:
        close_ranks()
    torch.save(out, f"{job_path}.rank{rank}")
    return 0


@contextlib.contextmanager
def tf32_off():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def start_model_ranks(job: str) -> list:
    """Start the two ranks of phase 17 (``model_rank``); each writes its
    output to ``<job>.log<rank>``."""
    code = ("import sys; sys.path.insert(0, {!r}); import chip_smoke; "
            "sys.exit(chip_smoke.model_rank({!r}, {}))")
    procs = []
    for r in range(2):
        with open(f"{job}.log{r}", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code.format(REPO, job, r)],
                                          cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return procs


def model_references(card: str, wait_ranks) -> dict:
    """The one-process records phase 17 holds the ranks to, on the same
    seeded weights and batches: the evaluation pass (K1), the composed
    step in f32 (twice: its own spread), the fused-backbone
    configuration's composed step, and last the composed step in bf16,
    timed with path A beside it after ``wait_ranks()`` (the ranks have
    built their models and left the host)."""
    laps = Laps(time.perf_counter())
    setup = flagship_setup()
    cfgs = model_configs(setup)
    ref = {}
    cfg = cfgs["bf16"]
    model, tree, _ = build_model(setup, cfg)
    laps.lap("build bf16")
    ref["eval"] = model_eval(cfg, model, tree)
    laps.lap("eval")
    bf16 = model, tree
    cfg = cfgs["f32"]
    model, tree, _ = build_model(setup, cfg)
    batch = model_batch(cfg, tree, MODEL_F32_IMAGES)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    with tf32_off():
        ref["f32"] = composed_steps(cfg, model, tree, batch, 2)
        model.load_state_dict(snapshot)
        ref["f32_again"] = composed_steps(cfg, model, tree, batch, 2)
    laps.lap("f32")
    del model, snapshot
    cfg = cfgs["fused"]
    model, tree, _ = build_model(setup, cfg)
    ref["fused"] = composed_steps(cfg, model, tree, model_batch(cfg, tree, TRAIN_BATCH), 1)
    laps.lap("fused")
    del model
    # the timed steps last, once the ranks have built their models
    cfg, (model, tree) = cfgs["bf16"], bf16
    batch = model_batch(cfg, tree, TRAIN_BATCH)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    wait_ranks()
    laps.lap("wait for the ranks' build")
    ref["bf16"] = composed_steps(cfg, model, tree, batch, 2, timed=MODEL_TIMED_STEPS)
    model.load_state_dict(snapshot)
    ref["path_a"] = composed_steps(cfg, model, tree, batch, 1, timed=MODEL_TIMED_STEPS,
                                   fused_head=True)
    laps.lap("bf16 and path A")
    del model, bf16, snapshot
    torch.cuda.empty_cache()
    ref["seconds"] = laps.seconds
    return ref


def _metric_gap(got: dict, want: dict) -> dict:
    return {k: ((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30)).item()
            for k in want}


def _param_check(got: dict, want: dict, grads: dict, lr_steps: float, f32: bool) -> dict:
    out = {}
    for n, w in want.items():
        diff = (got[n] - w).abs()
        rec = {"max_abs_diff": diff.max().item()}
        ok = rec["max_abs_diff"] <= 2 * lr_steps + 1e-6
        if f32:
            big = grads[n].abs() > 1e-3
            rec["max_abs_diff_where_g_large"] = diff[big].max().item() if big.any() else 0.0
            ok = ok and rec["max_abs_diff_where_g_large"] <= 1e-6
        rec["ok"] = ok
        out[n] = rec
    return out


def model_phase(card: str) -> dict:
    """Phase 17: the train step on a (1, 2) mesh, two ranks on the one card
    through gloo on CUDA tensors (NCCL takes one rank a card), each holding
    half of the head's columns of the flagship's P = 3840 and the whole
    batch, against the one-process step with the composed head on the same
    parameters and batch: in f32 (TF32 off, 32 images) and bf16 (64 images)
    two steps each (loss, metrics, whole head gradients, updated head
    parameters), each rank launching no head kernel; their times and peak
    memory beside the one-process composed step's and path A's; one step in
    the fused-backbone configuration (K4 54 a step a rank); one evaluation
    pass on the gathered head (K1 a batch), its report the one-process
    one's.  A rank that fails fails the phase.  Returns the ranks' launches
    (both ranks summed)."""
    from pipnet_tpu_torch.models.convnext import CONVNEXT_TINY_DEPTHS
    t0 = time.perf_counter()
    n_blocks = sum(CONVNEXT_TINY_DEPTHS)
    with scratch_dir("pipnet_model_ranks_") as tmp:
        job = os.path.join(tmp, "job")
        procs = start_model_ranks(job)

        def wait_ranks():
            deadline = time.monotonic() + 300
            while not all(os.path.exists(f"{job}.ready{r}") for r in range(2)):
                if any(p.poll() is not None for p in procs) or time.monotonic() > deadline:
                    tail = "\n".join(open(f"{job}.log{r}").read()[-3000:] for r in range(2))
                    fail(f"model axis: a rank did not build its models:\n{tail}")
                time.sleep(0.05)
        try:
            ref = model_references(card, wait_ranks)
            with open(job + ".go", "w"):
                pass
            t_go = time.perf_counter()
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            tail = "\n".join(open(f"{job}.log{r}").read()[-3000:] for r in range(2))
            fail(f"model axis: a rank of two failed:\n{tail}")
        ranks = [torch.load(f"{job}.rank{r}", weights_only=False) for r in range(2)]
    rec = {"backend": "gloo", "mesh": [1, 2], "ranks_s": time.perf_counter() - t_go,
           "seconds": {"parent": ref["seconds"], "ranks": [r["seconds"] for r in ranks]}}
    bad = []
    optim = run_config(flagship_setup()).train.optim
    lr = max(optim.lr, 10 * optim.lr_block, optim.lr_net)   # the add-on takes 10x lr_block
    for key, steps in (("f32", 2), ("bf16", 2), ("fused", 1)):
        want, got = ref[key], ranks[0][key]
        part = {"loss_one_process": [float(m["loss"]) for m in want["metrics"]],
                "loss_ranks": [[float(m["loss"]) for m in r[key]["metrics"]] for r in ranks],
                "launches_per_step_rank": [r[key]["launches"] for r in ranks]}
        gaps = [_metric_gap(g, w) for g, w in zip(got["metrics"], want["metrics"])]
        part["loss_rel_diff"] = [g["loss"] for g in gaps]
        part["head_grads"] = [_grad_gap(g, w) for g, w in zip(got["head_grads"],
                                                               want["head_grads"])]
        if key == "f32":
            spread = [_metric_gap(a, w) for a, w in zip(ref["f32_again"]["metrics"],
                                                       want["metrics"])]
            part["metric_rel_diff"], part["one_process_rel_spread"] = gaps, spread
            if any(g[k] > max(MODEL_F32_GRAD_REL if k == "grad_norm" else MODEL_F32_REL,
                              4 * s[k]) for g, s in zip(gaps, spread) for k in g):
                bad.append(f"{key} metrics")
            if any(v["rel_l2"] > MODEL_F32_GRAD_REL for g in part["head_grads"]
                   for v in g.values()):
                bad.append(f"{key} head gradients")
        else:
            part["metric_rel_diff"] = {k: max(g[k] for g in gaps) for k in gaps[0]}
            # each loss term against the total it adds into
            terms = [max(abs(float(gm[k] - wm[k])) / abs(float(wm["loss"]))
                         for k in wm if k.startswith("loss/"))
                     for gm, wm in zip(got["metrics"], want["metrics"])]
            part["loss_term_diff_over_loss"] = terms
            if any(g["loss"] > MODEL_BF16_LOSS_REL for g in gaps) or \
                    any(t > MODEL_BF16_LOSS_REL for t in terms):
                bad.append(f"{key} loss")
            if any(v["rel_l2"] >= 0.2 or abs(v["mass_ratio"] - 1) >= 0.05
                   for g in part["head_grads"] for v in g.values()):
                bad.append(f"{key} head gradients")
        part["head_params"] = _param_check(got["head_params"], want["head_params"],
                                           want["head_grads"][0], lr * steps, key == "f32")
        if not all(v["ok"] for v in part["head_params"].values()):
            bad.append(f"{key} updated head parameters")
        k4 = 3 * n_blocks if key == "fused" else 0
        for r in ranks:
            for launches in r[key]["launches"]:
                check_launches(f"model axis, {key} step", launches, {**NO_LAUNCHES, "cnblock": k4})
        same = all(torch.equal(ranks[1][key]["head_params"][n], v)
                   for n, v in got["head_params"].items())
        part["ranks_agree"] = same
        if not same:
            bad.append(f"{key}: the two ranks' gathered heads differ")
        rec[key] = part
    # times and memory: the ranks' step beside the one-process steps
    rec["step_ms"] = {"one_process_composed": ref["bf16"]["step_ms"],
                      "path_a": ref["path_a"]["step_ms"],
                      "ranks": [r["bf16"]["step_ms"] for r in ranks]}
    rec["peak_memory_gb"] = {"one_process_composed": ref["bf16"]["peak_memory_gb"],
                             "path_a": ref["path_a"]["peak_memory_gb"],
                             "ranks": [r["bf16"]["peak_memory_gb"] for r in ranks]}
    for r in ranks:
        check_launches("model axis, timed bf16 steps", r["bf16"]["timed_launches"], NO_LAUNCHES)
    check_launches("model axis, path A's timed steps", ref["path_a"]["timed_launches"], {
        **NO_LAUNCHES, "fused_head": MODEL_TIMED_STEPS, "head_backward": MODEL_TIMED_STEPS})
    # the evaluation pass on the gathered head
    ev = {"report_one_process": ref["eval"]["one_process_report"],
          "reports_ranks": [r["eval"]["report"] for r in ranks],
          "launches_ranks": [r["eval"]["launches"] for r in ranks],
          "split_after": [r["eval"]["split_after"] for r in ranks]}
    rec["eval"] = ev
    for launches in [r["eval"]["launches"] for r in ranks] + [
            ref["eval"]["one_process_launches"]]:
        check_launches("model axis, evaluation pass", launches,
                       {**NO_LAUNCHES, "fused_head": MODEL_EVAL_BATCHES})
    for r in ranks:
        if (r["eval"]["report"] != r["eval"]["one_process_report"]
                or r["eval"]["report"] != ref["eval"]["one_process_report"]
                or not r["eval"]["split_after"]):
            bad.append("the evaluation pass on the gathered head")
    if bad:
        fail(f"model axis: {sorted(set(bad))}: {json.dumps(rec, default=str)}")
    say(f"model axis, two ranks on one card through gloo: {json.dumps(rec)} [{card}]")
    say(f"model phase: {time.perf_counter() - t0:.1f} s [{card}]")
    ranks_launches = dict(NO_LAUNCHES)
    for r in ranks:
        for part in ([r["eval"]["launches"], r["bf16"]["timed_launches"]]
                     + r["bf16"]["launches"] + r["f32"]["launches"] + r["fused"]["launches"]):
            for k, v in part.items():
                ranks_launches[k] += v
    return {"model axis, two ranks": ranks_launches}


# ---------------------------------------------------------------------------
# phase 18: the f32 kernel configuration end to end
# ---------------------------------------------------------------------------

# the flagship run config in f32, the port's default compute_dtype (and the
# CLI's): with the head kernel on (the config's use_pallas_head) K1 and K1b
# run in f32, with the fused backbone K4 too
F32_MODEL = {"compute_dtype": "float32"}
F32_TIMED_STEPS = 5
# served f32 answers against the plain composition on the same images.
# Unfused backbone, the same features: K1's pooled within its kernel bar
# (1e-5), and each logit, a sum of pooled values times the class's
# weights, within 1e-5 times the sum of its weights' magnitudes.  Fused
# backbone: the features come from K4 and from K4's plain version, each of
# the 18 blocks within BLOCK_REL[float32] (2e-5 of its output's scale) of
# the other, so they drift apart by up to ~18 x 2e-5 = 3.6e-4 relative;
# pooled softmax values (at most 1) within 2^-10 and logits within 2^-10 of
# the largest (the bf16 bars, 2^-6 and 2^-4, scaled by f32's finer rounding
# would be far tighter: this bar is set by the summation order, not rounding)
F32_SERVED_TOL = {"pooled": 1e-5, "logits_w": 1e-5}
F32_FUSED_SERVED_TOL = {"pooled": 2.0 ** -10, "logits_rel": 2.0 ** -10}
# path A's and path C's first-step losses from the same parameters and
# batch: both f32 with TF32 off, the backbones differ only by summation
# order (the fused one's depthwise taps, LayerNorm and products in K4), so
# the loss, a mean over 128 images, within 1e-4 relative; path B's against
# path A's with align_eps unset likewise (K2's align_pf term sums the same
# f32 pf products in another order)
F32_PATH_LOSS_REL = 1e-4


def f32_serving(card: str, setup: Setup, fused: bool) -> dict:
    """Serve ``setup`` (the flagship config in f32) at B = 8 through
    ``Predictor`` from a run directory, with the head kernel and, with
    ``fused``, the fused backbone: one forward's launches (K1 1; K4 3 a
    block), ``predict`` (the public entry), the answers against the plain
    composition (K1's and, with ``fused``, K4's plain versions) on the same
    images, and ``bench()``."""
    from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    from pipnet_tpu_torch.serve import Predictor
    label = "f32 serving" + ", fused backbone" * fused
    run_dir = os.path.join(REPO, "build", "smoke_run_f32" + "_fused" * fused)
    write_run_dir(run_dir, setup, fused)
    pred = Predictor(run_dir, batch_size=SERVE_IMAGES, device="cuda")
    mcfg = pred.bundle.cfg.model
    if (mcfg.compute_dtype, mcfg.use_pallas_head, mcfg.use_pallas_backbone) != \
            ("float32", True, fused):
        fail(f"{label}: the run directory's config is {mcfg}")
    images = synthetic_images(SERVE_IMAGES, 256, seed=2)
    xs = torch.from_numpy(pred._prep(images)).cuda()
    zero_counts()
    logits_s, _, _ = pred.forward(xs)
    torch.cuda.synchronize()
    launches = counts()
    blocks = sum(pred.model.backbone.depths) if fused else 0
    check_launches(label, launches, {**NO_LAUNCHES, "fused_head": 1, "cnblock": 3 * blocks})
    answers = pred.predict(images)
    head, tree = pred.model.head, pred.tree
    with torch.inference_mode():
        feats = pred.model.features(xs)
        if fused:
            with plain_blocks():
                feats_p = pred.model.features(xs)
        else:
            feats_p = feats
        k, tau = head.add_on_kernel, head.cfg.softmax_tau
        _, pooled_k = fused_head(feats, k, tree, tau=tau)
        _, pooled_p = fused_head_reference(feats_p, k, tree, tau=tau)
        same_as_served = bool(torch.equal(logits_s, head.classify(pooled_k, inference=True)[1]))
        tol = F32_FUSED_SERVED_TOL if fused else F32_SERVED_TOL
        pooled_err = (pooled_k - pooled_p).abs().max().item()
        # a pooled value within the bar of the inference cut may land on
        # either side of it: take the plain side there, so the logits
        # compare the kernels' values, not the cut
        near = (pooled_p - head.cfg.inference_threshold).abs() < tol["pooled"]
        pooled_k = torch.where(near, pooled_p, pooled_k)
        _, logits_k = head.classify(pooled_k, inference=True)
        _, logits_p = head.classify(pooled_p, inference=True)
        logp_p = joint_leaf_log_distribution(logits_p, tree,
                                             softmax_tau=pred.path_prob_softmax_tau)
        w = head.effective_cls_weight().abs().sum(-1)
    if fused:
        logit_bar = tol["logits_rel"] * logits_p.abs().max()
    else:
        logit_bar = tol["logits_w"] * w + 1e-6
    logit_gap = (logits_k - logits_p).abs()
    top2 = torch.topk(logp_p, 2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 0.1
    plain_top1 = logp_p.argmax(-1)
    served_top1 = torch.tensor([pred.classes.index(a["class"]) for a in answers]).cuda()
    rec = {"images": len(answers), "pooled_max_abs_err": pooled_err,
           "logits_max_abs_err": logit_gap.max().item(),
           "logits_max_err_over_bar": (logit_gap / logit_bar).max().item(),
           "near_threshold": int(near.sum().item()),
           "confident_images": int(confident.sum().item()),
           "top1_agree_served_vs_plain": int((served_top1 == plain_top1)[confident].sum().item()),
           "served_logits_equal_kernel_path": same_as_served,
           "launches_per_forward": launches}
    if fused:
        rec["features_rel_l2"] = ((feats - feats_p).norm() / feats_p.norm()).item()
        rec["features_max_abs_err"] = (feats - feats_p).abs().max().item()
    if pooled_err > tol["pooled"] or rec["logits_max_err_over_bar"] > 1:
        fail(f"{label}: served head disagrees with the plain composition: {rec}, bars {tol}")
    if rec["confident_images"] == 0 or \
            rec["top1_agree_served_vs_plain"] != rec["confident_images"]:
        fail(f"{label}: served top-1 disagrees with the plain composition: {rec}")
    rec["bench"] = pred.bench(iters=10)
    say(f"{label}: {json.dumps(rec)} [{card}]")
    del pred
    torch.cuda.empty_cache()
    return launches


def f32_training(card: str, setup: Setup) -> dict:
    """Paths A (K1, K1b), C (A with the fused backbone: K4, K1, K1b) and B
    (K2, then K1 and K1b in its backward; align_eps unset) of ``setup`` (the
    flagship config in f32) at full width, 64 images in two views at epoch
    20, from the same seeded parameters and batch: each path's first-step
    loss (C within F32_PATH_LOSS_REL of A, B within it of a path-A step from
    B's own parameters with align_eps unset), then 3 warm-up and
    F32_TIMED_STEPS timed steps (CUDA events) with their exact launches, the
    peak memory, and two profiled steps (busy share, the largest kernels,
    the hand-written kernels' time a step)."""
    from pipnet_tpu_torch.models.convnext import CONVNEXT_TINY_DEPTHS
    from pipnet_tpu_torch.ops.fused_head import head_plan, plan_launches
    from pipnet_tpu_torch.train import init_train_state
    batch, recs, paths = None, {}, {}
    n = F32_TIMED_STEPS
    for name in ("A", "C", "B"):
        fused, fuse = name == "C", name == "B"
        cfg = run_config(setup, align_eps_unset=fuse, fused_backbone=fused)
        model, tree, _ = build_model(setup, cfg)
        if batch is None:
            batch = train_batch(cfg, tree)
        if fuse:    # path A's first step from the same parameters, align_eps unset
            snapshot = {k: v.clone() for k, v in model.state_dict().items()}
            step_a, scalars = train_step(cfg, model, tree, fuse=False)
            _, m = step_a(init_train_state(model, seed=0), *batch, scalars)
            first_a = float(m["loss"])
            model.load_state_dict(snapshot)
            del step_a, snapshot, m
        step, scalars = train_step(cfg, model, tree, fuse=fuse)
        state = init_train_state(model, seed=0)
        state, m = step(state, *batch, scalars)
        first = float(m["loss"])
        for _ in range(WARMUP_STEPS - 1):
            state, _ = step(state, *batch, scalars)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        acc = None
        zero_counts()
        start.record()
        for _ in range(n):
            state, acc = step(state, *batch, scalars, acc=acc)
        end.record()
        torch.cuda.synchronize()
        launches = counts()
        paths[f"f32 training {name}"] = launches
        blocks = 3 * sum(CONVNEXT_TINY_DEPTHS) if fused else 0
        # K2 launches as a call on the f32 plan does (one over whole nodes)
        nopf = plan_launches(*head_plan(tree, torch.float32, torch.device("cpu")), 3) if fuse \
            else 0
        check_launches(f"f32 training path {name}", launches, {
            **NO_LAUNCHES, "fused_head": n, "head_backward": n, "cnblock": blocks * n,
            "fused_head_nopf": nopf * n})
        step_ms = start.elapsed_time(end) / n
        rec = {"path": name, "batch": TRAIN_BATCH, "views": 2, "timed_steps": n,
               "step_ms": step_ms, "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "first_step_loss": first, "mean_loss": float(acc["loss"]) / n,
               "launches_per_step": {k: v / n for k, v in launches.items()}}
        if fuse:
            rec["first_step_loss_path_a_align_eps_unset"] = first_a
        if not all(np.isfinite([first, rec["mean_loss"]])):
            fail(f"f32 training path {name}: non-finite loss: {rec}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                state, _ = step(state, *batch, scalars)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
            rec.update({"kernel_ms_per_step": busy, "busy_share": busy / step_ms,
                        "kernels_per_step": sum(e.count for e in kernels) / 2})
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
            rec["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 / 2 for e in top}
            rec["hand_written_ms"] = {
                k: sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3 / 2
                for k in ("fused_head_f32", "head_backward", "cnblock", "fused_head_nopf")}
        else:
            rec["kernel_ms_per_step"] = "not measured"
        recs[name] = rec
        say(f"f32 training path {name}: {json.dumps(rec)} [{card}]")
        del model, state, step, acc
        torch.cuda.empty_cache()
    gaps = {"A_C": abs(recs["A"]["first_step_loss"] - recs["C"]["first_step_loss"])
            / abs(recs["A"]["first_step_loss"]),
            "A_B": abs(first_a - recs["B"]["first_step_loss"]) / abs(first_a)}
    say(f"f32 paths, first-step loss: {json.dumps({'rel_diff': gaps})} [{card}]")
    if not all(rel <= F32_PATH_LOSS_REL for rel in gaps.values()):
        fail(f"f32 paths disagree on the first step's loss: {gaps} relative "
             f"(bar {F32_PATH_LOSS_REL}; A-B with align_eps unset)")
    return paths


def f32_phase(card: str) -> dict:
    """Phase 18: the flagship config in f32 (TF32 off) served with the head
    kernel, then also with the fused backbone, and trained on paths A, C
    and B; returns each path's launches."""
    base = flagship_setup()
    setup = Setup("f32", dict(F32_MODEL), base.tree_json, base.classes)
    with tf32_off():
        say(f"f32 phase: tf32 matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        paths = {f"f32 serving{', fused backbone' * fused}": f32_serving(card, setup, fused)
                 for fused in (False, True)}
        paths.update(f32_training(card, setup))
    return paths


NO_LAUNCHES = {"fused_head": 0, "head_backward": 0, "fused_head_nopf": 0, "dwconv": 0,
               "cnblock": 0, "uniform_pairs": 0, "uniform_pairs_backward": 0}


class Laps:
    """Seconds of each part of the full run, on the host's clock."""

    def __init__(self, t0: float):
        self.t, self.seconds = t0, {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now


def check_launches(path: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{path}: kernel launches {got}, expected exactly {want}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--baseline", metavar="CHECKOUT",
                    help="an older checkout of this repository whose K1 and K2 are timed "
                         "in turns with this one's in the kernel phase")
    ap.add_argument("--only", choices=["blocks", "uniform", "data", "trainer", "eval",
                                       "interp", "backbones", "options", "mesh", "model", "f32"],
                    help="blocks: build, check and time K3 and K4 only; uniform: build, "
                         "check and time K5 and K5b only; data: build, then "
                         "run the training-from-data phase only; trainer: build, then run "
                         "the training-through-the-CLI phase only; eval: build, then "
                         "evaluate a run directory of seeded weights on the data phase's "
                         "fixture; interp: build, then run the interpretability phase on "
                         "such a run directory; backbones: build, check and time K1, K1b "
                         "and K2 at the other backbones' shapes, then run phase 14; "
                         "options: build, check and time K1, K1b and K2 at the reducer's "
                         "width, then run phase 15; mesh: build, then run phase 16 (the "
                         "train step on a data mesh); model: build, then run phase 17 (the "
                         "train step on a model axis); f32: build, check and time K1, K2 and "
                         "K4 in f32, then run phase 18 (the f32 kernel configuration); each "
                         "stops without the kernels record or the ok line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    from pipnet_tpu_torch.models.convnext import CONVNEXT_TINY_DEPTHS
    from pipnet_tpu_torch.ops.build import BUILD_DIR, build, library_path

    name = torch.cuda.get_device_name(0)
    card = card_line()
    say(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    say(card)                 # name, power limit: as nvidia-smi prints them

    sys.path.insert(0, FIXTURES)
    flagship, flat = flagship_setup(), flat_setup()
    from pipnet_tpu_torch import native
    t_native = time.perf_counter()
    native_lib = native.build()          # g++, the data path's normalizer
    seconds = {"native": time.perf_counter() - t_native, **build(KERNEL_SOURCES)}
    say(f"build: {json.dumps(seconds)} s into {BUILD_DIR} and {native_lib.parent}")
    for src in KERNEL_SOURCES:
        log = library_path(src).with_name(library_path(src).name + ".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "rror")):
                say(f"ptxas {src}: {line.strip()}")

    baseline = baseline_kernels(args.baseline) if args.baseline else None
    if args.only == "blocks":
        block_kernel_phase(card, baseline)
        say(f"--only blocks: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "uniform":
        uniform_kernel_checks(card)
        say(f"--only uniform: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "data":
        check_launches("training from data", data_phase(card)["launches"], {
            **NO_LAUNCHES, "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS})
        say(f"--only data: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "trainer":
        with scratch_dir("pipnet_cli_") as cli_dir:
            trainer_phase(card, cli_dir)
        say(f"--only trainer: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "eval":
        with scratch_dir("pipnet_eval_") as run_dir:
            write_run_dir(run_dir, flagship, fused=False)
            eval_phase(card, run_dir, dataset=DATA_FIXTURE)
        say(f"--only eval: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "interp":
        with scratch_dir("pipnet_interp_") as run_dir:
            write_run_dir(run_dir, flagship, fused=False)
            interp_phase(card, run_dir, dataset=DATA_FIXTURE)
        say(f"--only interp: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "backbones":
        backbone_kernel_checks(card)
        backbones_phase(card)
        say(f"--only backbones: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "options":
        option_kernel_checks(card)
        options_phase(card)
        say(f"--only options: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "mesh":
        mesh_phase(card)
        say(f"--only mesh: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "model":
        model_phase(card)
        say(f"--only model: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    if args.only == "f32":
        with tf32_off():
            for name, rec in f32_head_checks(baseline).items():
                say(f"kernel fused_head {name}: {json.dumps(rec)} [{card}]")
            for name, rec in f32_nopf_checks(baseline).items():
                say(f"kernel fused_head_nopf {name}: {json.dumps(rec)} [{card}]")
            for name, rec in f32_block_checks(baseline).items():
                say(f"kernel cnblock {name}: {json.dumps(rec)} [{card}]")
        f32_phase(card)
        say(f"--only f32: done in {time.perf_counter() - t_start:.1f} s; no full run")
        return 0
    laps = Laps(t_start)
    records, backward, nopf = kernel_phase(card, baseline)
    for checks in (backbone_kernel_checks, option_kernel_checks):
        for into, got in zip((records, backward, nopf), checks(card)):
            into.update(got)
    dw, blocks = block_kernel_phase(card, baseline)
    pairs = uniform_kernel_checks(card)
    laps.lap("build and kernels")

    paths = {"depthwise conv op": dwconv_op_path(card),
             "serving": serving_phase(card, flagship),
             "serving, fused backbone": serving_phase(card, flagship, fused=True),
             "serving, flat": serving_phase(card, flat)}
    laps.lap("serving")
    train_a = training_phase(card, flagship, fuse=False)
    check_launches("training path A", train_a["launches"], {
        **NO_LAUNCHES, "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS})
    cross_checks(card, flagship)
    train_b = training_phase(card, flagship, fuse=True)
    check_launches("training path B", train_b["launches"], {
        **NO_LAUNCHES, "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS,
        "fused_head_nopf": TIMED_STEPS})
    fused_backbone_checks(card, flagship)
    train_c = training_phase(card, flagship, fuse=False, fused_backbone=True)
    n_blocks = sum(CONVNEXT_TINY_DEPTHS)
    check_launches("training path C", train_c["launches"], {
        **NO_LAUNCHES, "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS,
        "cnblock": 3 * n_blocks * TIMED_STEPS})
    laps.lap("training A, B, C")
    train_data = data_phase(card)
    laps.lap("training from data")
    check_launches("training from data", train_data["launches"], {
        **NO_LAUNCHES, "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS})
    # flat PIP-Net: K1 and K1b run its 768-wide node as parts, two launches
    # each a call (row statistics, then the pass that writes), K2 three (its
    # third adds each row's parts and takes the log sums)
    train_fa = training_phase(card, flat, fuse=False)
    check_launches("training path A, flat", train_fa["launches"], {
        **NO_LAUNCHES, "fused_head": 2 * TIMED_STEPS, "head_backward": 2 * TIMED_STEPS})
    cross_checks(card, flat)
    train_fb = training_phase(card, flat, fuse=True)
    check_launches("training path B, flat", train_fb["launches"], {
        **NO_LAUNCHES, "fused_head": 2 * TIMED_STEPS, "head_backward": 2 * TIMED_STEPS,
        "fused_head_nopf": 3 * TIMED_STEPS})
    laps.lap("training flat")
    with scratch_dir("pipnet_cli_") as cli_dir:
        _, train_cli = trainer_phase(card, cli_dir)
        laps.lap("trainer")
        _, evaluation = eval_phase(card, cli_dir)
        laps.lap("evaluation")
        _, interpretability = interp_phase(card, cli_dir)
        laps.lap("interpretability")
    paths.update(backbones_phase(card))
    laps.lap("backbones")
    paths.update(options_phase(card))
    laps.lap("options")
    paths.update(mesh_phase(card))
    laps.lap("mesh")
    paths.update(model_phase(card))
    laps.lap("model")
    paths.update(f32_phase(card))
    laps.lap("f32")
    paths.update({"training A": train_a["launches"], "training B": train_b["launches"],
                  "training C": train_c["launches"], "training from data": train_data["launches"],
                  "training through the CLI": train_cli, "evaluation": evaluation,
                  "interpretability": interpretability,
                  "training A, flat": train_fa["launches"],
                  "training B, flat": train_fb["launches"]})
    total = {k: sum(p[k] for p in paths.values()) for k in NO_LAUNCHES}
    say(f"launches by path: {json.dumps(paths)}")

    def entry(name, source, replaces, recs, main, errs):
        return {"name": name, "route": "cuda", "source": f"pipnet_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "launches": total[name],
                "max_abs_err": max(r[e] for r in recs.values() for e in errs),
                **{k: recs[main][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")}}

    kernels = [
        entry("fused_head", "fused_head.cu", "pipnet_tpu/ops/pallas_head.py:73", records,
              "flagship_bf16", ("pf_max_abs_err", "pooled_max_abs_err")),
        entry("head_backward", "head_backward.cu", "pipnet_tpu/ops/pallas_head.py:419",
              backward, "flagship_train_bf16", ("dz_max_abs_err",)),
        entry("fused_head_nopf", "fused_head_nopf.cu", "pipnet_tpu/ops/pallas_head.py:203",
              nopf, "flagship_train_bf16", ("pooled_max_abs_err", "logsum_max_abs_err")),
        entry("dwconv", "dwconv.cu", "pipnet_tpu/ops/pallas_dwconv.py:54", dw, "stage3_bf16",
              ("max_abs_err",)),
        entry("cnblock", "cnblock.cu", "pipnet_tpu/ops/pallas_convnext.py:54", blocks,
              "stage3_bf16", ("max_abs_err",)),
        entry("uniform_pairs", "uniform_pairs.cu",
              "none (pipnet_tpu/losses/catalog.py:137, a lax.scan)", pairs, "flagship_bf16",
              ("max_abs_err",)),
    ]
    kernels[-1]["launches_backward"] = total["uniform_pairs_backward"]
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pipnet_tpu"))
    if jax_modules:
        fail(f"the run loaded JAX or the JAX package: {jax_modules}")
    say(f"seconds by phase: {json.dumps(laps.seconds)}")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
