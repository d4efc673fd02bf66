#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pipnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--baseline CHECKOUT] [--only blocks]

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
   ConvNeXt-tiny-26 stage maps at B=128 (and K4 at the serving B=8), in f32
   and bf16, on small ragged shapes, and K3's gradient against cuDNN's (in
   bf16 K4's three launches also one by one against their plain pieces,
   each timed beside its bound); with the kernel's time, its plain
   version's, one PyTorch library call's where one computes the same
   function, and the card's bound; K1 and K2 also at
   the edges of their bf16 tiling (99 rows, D = 72, bucket widths that do
   not divide the tile, one image, tau = 0.5); K1, K1b and K2 on flat
   PIP-Net's node of 768 prototypes (K1 at B=8 in both dtypes and at 128 in
   bf16, K1b at 128, K2 at 64 pairs) and on nodes of 300 and 2000 and a tree
   mixing a narrow bucket with a node of 300 off an 8-column boundary, all
   wider than a column tile and run as parts; with ``--baseline CHECKOUT``
   an older checkout's K1, K2, K1b and K3 are built and their bf16 launches
   at the main-path shapes timed in turns with these (baseline, this, this,
   baseline);
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
9. flat PIP-Net (the flagship config with ``num_features`` 768 and no
   per-child budget, one node of 768 prototypes over 200 generated classes;
   seeded weights, the add-on kernel scaled so the softmax over 768 peaks):
   a run directory served as in 5 (K1 twice per forward: the row statistics
   over the node's parts, then the pass that writes), path A (K1 2, K1b 2
   per step), the path A / B cross-checks, and path B (K2 3, K1 2, K1b 2).

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  ``--only blocks`` runs
phases 1, 2 and the K3 and K4 checks of phase 3, then stops without
either line: it cannot pass for a full run.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero before
printing either.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
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
KERNEL_SOURCES = ["fused_head", "head_backward", "fused_head_nopf", "dwconv", "cnblock"]

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


def check_head_backward(tree, B, H, W, D, dtype, seed, timed=False, baseline=None):
    """K1b against its plain version on the card, on pf from the forward at
    the same shape and random cotangents; returns a result record (with
    ``baseline``, as ``check_fused_head``)."""
    from pipnet_tpu_torch.ops.fused_head import (fused_head, head_backward,
                                                 head_backward_reference)
    f, k = _features_and_kernel(tree, B, H, W, D, dtype, seed)
    with torch.inference_mode():
        pf, _ = fused_head(f, k, tree)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g_pf = torch.randn(pf.shape, generator=gen, device="cuda").to(dtype)
        g_pooled = torch.randn((B, pf.shape[-1]), generator=gen, device="cuda")
        dz = head_backward(pf, g_pf, g_pooled, tree)
        torch.cuda.synchronize()
        ref = head_backward_reference(pf, g_pf, g_pooled, tree)
        err = (dz.float() - ref.float()).abs()
        over = (err - DZ_REL[dtype] * ref.float().abs()
                - 1e-6 * ref.float().abs().max()).max().item()
        rec = {"shape": [B, H, W, pf.shape[-1]], "dtype": _dtype_name(dtype),
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
            rec.update(bound((pf.numel() * 3) * es + g_pooled.numel() * 4,
                             5.0 * pf.numel(), torch.float32))
    return rec


def check_nopf(tree, pairs, H, W, D, dtype, seed, timed=False, tau=1.0, baseline=None):
    """K2 against its plain version on the card; returns a result record
    (with ``baseline``, as ``check_fused_head``)."""
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    from pipnet_tpu_torch.losses.catalog import ALIGN_EPS
    f, k = _features_and_kernel(tree, 2 * pairs, H, W, D, dtype, seed)
    with torch.inference_mode():
        pooled, logsum = fused_head_nopf(f, k, tree, tau=tau, eps=ALIGN_EPS)
        torch.cuda.synchronize()
        pooled_r, logsum_r = fused_head_nopf_reference(f, k, tree, tau=tau, eps=ALIGN_EPS)
    rec = {"shape": [2 * pairs, H, W, D, tree.num_protos_padded],
           "dtype": _dtype_name(dtype), "tau": tau,
           "pooled_max_abs_err": (pooled - pooled_r).abs().max().item(),
           "logsum_max_abs_err": (logsum - logsum_r).abs().max().item(),
           "logsum_scale": logsum_r.abs().max().item()}
    if not (torch.isfinite(pooled).all() and torch.isfinite(logsum).all()) or \
            rec["pooled_max_abs_err"] > 1e-5 or \
            rec["logsum_max_abs_err"] > LOGSUM_REL * rec["logsum_scale"] + 1e-4:
        fail(f"no-pf head disagrees with its plain version: {rec}")
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


BASELINE_SOURCES = ("fused_head", "fused_head_nopf", "head_backward", "dwconv")


@dataclasses.dataclass
class Baseline:
    """An older checkout's kernel libraries; whether its K1b takes a
    plan of groups of ``sv`` 16-byte vectors (``backward_plan``) or is the
    earlier kernel, which ran on the f32 SIMT column plan; and whether its
    K1, K2 and K1b take split plans (``split_plan``: whole-node groups and
    parts of wide nodes, GF ints a group) or one plan of (col_start, ncols,
    width) triples of whole nodes."""
    libs: dict
    k1b_takes_sv: bool
    takes_split_plan: bool


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
    takes_split = "const void* whole, int Gw" in k1b_src
    return Baseline(libs, takes_split or "int G, int sv," in k1b_src, takes_split)


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


@contextlib.contextmanager
def baseline_launches(baseline: Baseline):
    """The wrappers launch the baseline libraries."""
    import pipnet_tpu_torch.ops.dwconv as dw
    import pipnet_tpu_torch.ops.fused_head as fh
    import pipnet_tpu_torch.ops.fused_head_nopf as fn
    saved = (fh.kernel_entry, fn.kernel_entry, dw.kernel_entry, fh._launch_backward,
             fh._launch, fn._launch)

    def entry(name, symbol, argtypes):
        fn_ = getattr(baseline.libs[name], symbol)
        fn_.argtypes, fn_.restype = list(argtypes), ctypes.c_int
        return baseline.libs[name], fn_
    fh.kernel_entry = fn.kernel_entry = dw.kernel_entry = entry
    if not baseline.takes_split_plan:
        fh._launch, fn._launch, fh._launch_backward = _triple_plan_launchers(baseline.libs)
    if not baseline.k1b_takes_sv:
        fh._launch_backward = _simt_plan_backward(baseline.libs["head_backward"])
    try:
        yield
    finally:
        (fh.kernel_entry, fn.kernel_entry, dw.kernel_entry, fh._launch_backward,
         fh._launch, fn._launch) = saved


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
    records = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_f32", flag, (8, 26, 26, 768), f32, True),
            ("flagship_bf16", flag, (8, 26, 26, 768), bf16, True),
            ("flagship_train_bf16", flag, (128, 26, 26, 768), bf16, True),
            ("multi_bucket_f32", multi, (3, 9, 11, 72), f32, False),
            ("multi_bucket_bf16", multi, (3, 9, 11, 72), bf16, False)):
        records[name] = check_fused_head(tree, *shape, dtype, seed=len(records), timed=timed,
                                         baseline=baseline if dtype == bf16 else None)
    for name, tree, shape, dtype, timed in (
            ("flat_bf16", flat, (8, 26, 26, 768), bf16, True),
            ("flat_train_bf16", flat, (128, 26, 26, 768), bf16, True),
            ("flat_f32", flat, (8, 26, 26, 768), f32, True)):
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
    nopf = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_train_f32", flag, (64, 26, 26, 768), f32, True),
            ("flagship_train_bf16", flag, (64, 26, 26, 768), bf16, True),
            ("multi_bucket_f32", multi, (2, 9, 11, 72), f32, False),
            ("multi_bucket_bf16", multi, (2, 9, 11, 72), bf16, False),
            ("flat_train_bf16", flat, (64, 26, 26, 768), bf16, True),
            ("flat_train_f32", flat, (64, 26, 26, 768), f32, True)) + tuple(
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


def check_cnblock(shape, dtype, fast_gelu, seed, timed=False):
    """K4 against its plain version (the Pallas kernel's rounding order) on
    the card; in bf16 also each of its three launches (``cnblock_dwln``,
    ``cnblock_up``, ``cnblock_down``) against its plain piece on the same
    inputs, at the same bar.  No PyTorch call computes the branch
    (``library_ms`` None); ``unfused_ms`` is the eager composition K4
    replaces; ``parts_ms`` and ``parts_bound_ms`` time each launch alone."""
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
        if dtype == torch.bfloat16:
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
            npix, C = x.numel() // shape[-1], shape[-1]
            es = x.element_size()
            nbytes = (2 * x.numel() + sum(a.numel() for a in args[1:])) * es
            # the two products on the tensor cores (bf16) or SIMT units (f32),
            # the 49 depthwise taps in f32
            rec.update(bound(nbytes, 16.0 * npix * C * C, dtype, f32_ops=2.0 * 49 * npix * C))
            if dtype == torch.bfloat16:
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
    for fast_gelu in (True, False):
        g = "tanh" if fast_gelu else "erf"
        blocks[f"stage3_b8_f32_{g}"] = check_cnblock((SERVE_IMAGES, *last), torch.float32,
                                                     fast_gelu, 45, timed=True)
        for dtype in (torch.float32, torch.bfloat16):
            blocks[f"ragged_{_dtype_name(dtype)}_{g}"] = check_cnblock(
                (2, 9, 11, 40), dtype, fast_gelu, 46)
    for name, rec in blocks.items():
        say(f"kernel cnblock {name}: {json.dumps(rec)} [{card}]")
    return dw, blocks


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


def build_model(setup: Setup, cfg, seed: int = 0):
    """``setup``'s PIPNet for ``cfg`` on the card at full width and depth,
    with seeded random weights in the JAX layout (``random_jax_params``;
    the add-on kernel scaled to ``setup.logit_std`` where that is set)
    converted to the port's: (model, tree, weights in the JAX layout)."""
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.tree import Node
    model, tree = build_pipnet(Node.from_dict(setup.tree_json), cfg.model,
                               weighted=cfg.train.loss.weighted_ce,
                               class_names=setup.classes, device="cuda")
    params = random_jax_params(cfg.model, tree, seed=seed)
    if setup.logit_std is not None:
        if setup.kernel_scale is None:
            model.load_state_dict(params_from_jax(params))
            std = served_logit_std(model, cfg)
            setup.kernel_scale = setup.logit_std / std
            say(f"{setup.name} weights: add-on kernel scaled by {setup.kernel_scale} "
                f"(logit std {std} -> {setup.logit_std})")
        params["head"]["add_on_kernel"] = params["head"]["add_on_kernel"] * setup.kernel_scale
    model.load_state_dict(params_from_jax(params))
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
    from pipnet_tpu_torch.models.convert import params_from_jax
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
    model, _, params = build_model(setup, run_config(setup, fused_backbone=fused), seed)
    del model
    torch.save(params_from_jax(params),
               os.path.join(run_dir, "checkpoints", "net_trained_last.pt"))


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
    say(f"{label} breakdown B={pred.batch_size}: {json.dumps(rec)} [{card}]")


def _wrappers() -> dict:
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    return {"fused_head": fused_head, "head_backward": head_backward,
            "fused_head_nopf": fused_head_nopf, "dwconv": dwconv7x7, "cnblock": cnblock_branch}


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
    before = {n: params[n].detach().clone() for n in WATCHED + ("backbone.stem_conv.weight",)}
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
    if any(moved[n] == 0 for n in WATCHED) or moved["backbone.stem_conv.weight"] != 0:
        fail(f"training path {name}: trainable parameters did not move, or the "
             f"frozen stem did: {moved}")

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


NO_LAUNCHES = {"fused_head": 0, "head_backward": 0, "fused_head_nopf": 0, "dwconv": 0,
               "cnblock": 0}


def check_launches(path: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{path}: kernel launches {got}, expected exactly {want}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--baseline", metavar="CHECKOUT",
                    help="an older checkout of this repository whose K1 and K2 are timed "
                         "in turns with this one's in the kernel phase")
    ap.add_argument("--only", choices=["blocks"],
                    help="blocks: build, check and time K3 and K4 only, then stop without "
                         "the kernels record or the ok line")
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
    seconds = build(KERNEL_SOURCES)
    say(f"build: {json.dumps(seconds)} s into {BUILD_DIR}")
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
    records, backward, nopf = kernel_phase(card, baseline)
    dw, blocks = block_kernel_phase(card, baseline)

    paths = {"depthwise conv op": dwconv_op_path(card),
             "serving": serving_phase(card, flagship),
             "serving, fused backbone": serving_phase(card, flagship, fused=True),
             "serving, flat": serving_phase(card, flat)}
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
    paths.update({"training A": train_a["launches"], "training B": train_b["launches"],
                  "training C": train_c["launches"], "training A, flat": train_fa["launches"],
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
    ]
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pipnet_tpu"))
    if jax_modules:
        fail(f"the run loaded JAX or the JAX package: {jax_modules}")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
