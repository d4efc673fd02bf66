#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pipnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. device: the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its main path gives it (the flagship 190-class tree, 26x26x768
   features: K1 at the serving batch of 8 and the training batch of 128, its
   adjoint K1b at 128, the no-pf head K2 at 64 view pairs; in f32 with TF32
   off and in bf16) and on a small tree with several bucket widths and a
   padded tail; with the kernel's time, its plain version's, one PyTorch
   library call's where one computes the same function, and the card's
   bound;
4. serving: a run directory holding the flagship configuration and tree
   (``artifacts/lou_190_s2/metadata``) and seeded random weights, served by
   ``Predictor`` + ``serve_http`` at full width (ConvNeXt-tiny-26, 224^2,
   bf16); GET /healthz, three POST /predict and one POST /predict_batch;
   the kernel launch counts of those requests; the served answers held
   against the plain head on the same features; ``Predictor.bench()``;
5. training, path A: the flagship run config's train step (epoch 20: joint
   phase, backbone unfrozen, mask-prune on) at full width on 64 images in
   two views, through ``make_train_step``: warm-up steps, then timed steps
   with their exact kernel launches (K1 1, K1b 1 per step), step time,
   images/s, the profiler's kernel time and busy share, peak memory, and
   where the step's time goes;
6. training, path B: the same with ``align_eps`` unset and
   ``fuse_align_pf=True`` (K2 1, K1 1 for the backward's recompute, K1b 1
   per step); before it, the two paths' first-step losses from the same
   parameters and batch, and the head gradients through the kernels
   against autograd through the plain composition on the step's features.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero before
printing either.
"""

from __future__ import annotations

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

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_META = os.path.join(REPO, "artifacts", "lou_190_s2", "metadata")
RUN_DIR = os.path.join(REPO, "build", "smoke_run")
KERNEL_SOURCES = ["fused_head", "head_backward", "fused_head_nopf"]

# H100 SXM published peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the peak for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# a tree whose nodes have 2, 3 and 4 children: with per-child budgets
# max(2, 3 * leaves) it compiles to several bucket widths and a padded tail
MULTI_NEWICK = (
    "((cub_001_A:1,cub_002_B:1,cub_003_C:1):1,"
    "((cub_004_D:1,cub_005_E:1):1,cub_006_F:1,cub_007_G:1,cub_008_H:1):1,"
    "(cub_009_I:1,cub_010_J:1):1);")

# tolerances: f32 (TF32 off) differs from the plain version only by the
# product's summation order; bf16 pf is rounded from f32 values that differ
# that way, so it may land one bf16 ulp (2^-8 below 1.0) apart, while pooled
# is taken in f32 before the cast
TOL = {torch.float32: {"pf": 1e-5, "pooled": 1e-5},
       torch.bfloat16: {"pf": 2.0 ** -8, "pooled": 4e-3}}
# K1b writes dz in pf's dtype from f32 arithmetic that differs from the
# plain version's by summation order: f32 to 1e-5 relative, bf16 within one
# bf16 ulp (2^-7 relative); K2's outputs are f32 in both dtypes (bf16
# products are exact in f32), pooled to 1e-5 and logsum, a sum over 676
# patches of logs, to 1e-5 relative
DZ_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
LOGSUM_REL = 1e-5
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


def multi_bucket_tree():
    from pipnet_tpu_torch.tree import Phylogeny, compile_tree, construct_phylo_tree
    root = construct_phylo_tree(phylo=Phylogeny(newick=MULTI_NEWICK))
    root.assign_all_descendents()
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=3, num_protos_per_child=2,
                            min_protos=0, split_protos=True)
    return compile_tree(root, protopool=False)


def check_fused_head(tree, B, H, W, D, dtype, seed, timed=False):
    """K1 against its plain version on the card; returns a result record."""
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    P = tree.num_protos_padded
    f, k = _features_and_kernel(tree, B, H, W, D, dtype, seed)
    with torch.inference_mode():
        pf, pooled = fused_head(f, k, tree, tau=1.0)
        torch.cuda.synchronize()
        pf_r, pooled_r = fused_head_reference(f, k, tree, tau=1.0)
    if pf.shape != (B, H, W, P) or pooled.shape != (B, P) or pf.dtype != dtype:
        fail(f"fused head output shapes {tuple(pf.shape)} {tuple(pooled.shape)} {pf.dtype}")
    if not (torch.isfinite(pf.float()).all() and torch.isfinite(pooled).all()):
        fail("fused head gave non-finite values")
    pf_err = (pf.float() - pf_r.float()).abs().max().item()
    pooled_err = (pooled - pooled_r).abs().max().item()
    tail = pf[..., ~torch.from_numpy(tree.proto_valid).cuda()]
    rec = {"shape": [B, H, W, D, P], "dtype": str(dtype).replace("torch.", ""),
           "buckets": [[b.num_nodes, b.width] for b in tree.buckets],
           "pf_max_abs_err": pf_err, "pooled_max_abs_err": pooled_err,
           "padded_slots_zero": bool((tail == 0).all().item())}
    tol = TOL[dtype]
    if pf_err > tol["pf"] or pooled_err > tol["pooled"] or not rec["padded_slots_zero"]:
        fail(f"fused head disagrees with its plain version: {rec}, tolerance {tol}")
    if timed:
        with torch.inference_mode():
            rec["ms"] = time_ms(lambda: fused_head(f, k, tree, tau=1.0))
            rec["plain_ms"] = time_ms(lambda: fused_head_reference(f, k, tree, tau=1.0))
            f2 = f.reshape(-1, D)
            rec["library_ms"] = time_ms(lambda: torch.matmul(f2, k))
        covered = int(sum(b.num_nodes * b.width for b in tree.buckets))
        es = f.element_size()
        rec.update(bound((f.numel() + k.numel() + pf.numel()) * es + pooled.numel() * 4,
                         2.0 * B * H * W * D * covered, dtype))
    return rec


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "flops": ops}


def _features_and_kernel(tree, B, H, W, D, dtype, seed):
    r = np.random.default_rng(seed)
    P = tree.num_protos_padded
    limit = np.sqrt(6.0 / (D + P))           # the add-on's xavier-uniform scale
    f = torch.from_numpy(r.standard_normal((B, H, W, D)).astype(np.float32))
    k = torch.from_numpy(r.uniform(-limit, limit, (D, P)).astype(np.float32))
    return f.to("cuda", dtype), k.to("cuda", dtype)


def check_head_backward(tree, B, H, W, D, dtype, seed, timed=False):
    """K1b against its plain version on the card, on pf from the forward at
    the same shape and random cotangents; returns a result record."""
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
        rec = {"shape": [B, H, W, pf.shape[-1]], "dtype": str(dtype).replace("torch.", ""),
               "dz_max_abs_err": err.max().item(), "dz_scale": ref.float().abs().max().item()}
        if over > 0 or not torch.isfinite(dz.float()).all():
            fail(f"head backward disagrees with its plain version: {rec}")
        if timed:
            rec["ms"] = time_ms(lambda: head_backward(pf, g_pf, g_pooled, tree))
            rec["plain_ms"] = time_ms(lambda: head_backward_reference(pf, g_pf, g_pooled, tree),
                                      iters=5)
            rec["library_ms"] = None       # no single PyTorch call computes this
            es = pf.element_size()
            rec.update(bound((pf.numel() * 3) * es + g_pooled.numel() * 4,
                             5.0 * pf.numel(), torch.float32))
    return rec


def check_nopf(tree, pairs, H, W, D, dtype, seed, timed=False):
    """K2 against its plain version on the card; returns a result record."""
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    from pipnet_tpu_torch.losses.catalog import ALIGN_EPS
    f, k = _features_and_kernel(tree, 2 * pairs, H, W, D, dtype, seed)
    with torch.inference_mode():
        pooled, logsum = fused_head_nopf(f, k, tree, eps=ALIGN_EPS)
        torch.cuda.synchronize()
        pooled_r, logsum_r = fused_head_nopf_reference(f, k, tree, eps=ALIGN_EPS)
    rec = {"shape": [2 * pairs, H, W, D, tree.num_protos_padded],
           "dtype": str(dtype).replace("torch.", ""),
           "pooled_max_abs_err": (pooled - pooled_r).abs().max().item(),
           "logsum_max_abs_err": (logsum - logsum_r).abs().max().item(),
           "logsum_scale": logsum_r.abs().max().item()}
    if not (torch.isfinite(pooled).all() and torch.isfinite(logsum).all()) or \
            rec["pooled_max_abs_err"] > 1e-5 or \
            rec["logsum_max_abs_err"] > LOGSUM_REL * rec["logsum_scale"] + 1e-4:
        fail(f"no-pf head disagrees with its plain version: {rec}")
    if timed:
        with torch.inference_mode():
            rec["ms"] = time_ms(lambda: fused_head_nopf(f, k, tree, eps=ALIGN_EPS))
            rec["plain_ms"] = time_ms(lambda: fused_head_nopf_reference(
                f, k, tree, eps=ALIGN_EPS), iters=5)
            f2 = f.reshape(-1, D)
            rec["library_ms"] = time_ms(lambda: torch.matmul(f2, k))
        covered = int(sum(b.num_nodes * b.width for b in tree.buckets))
        es = f.element_size()
        rec.update(bound((f.numel() + k.numel()) * es + (pooled.numel() + logsum.numel()) * 4,
                         2.0 * f.shape[0] * H * W * D * covered, dtype))
    return rec


def kernel_phase(card: str):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    flag, _ = flagship_tree()
    multi = multi_bucket_tree()
    records = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_f32", flag, (8, 26, 26, 768), torch.float32, True),
            ("flagship_bf16", flag, (8, 26, 26, 768), torch.bfloat16, True),
            ("flagship_train_bf16", flag, (128, 26, 26, 768), torch.bfloat16, True),
            ("multi_bucket_f32", multi, (3, 9, 11, 72), torch.float32, False),
            ("multi_bucket_bf16", multi, (3, 9, 11, 72), torch.bfloat16, False)):
        rec = check_fused_head(tree, *shape, dtype, seed=len(records), timed=timed)
        records[name] = rec
        say(f"kernel fused_head {name}: {json.dumps(rec)} [{card}]")
    backward = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_train_f32", flag, (128, 26, 26, 768), torch.float32, True),
            ("flagship_train_bf16", flag, (128, 26, 26, 768), torch.bfloat16, True),
            ("multi_bucket_f32", multi, (4, 9, 11, 72), torch.float32, False),
            ("multi_bucket_bf16", multi, (4, 9, 11, 72), torch.bfloat16, False)):
        backward[name] = check_head_backward(tree, *shape, dtype, seed=10 + len(backward),
                                             timed=timed)
        say(f"kernel head_backward {name}: {json.dumps(backward[name])} [{card}]")
    nopf = {}
    for name, tree, shape, dtype, timed in (
            ("flagship_train_f32", flag, (64, 26, 26, 768), torch.float32, True),
            ("flagship_train_bf16", flag, (64, 26, 26, 768), torch.bfloat16, True),
            ("multi_bucket_f32", multi, (2, 9, 11, 72), torch.float32, False),
            ("multi_bucket_bf16", multi, (2, 9, 11, 72), torch.bfloat16, False)):
        nopf[name] = check_nopf(tree, *shape, dtype, seed=20 + len(nopf), timed=timed)
        say(f"kernel fused_head_nopf {name}: {json.dumps(nopf[name])} [{card}]")
    return records, backward, nopf


def write_run_dir(seed: int = 0) -> None:
    """The flagship metadata beside seeded random weights in the JAX layout,
    converted to the port's state_dict (``checkpoints/net_trained_last.pt``)."""
    from pipnet_tpu_torch.models.convert import params_from_jax, random_jax_params
    tree, cfg = flagship_tree()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(os.path.join(RUN_DIR, "metadata"))
    os.makedirs(os.path.join(RUN_DIR, "checkpoints"))
    for name in ("config.json", "classes.json", "tree.json"):
        shutil.copy(os.path.join(FLAGSHIP_META, name), os.path.join(RUN_DIR, "metadata"))
    torch.save(params_from_jax(random_jax_params(cfg.model, tree, seed=seed)),
               os.path.join(RUN_DIR, "checkpoints", "net_trained_last.pt"))


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


def serving_phase(card: str):
    from PIL import Image
    from pipnet_tpu_torch.models.pipnet import joint_leaf_log_distribution
    from pipnet_tpu_torch.ops.fused_head import fused_head, fused_head_reference
    from pipnet_tpu_torch.serve import Predictor, serve_http

    t0 = time.perf_counter()
    write_run_dir()
    pred = Predictor(RUN_DIR, batch_size=8, device="cuda")
    say(f"serving: run dir written and loaded in {time.perf_counter() - t0:.1f} s "
        f"({len(pred.classes)} classes, P={pred.tree.num_protos_padded}, "
        f"{pred.bundle.cfg.model.backbone}, {pred.bundle.cfg.model.compute_dtype})")
    S = pred.image_size
    single = synthetic_images(3, 256, seed=1)
    batch = synthetic_images(8, 256, seed=2)
    paths = []
    for i, im in enumerate(batch):
        paths.append(os.path.join(RUN_DIR, f"request_{i}.png"))
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
    say(f"serving: /healthz {health}; /predict x3 and /predict_batch x{len(batch)} "
        f"answered; kernel launches during the requests: {launches}")
    # one K1 launch per served forward, and nothing of the training kernels
    check_launches("serving", launches, {"fused_head": len(single) + 1,
                                         "head_backward": 0, "fused_head_nopf": 0})
    answers = [body for _, body in served] + served_b

    # the same images through the backbone in the batches the server formed
    # (each single image padded to 8), then the head twice on the same
    # features: the kernel, and the plain version
    from pipnet_tpu_torch.data.augment import EvalTransform
    xs = np.stack([EvalTransform(S)(Image.fromarray(im)) for im in single + batch])
    head, tree = pred.model.head, pred.tree
    with torch.inference_mode():
        chunks = []
        for i in range(len(single)):
            x = np.zeros((8,) + xs.shape[1:], xs.dtype)
            x[0] = xs[i]
            chunks.append(pred.model.features(torch.from_numpy(x).cuda())[:1])
        chunks.append(pred.model.features(torch.from_numpy(xs[len(single):]).cuda()))
        feats = torch.cat(chunks)
        k = head.add_on_kernel.to(feats.dtype)
        pf_k, pooled_k = fused_head(feats, k, tree, tau=head.cfg.softmax_tau)
        pf_p, pooled_p = fused_head_reference(feats, k, tree, tau=head.cfg.softmax_tau)
        # a pooled value within a bf16 ulp of the 0.1 inference cut may round
        # to either side of it; take the plain side there so the logits
        # compare the kernel's values, not the cut
        thr = head.cfg.inference_threshold
        near = (pooled_p - thr).abs() < 2.0 ** -9
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
    logit_tol = 2.0 ** -6 * lp.abs() + 2.0 ** -7   # two bf16 ulps
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
    say(f"serving parity: {json.dumps(rec)} [{card}]")
    if pooled_err > TOL[torch.bfloat16]["pooled"] or bool(((lk - lp).abs() > logit_tol).any()):
        fail(f"served head disagrees with the plain head: {rec}")
    if rec["confident_images"] == 0 or not bool(agree_kernel.all()) or \
            not bool(agree_served.all()):
        fail(f"served top-1 disagrees with the plain head: {rec}")

    bench = pred.bench(iters=30)
    say(f"serving bench: {json.dumps(bench)} [{card}]")
    breakdown(pred, card)
    return launches


def breakdown(pred, card: str) -> None:
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
    say(f"serving breakdown B={pred.batch_size}: {json.dumps(rec)} [{card}]")


def counts() -> dict:
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    return {"fused_head": fused_head.launches, "head_backward": head_backward.launches,
            "fused_head_nopf": fused_head_nopf.launches}


def zero_counts() -> None:
    from pipnet_tpu_torch.ops.fused_head import fused_head, head_backward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    fused_head.launches = head_backward.launches = fused_head_nopf.launches = 0


def flagship_run_config(align_eps_unset: bool):
    """The flagship run config; with ``align_eps_unset`` the reference
    align_pf epsilon, as bench.py's training config leaves it."""
    from pipnet_tpu_torch.run_io import load_run_config
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    if align_eps_unset:
        loss = dataclasses.replace(cfg.train.loss, align_eps=None)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, loss=loss))
    return cfg


def flagship_model(cfg, seed: int = 0):
    """The flagship PIPNet on the card at full width and depth, with seeded
    random weights in the JAX layout converted to the port's."""
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.tree import Node
    with open(os.path.join(FLAGSHIP_META, "tree.json")) as f:
        root = Node.from_dict(json.load(f))
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        classes = json.load(f)
    model, tree = build_pipnet(root, cfg.model, weighted=cfg.train.loss.weighted_ce,
                               class_names=classes, device="cuda")
    model.load_state_dict(params_from_jax(random_jax_params(cfg.model, tree, seed=seed)))
    return model, tree


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


def training_phase(card: str, fuse: bool):
    """One training path at full width: warm-up steps, then timed steps with
    the kernels' launch counts, then the profiler and a breakdown."""
    from pipnet_tpu_torch.train import init_train_state
    name = "B (K2, fuse_align_pf)" if fuse else "A (K1, pf materialised)"
    t0 = time.perf_counter()
    cfg = flagship_run_config(align_eps_unset=fuse)
    model, tree = flagship_model(cfg)
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


def cross_checks(card: str):
    """From the same parameters and batch, with align_eps unset: path A's
    and path B's first-step losses; then the head gradients through the
    kernels against autograd through the plain composition, on the step's
    own features, for both paths, in bf16 and in f32 (TF32 off)."""
    from pipnet_tpu_torch.train import init_train_state
    cfg = flagship_run_config(align_eps_unset=True)
    model, tree = flagship_model(cfg)
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
            key = f"{'nopf' if fuse else 'fused'}_{str(dtype).replace('torch.', '')}"
            rec["grads"][key] = head_grad_check(feats.to(dtype), kernel.to(dtype), tree, fuse)
    say(f"cross-checks: {json.dumps(rec)} [{card}]")
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


def check_launches(path: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{path}: kernel launches {got}, expected exactly {want}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    from pipnet_tpu_torch.ops.build import BUILD_DIR, build, library_path

    name = torch.cuda.get_device_name(0)
    card = card_line()
    say(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    say(card)                 # name, power limit: as nvidia-smi prints them

    seconds = build(KERNEL_SOURCES)
    say(f"build: {json.dumps(seconds)} s into {BUILD_DIR}")
    for src in KERNEL_SOURCES:
        log = library_path(src).with_name(library_path(src).name + ".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "rror")):
                say(f"ptxas {src}: {line.strip()}")

    records, backward, nopf = kernel_phase(card)

    serving = serving_phase(card)
    train_a = training_phase(card, fuse=False)
    check_launches("training path A", train_a["launches"], {
        "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS, "fused_head_nopf": 0})
    cross_checks(card)
    train_b = training_phase(card, fuse=True)
    check_launches("training path B", train_b["launches"], {
        "fused_head": TIMED_STEPS, "head_backward": TIMED_STEPS,
        "fused_head_nopf": TIMED_STEPS})
    total = {k: serving[k] + train_a["launches"][k] + train_b["launches"][k] for k in serving}
    say(f"launches by path: serving {serving}, training A {train_a['launches']}, "
        f"training B {train_b['launches']}")

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
    ]
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
