#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pipnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. device: the card's name and power limit;
2. build: every hand-written kernel, from the sources in this checkout,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it (the flagship 190-class tree, B=8,
   26x26x768, in f32 with TF32 off and in bf16) and on a small tree with
   several bucket widths and a padded tail; with the kernel's time, its
   plain version's, one PyTorch library call's, and the card's bound;
4. serving: a run directory holding the flagship configuration and tree
   (``artifacts/lou_190_s2/metadata``) and seeded random weights, served by
   ``Predictor`` + ``serve_http`` at full width (ConvNeXt-tiny-26, 224^2,
   bf16); GET /healthz, three POST /predict and one POST /predict_batch;
   the kernel launch counts of those requests; the served answers held
   against the plain head on the same features; ``Predictor.bench()``.

The last two lines of standard output are the ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero before
printing either.
"""

from __future__ import annotations

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
KERNEL_SOURCES = ["fused_head"]

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
    r = np.random.default_rng(seed)
    P = tree.num_protos_padded
    limit = np.sqrt(6.0 / (D + P))           # the add-on's xavier-uniform scale
    f = torch.from_numpy(r.standard_normal((B, H, W, D)).astype(np.float32))
    k = torch.from_numpy(r.uniform(-limit, limit, (D, P)).astype(np.float32))
    f, k = f.to("cuda", dtype), k.to("cuda", dtype)
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
        nbytes = (f.numel() + k.numel() + pf.numel()) * es + pooled.numel() * 4
        ops = 2.0 * B * H * W * D * covered
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
        rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
        rec["bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        rec["bytes"], rec["flops"] = nbytes, ops
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
            ("multi_bucket_f32", multi, (3, 9, 11, 72), torch.float32, False),
            ("multi_bucket_bf16", multi, (3, 9, 11, 72), torch.bfloat16, False)):
        rec = check_fused_head(tree, *shape, dtype, seed=len(records), timed=timed)
        records[name] = rec
        say(f"kernel fused_head {name}: {json.dumps(rec)} [{card}]")
    return records


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
        fused_head.launches = 0
        status, health = http(base + "/healthz")
        served = [http(base + "/predict?topk=3", png_bytes(im)) for im in single]
        status_b, served_b = http(base + "/predict_batch",
                                  json.dumps({"paths": paths, "topk": 3}).encode())
        launches = fused_head.launches
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
        f"answered; fused_head launches during the requests: {launches}")
    if launches != len(single) + 1:      # one launch per served forward
        fail(f"the served requests launched the fused head kernel {launches} "
             f"times, not {len(single) + 1}")
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
    return launches, bench


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

    records = kernel_phase(card)
    launches, bench = serving_phase(card)

    main_rec = records["flagship_bf16"]
    kernels = [{
        "name": "fused_head",
        "route": "cuda",
        "source": "pipnet_tpu_torch/ops/csrc/fused_head.cu",
        "replaces": "pipnet_tpu/ops/pallas_head.py:73",
        "launches": launches,
        "max_abs_err": max(max(r["pf_max_abs_err"], r["pooled_max_abs_err"])
                           for r in records.values()),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }]
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
