"""Inference / serving entry point of the PyTorch port.

Counterpart of the JAX package's ``serve.py``: a fixed batch shape (short
requests are padded, the padding rows dropped), the inference
sparsification and the joint tree decode in the same forward, host-side
decode + PIL resize identical to the eval transform, and ``bench()`` for
single-image latency percentiles and batch throughput.  The forward runs on
the card unless the caller passes ``device="cpu"``.

CLI::

    python -m pipnet_tpu_torch.serve --run_dir runs/x --images a.png b.png
    python -m pipnet_tpu_torch.serve --run_dir runs/x --bench
    python -m pipnet_tpu_torch.serve --run_dir runs/x --http 8000
    python -m pipnet_tpu_torch.serve --run_dir runs/x --images a.png \
        --apply_overspecificity_mask --mask_seed 0
    python -m pipnet_tpu_torch.serve --run_dir runs/x --images a.png --explain out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.augment import EvalTransform
from .device import resolve_device
from .models.pipnet import joint_leaf_log_distribution, masked_decode_degenerates, presence_keep
from .run_io import load_run
from .runtime.profiling import span


class Predictor:
    """Load a trained run and serve batched classifications.

    Results per image: ``class``/``prob`` (top-1 over the joint leaf
    distribution, ref util/node.py:300-395), ``topk`` list, ``abstained``
    (no positive classifier evidence anywhere, ref pipnet/test.py:66-70), and
    the number of active prototypes (ref pipnet/test.py:90-96).

    ``apply_overspecificity_mask`` serves the mask-pruned model: one
    hard-Gumbel presence sample drawn when the predictor is built (CPU
    generator seeded ``mask_seed``, ``models/pipnet.py::presence_keep``)
    and kept for its lifetime, the pruned model being a deterministic
    artifact (ref calc_acc_LOU_and_mask_pruned_model.ipynb loads ONE mask);
    the degenerate-node verdict of the decode is computed from it once.
    """

    def __init__(self, run_dir: str, checkpoint: str = "net_trained_last",
                 batch_size: int = 8, classes: Optional[List[str]] = None,
                 path_prob_softmax_tau: float = 1.0,
                 apply_overspecificity_mask: bool = False, mask_seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.bundle = load_run(run_dir, checkpoint=checkpoint, classes=classes,
                               device=self.device)
        self.model, self.tree = self.bundle.model, self.bundle.tree
        self.classes = self.bundle.classes
        self.batch_size = batch_size
        self.image_size = self.bundle.cfg.model.image_size
        self.path_prob_softmax_tau = path_prob_softmax_tau
        self._transform = EvalTransform(self.image_size)
        self.keep = self.degenerate = None
        if apply_overspecificity_mask:
            self.keep = presence_keep(self.model.head.proto_presence, mask_seed)
            with torch.no_grad():
                self.degenerate = masked_decode_degenerates(self.model, self.tree, self.keep)

    @torch.inference_mode()
    def forward(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """xs (B, S, S, 3) normalized images on the device -> (logits,
        pooled, log joint leaf distribution)."""
        with span("serve"):
            out = self.model(xs, inference=True,
                             apply_overspecificity_mask=self.keep is not None, keep=self.keep)
            with span("decode"):
                logp = joint_leaf_log_distribution(
                    out["logits"], self.tree, softmax_tau=self.path_prob_softmax_tau,
                    degenerate_nodes=self.degenerate)
        return out["logits"], out["pooled"], logp

    # -- input handling ------------------------------------------------------
    def _prep(self, images: Sequence) -> np.ndarray:
        """PIL images / uint8 arrays / file paths -> normalized (N,S,S,3)."""
        from PIL import Image
        rows = []
        for im in images:
            if isinstance(im, (str, os.PathLike)):
                im = Image.open(im).convert("RGB")
            elif isinstance(im, np.ndarray):
                im = Image.fromarray(im.astype(np.uint8)).convert("RGB")
            rows.append(self._transform(im))
        return np.stack(rows)

    # -- serving -------------------------------------------------------------
    def predict(self, images: Sequence, topk: int = 3) -> List[Dict]:
        xs = self._prep(images)
        results: List[Dict] = []
        B = self.batch_size
        for start in range(0, len(xs), B):
            chunk = xs[start:start + B]
            n = len(chunk)
            if n < B:                       # pad to the fixed batch shape
                chunk = np.concatenate(
                    [chunk, np.zeros((B - n,) + chunk.shape[1:], chunk.dtype)])
            logits, pooled, logp = self.forward(
                torch.from_numpy(chunk).to(self.device))
            logits = logits[:n].float().cpu().numpy()
            pooled = pooled[:n].float().cpu().numpy()
            logp = logp[:n].float().cpu().numpy()
            probs = np.exp(logp)
            order = np.argsort(-logp, axis=-1)
            for i in range(n):
                top = [{"class": self.classes[j], "prob": float(probs[i, j])}
                       for j in order[i, :topk]]
                results.append({
                    "class": top[0]["class"],
                    "prob": top[0]["prob"],
                    "topk": top,
                    "abstained": bool(logits[i].max() <= 0.0),
                    "active_prototypes": int((pooled[i] > 0).sum()),
                })
        return results

    def explain(self, image, out_dir: str, topk: int = 3) -> Dict:
        """Per-image evidence folder (util/visualize_prediction.py;
        ``interp/prediction.py::explain_image``) from the unmasked model."""
        from .interp.prediction import explain_image
        x = self._prep([image])[0]
        return explain_image(self.model, self.tree, x, out_dir,
                             image_size=self.image_size, top_classes=topk)

    # -- serving benchmark ---------------------------------------------------
    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def bench(self, iters: int = 50) -> Dict:
        """Single-image latency percentiles and batch throughput of the
        forward (model + decode) on inputs already on the device, after a
        warm-up; each timed call ends in ``torch.cuda.synchronize()``."""
        r = np.random.default_rng(0)
        S = self.image_size
        one = torch.from_numpy(r.standard_normal((1, S, S, 3)).astype(np.float32)).to(self.device)
        batch = torch.from_numpy(r.standard_normal(
            (self.batch_size, S, S, 3)).astype(np.float32)).to(self.device)
        for _ in range(3):
            self.forward(one)
        self._fence()
        lat = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.forward(one)
            self._fence()
            lat.append(time.perf_counter() - t0)
        for _ in range(3):
            self.forward(batch)
        self._fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.forward(batch)
        self._fence()
        dt = time.perf_counter() - t0
        lat_ms = np.array(lat) * 1e3
        return {
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p95": float(np.percentile(lat_ms, 95)),
            "batch_size": self.batch_size,
            "throughput_img_per_sec": iters * self.batch_size / dt,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
        }


def serve_http(pred: "Predictor", port: int = 8000, host: str = "127.0.0.1"):
    """Build (not start) a threading HTTP server around a Predictor.

    Routes:
      GET  /healthz            -> {"ok": true, "classes": N, ...}
      POST /predict?topk=K     -> body = raw image bytes (any PIL format);
                                  one result object
      POST /predict_batch      -> body = JSON {"paths": [...], "topk": K};
                                  list of result objects (server-local paths)

    Returns the ``ThreadingHTTPServer``; call ``serve_forever()`` (the CLI
    does) or drive it from a thread.  Device work is serialized with a lock:
    one card, one fixed-shape forward at a time."""
    import io
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from PIL import Image

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # quiet; the caller owns logging
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"ok": True,
                                 "classes": len(pred.classes),
                                 "image_size": pred.image_size,
                                 "batch_size": pred.batch_size})
            else:
                self._json(404, {"error": "unknown route"})

        def do_POST(self):
            route = urlparse(self.path).path
            try:
                # query/header parsing inside the try so a malformed topk or
                # Content-Length is a 400, not a dropped connection
                q = parse_qs(urlparse(self.path).query)
                topk = int(q.get("topk", ["3"])[0])
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if route == "/predict":
                    img = Image.open(io.BytesIO(body)).convert("RGB")
                    # hold the device lock for the compute only — writing the
                    # response to a slow client must not serialize the server
                    with lock:
                        result = pred.predict([img], topk=topk)[0]
                    self._json(200, result)
                elif route == "/predict_batch":
                    req = json.loads(body)
                    with lock:
                        results = pred.predict(req["paths"],
                                               topk=req.get("topk", topk))
                    self._json(200, results)
                else:
                    self._json(404, {"error": "unknown route"})
            except Exception as e:      # surfaces bad images/paths as 400s
                self._json(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def run(argv=None) -> int:
    p = argparse.ArgumentParser("Serve a trained run with the PyTorch port")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default="net_trained_last")
    p.add_argument("--images", nargs="*", default=[])
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--path_prob_softmax_tau", type=float, default=1.0)
    p.add_argument("--apply_overspecificity_mask", action="store_true",
                   help="serve the mask-pruned model (hard-Gumbel presence "
                        "mask + degenerate-node decode fallback)")
    p.add_argument("--mask_seed", type=int, default=0)
    p.add_argument("--explain", default=None, metavar="OUT_DIR",
                   help="also write a per-image evidence folder "
                        "(util/visualize_prediction.py) under OUT_DIR")
    p.add_argument("--bench", action="store_true",
                   help="serving latency/throughput JSON line")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead of the one-shot CLI "
                        "(GET /healthz, POST /predict, POST /predict_batch)")
    p.add_argument("--http_host", default="127.0.0.1")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    pred = Predictor(args.run_dir, checkpoint=args.checkpoint,
                     batch_size=args.batch_size,
                     path_prob_softmax_tau=args.path_prob_softmax_tau,
                     apply_overspecificity_mask=args.apply_overspecificity_mask,
                     mask_seed=args.mask_seed, device=args.device)
    if args.bench:
        print(json.dumps({"metric": "serving", **pred.bench()}))
        return 0
    if args.http is not None:
        srv = serve_http(pred, port=args.http, host=args.http_host)
        print(f"serving on http://{args.http_host}:{srv.server_address[1]} "
              f"(GET /healthz, POST /predict, POST /predict_batch)",
              flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return 0
    if not args.images:
        p.error("pass --images, --bench, or --http")
    results = pred.predict(args.images, topk=args.topk)
    for idx, (path, res) in enumerate(zip(args.images, results)):
        if args.explain:
            # index prefix: distinct images often share a basename
            # (class_a/img_000.png vs class_b/img_000.png)
            out_dir = os.path.join(
                args.explain, f"{idx:03d}_{os.path.splitext(os.path.basename(path))[0]}")
            pred.explain(path, out_dir, topk=args.topk)
            res["explanation_dir"] = out_dir
        print(json.dumps({"image": path, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
