"""The port's serving path on the CPU: ``Predictor`` on a run directory
against the JAX forward + decode on the same parameters and images, the
HTTP routes, the CLI, and the CUDA-by-default device rule."""

import dataclasses
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import (SMALL_DEPTHS, SMALL_DIMS, roots_from_newick,
                             small_backbones, to_jax)

IMAGE_SIZE = 48


@pytest.fixture(scope="module")
def backbones():
    with small_backbones():
        yield


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, tiny_newick, backbones):
    """A run directory as the port reads it: metadata/{config,classes,
    tree}.json and checkpoints/net_trained_last.pt from seeded weights."""
    from pipnet_tpu_torch.config import HeadConfig, ModelConfig, RunConfig
    from pipnet_tpu_torch.models import (assign_prototype_budgets, params_from_jax,
                                         random_jax_params)
    from pipnet_tpu_torch.tree import compile_tree
    root_dir = tmp_path_factory.mktemp("torch_serve")
    cfg = RunConfig(model=ModelConfig(
        backbone="convnext_tiny_26", image_size=IMAGE_SIZE, num_protos_per_child=10,
        head=HeadConfig(protopool=False), use_pallas_head=True, fast_gelu=True))
    _, rt = roots_from_newick(tiny_newick)
    classes = sorted(leaf.name for leaf in rt.leaves())
    (root_dir / "metadata").mkdir()
    (root_dir / "checkpoints").mkdir()
    (root_dir / "metadata" / "config.json").write_text(
        json.dumps(dataclasses.asdict(cfg)))
    (root_dir / "metadata" / "classes.json").write_text(json.dumps(classes))
    (root_dir / "metadata" / "tree.json").write_text(json.dumps(rt.to_dict()))
    assign_prototype_budgets(rt, cfg.model)
    tt = compile_tree(rt, class_names=classes, protopool=False)
    params = random_jax_params(cfg.model, tt, seed=11, depths=SMALL_DEPTHS,
                               dims=SMALL_DIMS)
    torch.save(params_from_jax(params),
               root_dir / "checkpoints" / "net_trained_last.pt")
    return str(root_dir), params, classes


@pytest.fixture(scope="module")
def images():
    r = np.random.default_rng(12)
    return [r.integers(0, 256, (40 + 4 * i, 56, 3), dtype=np.uint8) for i in range(5)]


@pytest.fixture(scope="module")
def predictor(run_dir):
    from pipnet_tpu_torch.serve import Predictor
    return Predictor(run_dir[0], batch_size=4, device="cpu")


def test_predictor_matches_jax_forward_and_decode(run_dir, images, predictor, tiny_newick):
    """Same top-k classes and probabilities as JAX ``model.apply`` + decode
    (5 images with batch 4 exercise the padded tail chunk)."""
    import jax.numpy as jnp
    from pipnet_tpu.config import HeadConfig, ModelConfig
    from pipnet_tpu.data.augment import EvalTransform
    from pipnet_tpu.models import build_pipnet, joint_leaf_log_distribution
    d, params, classes = run_dir
    rj, _ = roots_from_newick(tiny_newick)
    model, tree = build_pipnet(rj, ModelConfig(
        backbone="convnext_tiny_26", image_size=IMAGE_SIZE, num_protos_per_child=10,
        head=HeadConfig(protopool=False), use_pallas_head=True, fast_gelu=True),
        class_names=classes)
    xs = np.stack([EvalTransform(IMAGE_SIZE)(Image.fromarray(im)) for im in images])
    out = model.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)
    logp = np.asarray(joint_leaf_log_distribution(out["logits"], tree))
    got = predictor.predict(images, topk=3)
    assert len(got) == len(images)
    for i, res in enumerate(got):
        order = np.argsort(-logp[i])[:3]
        assert [t["class"] for t in res["topk"]] == [classes[j] for j in order]
        np.testing.assert_allclose([t["prob"] for t in res["topk"]],
                                   np.exp(logp[i, order]), atol=1e-5, rtol=0)
        assert res["active_prototypes"] == int((np.asarray(out["pooled"])[i] > 0).sum())
        assert res["abstained"] == bool(np.asarray(out["logits"])[i].max() <= 0)
    # the seeded weights give a decision, not a tie: the top-1 leads
    assert all(r["topk"][0]["prob"] > r["topk"][1]["prob"] + 1e-4 for r in got)


def test_bench_reports_on_the_cpu(predictor):
    out = predictor.bench(iters=2)
    assert out["device"] == "cpu" and out["batch_size"] == 4
    assert out["latency_ms_p50"] > 0 and out["throughput_img_per_sec"] > 0


@pytest.fixture
def server(predictor):
    from pipnet_tpu_torch.serve import serve_http
    srv = serve_http(predictor, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def _call(url, data=None):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_http_routes(server, predictor, images, tmp_path):
    status, body = _call(server + "/healthz")
    assert status == 200 and body["ok"] and body["classes"] == len(predictor.classes)
    status, body = _call(server + "/predict?topk=2", _png(images[0]))
    assert status == 200 and len(body["topk"]) == 2
    assert body == predictor.predict([Image.open(io.BytesIO(_png(images[0])))], topk=2)[0]
    paths = []
    for i, im in enumerate(images[:2]):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(im).save(paths[-1])
    status, body = _call(server + "/predict_batch",
                         json.dumps({"paths": paths, "topk": 1}).encode())
    assert status == 200 and len(body) == 2 and len(body[0]["topk"]) == 1
    assert _call(server + "/nope")[0] == 404
    assert _call(server + "/nope", b"x")[0] == 404
    status, body = _call(server + "/predict", b"not an image")
    assert status == 400 and "error" in body


def test_cli_images_and_unported_flags(run_dir, images, tmp_path, capsys):
    from pipnet_tpu_torch.serve import run
    path = str(tmp_path / "a.png")
    Image.fromarray(images[1]).save(path)
    assert run(["--run_dir", run_dir[0], "--images", path, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["image"] == path and line["class"] in run_dir[2]
    for flag in (["--explain", str(tmp_path / "ev")], ["--apply_overspecificity_mask"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            run(["--run_dir", run_dir[0], "--images", path, "--device", "cpu", *flag])


@pytest.mark.parametrize("missing", ["tree.json", "classes.json"])
def test_load_run_needs_its_metadata(run_dir, tmp_path, missing):
    import shutil
    from pipnet_tpu_torch.run_io import load_run
    d = tmp_path / "run"
    shutil.copytree(run_dir[0], d)
    (d / "metadata" / missing).unlink()
    with pytest.raises(RuntimeError, match=missing):
        load_run(str(d), device="cpu")


def test_entry_points_default_to_cuda(run_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from pipnet_tpu_torch.run_io import load_run
    from pipnet_tpu_torch.serve import Predictor
    for make in (lambda: Predictor(run_dir[0]), lambda: load_run(run_dir[0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
