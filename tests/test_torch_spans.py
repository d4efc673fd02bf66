"""The program's spans (``runtime/profiling.py::span``) on the CPU: a shared
no-op without a profiler; under one, a training step of the flagship's
run config (narrow ConvNeXt, the multi-bucket tree, 48^2 views made from
a uint8 batch of the device data cache, f32) and a served batch record
each span of ``SPANS`` where the program does that work, nested as listed
there; the backward's operations link to forward operations inside
``backbone``, ``head`` and ``losses``, which is how a trace reader puts a
backward kernel down to its layer.  ``augment.wait`` is the card's alone
(the CPU reads the op counts without a wait)."""

import ast
import collections
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from torch_port_util import (FLAGSHIP_META, MULTI_NEWICK, REPO, SMALL_DEPTHS, SMALL_DIMS,
                             SMALL_THRESHOLDS)

S, B = 48, 4
IN_STEP = ("augment", "backbone", "head", "losses", "backward", "clip", "adamw", "metrics")


@pytest.fixture(scope="module")
def small_backbone():
    """The port's ``convnext_tiny_26`` narrowed (no JAX model runs here)."""
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tp.BACKBONES, "convnext_tiny_26", (functools.partial(
            ConvNeXtTiny, stride_threshold=SMALL_THRESHOLDS["convnext_tiny_26"],
            depths=SMALL_DEPTHS, dims=SMALL_DIMS), SMALL_DIMS[-1]))
        yield


def _root():
    import pipnet_tpu_torch.tree as tt
    root = tt.construct_phylo_tree(phylo=tt.Phylogeny(newick=MULTI_NEWICK))
    root.assign_all_descendents()
    return root


def _cfg():
    from pipnet_tpu_torch.run_io import load_run_config
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=S, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=B))


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _spans(events):
    """(name, start ns, end ns, thread) of every span, outer before inner."""
    from pipnet_tpu_torch.runtime.profiling import SPANS
    found = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in events if e.name() in SPANS]
    return sorted(found, key=lambda s: (s[1], -s[2]))


def _innermost(spans, t, thread):
    inside = [s for s in spans if s[3] == thread and s[1] <= t < s[2]]
    return inside[-1] if inside else None


def _parents(spans):
    """(span, the span that encloses it on its thread or None), each span."""
    out = []
    for i, (name, start, end, thread) in enumerate(spans):
        outer = [s for s in spans[:i] if s[3] == thread and s[1] <= start and end <= s[2]]
        out.append((name, outer[-1][0] if outer else None))
    return out


@pytest.fixture(scope="module")
def traced_step(small_backbone):
    """One uint8 step as ``Trainer.run_epoch`` issues it (the rows fetched
    from the cache, the labels sent), under a CPU profiler: its events."""
    from pipnet_tpu_torch.data.device_cache import DeviceDataCache
    from pipnet_tpu_torch.device import host_to_device
    from pipnet_tpu_torch.models import build_pipnet
    from pipnet_tpu_torch.train import (Scalars, StepStatics, init_train_state,
                                        make_train_step, phase_for_epoch)
    cfg = _cfg()
    model, tree = build_pipnet(_root(), cfg.model, weighted=True, device="cpu")
    statics = StepStatics(phase=phase_for_epoch(20, cfg.train, pretrain=False),
                          mask_prune_active=True, eta_min_net=1e-8)
    step = make_train_step(model, tree, cfg, statics)
    state = init_train_state(model, seed=3)
    r = np.random.default_rng(5)
    cache = DeviceDataCache(r.integers(0, 256, (8, S + 8, S + 8, 3), dtype=np.uint8),
                            "u8base", "cpu")
    rows, ys = np.array([0, 2, 5, 7]), r.integers(0, tree.num_classes, B)
    scalars = Scalars(net_t=3.0, net_T=100.0, epoch_frac=19.5, align_pf_weight=5.0,
                      tanh_weight=2.0)
    with _cpu_profile() as prof:
        _, metrics = step(state, cache.fetch(rows), None, host_to_device(ys, "cpu"), scalars)
    assert torch.isfinite(metrics["loss"])
    return _events(prof)


def test_span_is_a_shared_no_op_without_a_profiler():
    from pipnet_tpu_torch.runtime.profiling import ROOTS, SPANS, span
    assert not torch.autograd.profiler._is_profiler_enabled
    off = span("step")
    assert off is span("backbone")
    with off:
        with off:
            pass
    with _cpu_profile():
        assert span("step") is not off
    assert span("step") is off
    assert len(set(SPANS)) == len(SPANS) and set(ROOTS) <= set(SPANS)


def test_the_program_names_only_spans_of_the_list():
    """Every ``span("...")`` in the port's sources names one of ``SPANS``,
    and every name of ``SPANS`` is used."""
    from pipnet_tpu_torch.runtime.profiling import SPANS
    used = set()
    for d, _, files in os.walk(os.path.join(REPO, "pipnet_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                for node in ast.walk(ast.parse(open(os.path.join(d, f)).read())):
                    if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                            and node.args and isinstance(node.args[0], ast.Constant)):
                        used.add(node.args[0].value)
    assert used == set(SPANS)


def test_a_training_step_records_each_span_once_nested_as_listed(traced_step):
    """... and ``to_device`` wherever a small host array goes to the
    device: the cache's row indices, the labels, the augmentation's
    tables."""
    parents = collections.Counter(_parents(_spans(traced_step)))
    copies = {p: n for (s, p), n in parents.items() if s == "to_device"}
    assert copies.pop("fetch") == 1 and copies.pop(None) == 1
    assert set(copies) == {"augment"}
    assert {sp: n for sp, n in parents.items() if sp[0] != "to_device"} == {
        ("fetch", None): 1, ("step", None): 1, **{(n, "step"): 1 for n in IN_STEP}}


def test_the_backward_links_to_forward_ops_in_backbone_head_and_losses(traced_step):
    """Each backward node (``autograd::engine::evaluate_function: ...``)
    carries its forward operation's ``sequence_nr`` and thread; that
    operation lies inside the span whose layer the gradient belongs to."""
    spans = _spans(traced_step)
    backward = next(s for s in spans if s[0] == "backward")
    forward = {}
    for e in sorted(traced_step, key=lambda e: e.start_ns()):
        # the last operation to take a sequence number made the node
        if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            forward[(e.start_thread_id(), e.sequence_nr())] = e
    layers = collections.Counter()
    for e in traced_step:
        if e.name().startswith("autograd::engine::evaluate_function") and e.fwd_thread_id():
            assert backward[1] <= e.start_ns() < backward[2]
            op = forward.get((e.fwd_thread_id(), e.sequence_nr()))
            if op is not None:
                inner = _innermost(spans, op.start_ns(), op.start_thread_id())
                layers[inner[0] if inner else None] += 1
    assert {"backbone", "head", "losses"} <= set(layers), layers
    assert not set(layers) & {"backward", "clip", "adamw", "metrics", None}, layers


def test_a_served_batch_records_serve_around_backbone_head_and_decode(tmp_path, small_backbone):
    from pipnet_tpu_torch.models import build_pipnet
    from pipnet_tpu_torch.serve import Predictor
    cfg = _cfg()
    root = _root()
    model, tree = build_pipnet(root, cfg.model, weighted=True, device="cpu")
    for sub in ("metadata", "checkpoints"):
        (tmp_path / sub).mkdir()
    meta = {"config.json": dataclasses.asdict(cfg), "tree.json": root.to_dict(),
            "classes.json": list(tree.class_names)}
    for name, obj in meta.items():
        (tmp_path / "metadata" / name).write_text(json.dumps(obj))
    torch.save(model.state_dict(), tmp_path / "checkpoints" / "net_trained_last.pt")
    pred = Predictor(str(tmp_path), batch_size=2, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal((2, S, S, 3), np.float32))
    with _cpu_profile() as prof:
        pred.forward(xs)
    assert sorted(_parents(_spans(_events(prof)))) == [
        ("backbone", "serve"), ("decode", "serve"), ("head", "serve"), ("serve", None)]
