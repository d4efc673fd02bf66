"""Shared pieces of the port's mesh tests: the runs (model, configuration,
weights and two steps' global batches) and the launcher that runs them on
W gloo ranks (``torch_mesh_worker.py``, one process a rank, each with a
time limit) beside the one-process step."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from torch_mesh_worker import RUNNERS, build

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
B, S = 8, 48
# the tiny tree of tests/test_model_parallel.py, 4 prototypes a child
TINY_NEWICK = (
    "((((cub_001_Sooty_Albatross:1.0,cub_002_Laysan_Albatross:1.0):1.0,"
    "cub_003_Crested_Auklet:2.0):2.0,"
    "((cub_004_Red_winged_Blackbird:1.5,cub_005_Rusty_Blackbird:1.5):1.0,"
    "cub_006_Bobolink:2.5):1.5):1.0,"
    "(cub_007_Indigo_Bunting:2.0,cub_008_Painted_Bunting:2.0):3.0);"
)
# (epoch, pretrain, mask-prune active) and the step's scalars
TRAIN = ((20, False, True), dict(net_t=3.0, net_T=100.0, epoch_frac=0.5,
                                 align_pf_weight=5.0, tanh_weight=2.0))
PRETRAIN = ((3, True, False), dict(net_t=3.0, net_T=100.0, epoch_frac=0.5,
                                   align_pf_weight=0.25, tanh_weight=5.0))
RANK_TIMEOUT = 240      # seconds a run of ranks may take before it is killed


def fake_mesh(n_data, n_model=1, rank=0):
    """A mesh value of ``n_data * n_model`` ranks without a process group:
    layouts and row splits need none."""
    import torch
    from pipnet_tpu_torch.runtime.mesh import Mesh
    return Mesh(n_data * n_model, rank, torch.device("cpu"), n_data, n_model, None, None)


def port_config(**loss):
    """The flagship run's port configuration (``artifacts/lou_190_s2``) in
    f32 at 48^2, batch 8, its loss set changed by ``loss``."""
    from pipnet_tpu_torch.run_io import load_run_config
    from torch_port_util import FLAGSHIP_META
    cfg = load_run_config(os.path.dirname(FLAGSHIP_META))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=S, compute_dtype="float32",
                                       use_pallas_head=False),
        train=dataclasses.replace(cfg.train, batch_size=B,
                                  loss=dataclasses.replace(cfg.train.loss, **loss)))


def seeded_weights(run, seed=11):
    """Seeded weights for the run's model (``random_jax_variables``)."""
    from pipnet_tpu_torch.models import random_jax_variables, state_dict_from_jax
    model, tree = build(dict(run, state_dict=None))
    return state_dict_from_jax(random_jax_variables(run["cfg"].model, tree, seed=seed,
                                                    backbone=model.backbone))


def batch(seed, *, ood=0, uint8=False):
    """One global batch of B rows (the last ``ood`` of them OOD, label -1):
    two f32 views, or one uint8 view of 56^2 bases (``uint8``)."""
    r = np.random.default_rng(seed)
    ys = r.integers(0, 8, B)
    ys[B - ood:] = -1
    if uint8:
        return r.integers(0, 256, (B, S + 8, S + 8, 3), dtype=np.uint8), None, ys
    xs = r.standard_normal((2, B, S, S, 3)).astype(np.float32)
    return xs[0], xs[1], ys


def make_run(name, *, backbone=("convnext", 0.3), phase=TRAIN, ood=0, uint8=False,
             **kw):
    """A run of two steps on two batches (seeds 1 and 2)."""
    loss = kw.pop("loss", {})
    cfg = kw.pop("cfg", None) or port_config(**loss)
    run = dict(name=name, newick=TINY_NEWICK, per_child=4, cfg=cfg, backbone=backbone,
               **kw)
    steps = []
    for seed in (1, 2):
        xs1, xs2, ys = batch(seed, ood=ood, uint8=uint8)
        steps.append(dict(phase=phase[0], scalars=phase[1], xs1=xs1, xs2=xs2, ys=ys,
                          has_ood=ood > 0))
    run["steps"] = steps
    run["state_dict"] = seeded_weights(run)
    return run


def _start_ranks(job, world, timeout, mode=()):
    """``world`` worker processes on ``job``; returns their outputs, after
    each exited 0.  The ranks are killed when they outlast ``timeout``
    seconds."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [HERE, os.path.dirname(HERE)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, WORKER, *mode, job, str(r), str(world)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}"
    return logs


def run_ranks(runs, world, tmp_path, timeout=RANK_TIMEOUT, n_model=1):
    """Every run on ``world`` gloo ranks (one process each), a mesh of
    ``world / n_model`` data by ``n_model`` model ranks; returns each
    rank's results.  A rank that fails fails the test with its output."""
    job = str(tmp_path / f"mesh_job_{world}_{n_model}")
    with open(job, "wb") as f:
        pickle.dump({"runs": runs, "timeout": timeout, "n_model": n_model}, f)
    _start_ranks(job, world, timeout)
    out = []
    for r in range(world):
        with open(f"{job}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def one_process(runs):
    return {run["name"]: RUNNERS[run.get("kind", "steps")](run, None) for run in runs}


def check_metrics(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def check_grads(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0, atol=1e-4, err_msg=n)


def check_state(got, want, lr_max=1e-3):
    """Weights and whole Adam moments after the steps.  Where a step's
    gradient is ~0 (|g| <= 1e-6) Adam's step is lr * sign(g) and the sign of
    a rounding-level gradient is arbitrary: there the bar is 2 lr a step;
    elsewhere 1e-6.  Moments within 1e-5 (first) and 1e-7 (second); counts
    equal; BatchNorm statistics within 1e-5."""
    assert got["count"] == want["count"]
    small = {n: np.zeros(g.shape, bool) for n, g in want["grads"][0].items()}
    for grads in want["grads"]:
        for n, g in grads.items():
            small[n] |= np.abs(g) <= 1e-6
    for n, w in want["weights"].items():
        diff = np.abs(got["weights"][n] - w)
        if n in small:
            assert (diff[~small[n]] <= 1e-6).all(), (n, diff[~small[n]].max())
            assert (diff <= 2 * lr_max * len(want["grads"]) + 1e-6).all(), (n, diff.max())
        else:
            assert (diff <= 1e-5).all(), (n, diff.max())
    for n in want["mu"]:
        np.testing.assert_allclose(got["mu"][n], want["mu"][n], rtol=0, atol=1e-5,
                                   err_msg=f"mu {n}")
        np.testing.assert_allclose(got["nu"][n], want["nu"][n], rtol=1e-4, atol=1e-7,
                                   err_msg=f"nu {n}")


def resnet18_config():
    cfg = port_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="resnet18"))


def byol_config():
    cfg = port_config(byol=True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_byol=True))


# each run two steps; stochastic depth 0.3 on the narrow ConvNeXt unless the
# run takes another backbone
SCENARIOS = {
    # the flagship's loss set in the joint phase, the presence noise drawn
    "stochastic_depth": lambda: make_run("stochastic_depth"),
    # ResNet-18's BatchNorm statistics over the whole batch
    "resnet18": lambda: make_run("resnet18", backbone=None, cfg=resnet18_config()),
    # the CLI's default align/uniformity losses with two OOD rows of eight
    "align_uniform_ood": lambda: make_run("align_uniform_ood",
                                          loss=dict(align=True, uni=True), ood=2),
    # the moments split over the ranks
    "zero1": lambda: make_run("zero1", zero1=True),
    # uint8 bases augmented in the step, in pretraining
    "augment_pretrain": lambda: make_run("augment_pretrain", uint8=True, phase=PRETRAIN),
    # path B: align_pf's log sums from the no-pf head
    "path_b": lambda: make_run("path_b", loss=dict(align_eps=None), fuse_align_pf=True),
    # BYOL: the projector's and predictor's BatchNorm over the whole batch
    "byol": lambda: make_run("byol", cfg=byol_config()),
}


def model_config(per_child=None, loss=None, **head):
    """``port_config`` with the head's ``head`` fields and ``per_child``
    prototypes a child (the tiny tree at the flagship's 10 lays 140 slots in
    P = 256, so the model boundary at 128 cuts its last node; at 4 it lays
    56, and no boundary of two model ranks cuts a node)."""
    cfg = port_config(**(loss or {}))
    model = dataclasses.replace(cfg.model, head=dataclasses.replace(cfg.model.head, **head))
    if per_child is not None:
        model = dataclasses.replace(model, num_protos_per_child=per_child)
    return dataclasses.replace(cfg, model=model)


# the runs of the model-axis tests (tests/test_torch_mesh_model*.py), two
# steps each on the narrow ConvNeXt with stochastic depth 0.3 unless the
# run takes another backbone
MODEL_SCENARIOS = {
    # the flagship's loss set; a boundary cuts the tree's last node
    "cut": lambda: make_run("cut"),
    # no boundary cuts a node
    "no_cut": lambda: make_run("no_cut", cfg=model_config(per_child=4)),
    # the feature losses and BYOL read the features on every model rank
    "align_uniform_byol": lambda: make_run("align_uniform_byol", cfg=dataclasses.replace(
        byol_config(), train=dataclasses.replace(byol_config().train, loss=dataclasses.replace(
            byol_config().train.loss, align=True, uni=True)))),
    # the head moments split on "model", the others' on "data"
    "zero1": lambda: make_run("zero1", zero1=True),
    # BatchNorm over the data ranks
    "resnet18": lambda: make_run("resnet18", backbone=None, cfg=resnet18_config()),
    # one run a family of head variants
    "unit_bias": lambda: make_run("unit_bias", cfg=model_config(add_on_type="unit",
                                                                add_on_bias=True)),
    "gumbel": lambda: make_run("gumbel", cfg=model_config(softmax_tau=None,
                                                          gumbel_softmax=True)),
    "spatial": lambda: make_run("spatial", cfg=model_config(softmax_over_channel=True)),
    "l2": lambda: make_run("l2", cfg=model_config(add_on_type="l2")),
}


def backbone64_run():
    """ResNet-18's backbone alone in float64 on a batch of 8 at 48^2."""
    import torch
    from pipnet_tpu_torch.models.resnet import resnet18_features
    torch.manual_seed(5)
    model = resnet18_features(dtype=torch.float64).double()
    r = np.random.default_rng(6)
    x = r.standard_normal((B, S, S, 3))
    w = r.standard_normal((B, S // 8, S // 8, 512))
    return dict(name="backbone64", kind="backbone64", x=x, w=w,
                state_dict={k: v.clone() for k, v in model.state_dict().items()})


def check_run(name, ranks, want):
    """Every rank's result of run ``name`` against the one-process step's:
    each step's metrics and gradients, then the weights and moments; every
    rank holds the same weights and generator state.  ResNet-18's f32
    gradients are not held at 1e-4: a ReLU input within rounding of zero
    moves them (a 1e-7 relative change of the input moves its f32 gradients
    by up to 18%, also in one process); its first step's loss and metrics
    (the global statistics forward) are held at 1e-5, its gradient in norm
    at 2e-2 and its BatchNorm statistics at 1e-5, and
    ``test_global_batchnorm_in_float64`` holds the backbone at 1e-10."""
    got = ranks[0][name]
    if name == "resnet18":
        m = dict(got["metrics"][0])
        g_norm = m.pop("grad_norm")
        w = dict(want["metrics"][0])
        np.testing.assert_allclose(g_norm, w.pop("grad_norm"), rtol=1e-3)
        check_metrics(m, w)
        for n, g in want["grads"][0].items():
            err = np.linalg.norm(got["grads"][0][n] - g)
            assert err <= 2e-2 * np.linalg.norm(g) + 1e-7, (n, err, np.linalg.norm(g))
    else:
        for i in range(len(want["metrics"])):
            check_metrics(got["metrics"][i], want["metrics"][i])
            check_grads(got["grads"][i], want["grads"][i])
        check_state(got, want)
    for other in ranks[1:]:
        for k, v in got["weights"].items():
            np.testing.assert_array_equal(other[name]["weights"][k], v, err_msg=k)
        np.testing.assert_array_equal(other[name]["generator"], got["generator"])
    np.testing.assert_array_equal(got["generator"], want["generator"])


def run_cli_ranks(argv, world, tmp_path, timeout=RANK_TIMEOUT, stop_after_epoch=None):
    """The training CLI ``argv`` on ``world`` gloo ranks (``run_cli``),
    cut short after epoch ``stop_after_epoch`` when given; returns the
    ranks' outputs."""
    job = str(tmp_path / f"cli_job_{world}_{len(os.listdir(tmp_path))}")
    with open(job, "wb") as f:
        pickle.dump({"argv": list(argv), "stop_after_epoch": stop_after_epoch}, f)
    return _start_ranks(job, world, timeout, mode=("cli",))
