"""The port's training CLI (``python -m pipnet_tpu_torch.main``) on the CPU:
its flags and their resolution against the JAX package's, the options it
refuses before training, a short real run at a small size (a narrow
ConvNeXt, 32^2, the ``synthetic:8:6`` fixture) whose run directory serves
the trainer's own logits, its resume, and where an installed package
builds its native code.
"""

import dataclasses
import functools
import json
import os
import shlex
import sys

import numpy as np
import pytest
import torch

from torch_port_util import REPO, SMALL_DEPTHS, SMALL_DIMS, SMALL_THRESHOLDS

FLAGSHIP_SCRIPT = os.path.join(REPO, "scripts", "runs", "run_lou_190.sh")
# a fixture no other test file generates: test files run in parallel
# workers, and the JAX package writes its fixture in place
FIXTURE = "synthetic:8:6"


def flagship_argv():
    """The flag list of ``scripts/runs/run_lou_190.sh``."""
    with open(FLAGSHIP_SCRIPT) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("python -m pipnet_tpu.main"))
    return [a for a in shlex.split(line)[3:] if a != "$@"]


def _parsers():
    from pipnet_tpu.main import build_arg_parser as jax_parser
    from pipnet_tpu_torch.main import build_arg_parser as port_parser
    return jax_parser(), port_parser()


def test_parser_has_every_flag_and_default_of_the_jax_cli():
    jax_p, port_p = _parsers()
    want = {a.dest: (a.default, a.type, a.choices, a.nargs, a.const, type(a).__name__)
            for a in jax_p._actions}
    got = {a.dest: (a.default, a.type, a.choices, a.nargs, a.const, type(a).__name__)
           for a in port_p._actions}
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert port_p.parse_args([]).device == "cuda"
    assert [a.option_strings for a in port_p._actions if a.dest != "device"] == \
        [a.option_strings for a in jax_p._actions]


DSL_VARIANTS = [
    [], ["--softmax", "y"], ["--softmax", "y|2"], ["--softmax", "n"],
    ["--tanh_desc", "y"], ["--tanh_desc", "y|0.2"], ["--tanh_desc", "n"],
    ["--mask_prune_overspecific", "y"], ["--mask_prune_overspecific", "y|7"],
    ["--mask_prune_overspecific", "y|20|1.1"],
    ["--minimize_contrasting_set", "y"], ["--minimize_contrasting_set", "y|3"],
    ["--minimize_contrasting_set", "y|1|0.1"],
    ["--byol", "y"], ["--byol", "y|0.99"], ["--byol", "y|0.99|0.999"],
    ["--stage4_reducer_net", "768,256,gelu|256,128"],
    ["--unitconv2d", "y"], ["--projectconv2d", "y"], ["--l2conv2d", "y"],
    ["--classifier", "Linear", "--bias", "--protopool", "y", "--weighted_loss"],
    ["--kernel_orth_cap", "3.5", "--tanh_eps", "0.5", "--align_eps", "1e-4"],
    ["--OOD_dataset", "synthetic:4:4:s9", "--OOD_ent", "y"],
    ["--leave_out_classes", "  ", "--disable_transform2", "y", "--num_workers", "3"],
]


@pytest.mark.parametrize("extra", DSL_VARIANTS, ids=lambda a: " ".join(a) or "flagship")
def test_from_reference_flags_matches_jax(extra):
    from pipnet_tpu.config import from_reference_flags as jax_flags
    from pipnet_tpu_torch.config import from_reference_flags as port_flags
    jax_p, port_p = _parsers()
    argv = flagship_argv() + extra
    want = dataclasses.asdict(jax_flags(jax_p.parse_args(argv)))
    got = dataclasses.asdict(port_flags(port_p.parse_args(argv)))
    assert got == want


@pytest.mark.parametrize("multiplier", ["", "2,3|1.5|40", "3|0.5|10"])
def test_gaussian_multiplier_strings_match_jax(multiplier):
    from pipnet_tpu.config import from_reference_flags as jax_flags
    from pipnet_tpu_torch.config import from_reference_flags as port_flags
    flags = {"basic_cnext_gaussian_multiplier": multiplier, "softmax": "y|1"}
    assert dataclasses.asdict(port_flags(flags)) == dataclasses.asdict(jax_flags(flags))


# -- short runs on the CPU -------------------------------------------------

def small_run_argv(log_dir, *extra):
    """The flagship's flags at a small size on the CPU: the fixture, 32^2,
    batch 4 (6 pretraining), one pretraining and two training epochs."""
    argv = flagship_argv()
    for flag in ("--leave_out_classes", "--log_dir", "--dataset"):
        i = argv.index(flag)
        del argv[i:i + 2]
    sizes = {"--batch_size": "4", "--batch_size_pretrain": "6", "--epochs": "2",
             "--epochs_pretrain": "1", "--epochs_finetune_classifier": "1",
             "--epochs_finetune": "1", "--freeze_epochs": "1", "--image_size": "32",
             "--eval_every": "1", "--compute_dtype": "float32"}
    for flag, value in sizes.items():
        argv[argv.index(flag) + 1] = value
    return argv + ["--log_dir", str(log_dir), "--dataset", FIXTURE,
                   "--mask_prune_overspecific", "y|2|1.1", "--num_workers", "2",
                   "--device", "cpu", *extra]


@pytest.fixture
def port_small_backbone(monkeypatch):
    """The port's ``convnext_tiny_26`` narrowed (no JAX model runs here)."""
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    monkeypatch.setitem(tp.BACKBONES, "convnext_tiny_26", (functools.partial(
        ConvNeXtTiny, stride_threshold=SMALL_THRESHOLDS["convnext_tiny_26"],
        depths=SMALL_DEPTHS, dims=SMALL_DIMS, stochastic_depth_prob=0.0), SMALL_DIMS[-1]))


@pytest.fixture
def captured_trainers(monkeypatch):
    """Every Trainer whose ``fit`` runs, in order."""
    from pipnet_tpu_torch.train.trainer import Trainer
    found, fit = [], Trainer.fit

    def capture(self, **kw):
        found.append(self)
        return fit(self, **kw)
    monkeypatch.setattr(Trainer, "fit", capture)
    return found


def test_short_run_serves_the_trainers_logits_and_resumes(tmp_path, port_small_backbone,
                                                         captured_trainers):
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.serve import Predictor
    from pipnet_tpu_torch.train import checkpoint_meta
    run = tmp_path / "run"
    stdout = sys.stdout
    assert run_pipnet(small_run_argv(run, "--profile_epoch", "2")) == 0
    assert sys.stdout is stdout
    trainer = captured_trainers[-1]
    trace = run / "traces" / "epoch_2" / "trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "aten::conv2d" for e in events) > 0

    names = {os.path.relpath(os.path.join(p, f), run) for p, _, fs in os.walk(run) for f in fs}
    for name in ("metadata/config.json", "metadata/classes.json", "metadata/tree.json",
                 "log_epoch_overview.csv", "epoch_wise_metrics_pretrain.csv",
                 "epoch_wise_metrics_train.csv", "metrics_train.jsonl", "out.txt", "log.txt"):
        assert name in names, name
    for ckpt, epoch in (("net_pretrained", 0), ("net_trained", 2), ("net_trained_last", 2)):
        assert {f"checkpoints/{ckpt}.pt", f"checkpoints/{ckpt}.state.pt"} <= names
        assert checkpoint_meta(str(run / "checkpoints" / ckpt))["epoch"] == epoch
    node_csvs = [n for n in names if n.startswith("node_wise_metrics_train/")]
    assert len(node_csvs) == trainer.tree.num_nodes == 7
    with open(run / "metrics_train.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    with open(run / "log_epoch_overview.csv") as f:
        assert f.read().splitlines()[0] == \
            "epoch,test_top1_acc,test_top5_acc,mean_train_acc,mean_train_loss"
    with open(run / "metadata" / "config.json") as f:
        saved = json.load(f)
    assert saved["phylo_config"].endswith("phylogeny.phy") and saved["model"]["image_size"] == 32
    assert "pipnet_tpu_torch: device=cpu" in (run / "out.txt").read_text()

    pred = Predictor(str(run), "net_trained_last", device="cpu")
    xs = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (pred.batch_size, 32, 32, 3)).astype(np.float32))
    logits, _, _ = pred.forward(xs)
    with torch.no_grad():
        want = trainer.model(xs, inference=True)["logits"]
    assert torch.equal(logits, want)
    answer = pred.predict([np.zeros((40, 40, 3), np.uint8)])
    assert answer[0]["class"] in trainer.loaders.classes

    # --resume continues at the recorded epoch and runs what is left
    assert run_pipnet(small_run_argv(run, "--resume", "--epochs", "3")) == 0
    assert sys.stdout is stdout
    with open(run / "metrics_train.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [2, 3, 4]
    assert checkpoint_meta(str(run / "checkpoints" / "net_trained_last"))["epoch"] == 3
    assert (run / "out.txt").read_text().count("resumed from epoch 2 (net_trained)") == 1


REFUSED = [
    (["--OOD_dataset", "synthetic:4:4:s9"], NotImplementedError, "ROADMAP item 11"),
    (["--align", "y"], NotImplementedError, "ROADMAP item 11"),
    (["--uni", "y"], NotImplementedError, "ROADMAP item 11"),
    (["--OOD_ent", "y"], NotImplementedError, "ROADMAP item 11"),
    (["--minmaximize", "y"], NotImplementedError, "ROADMAP item 11"),
    (["--data_parallel", "2"], NotImplementedError, "ROADMAP item 10"),
    (["--model_parallel", "2"], NotImplementedError, "ROADMAP item 10"),
    (["--zero1", "y"], NotImplementedError, "ROADMAP item 10"),
    (["--state_dict_dir_net", "x"], ValueError, "state_dict_dir_backbone"),
]


@pytest.mark.parametrize("extra,error,match", REFUSED, ids=lambda v: str(v))
def test_unported_options_raise_before_training(tmp_path, monkeypatch, extra, error, match):
    """... and leave ``sys.stdout`` as it was."""
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.train.trainer import Trainer
    monkeypatch.setattr(Trainer, "__init__", lambda *a, **k: pytest.fail("training began"))
    stdout = sys.stdout
    with pytest.raises(error, match=match):
        run_pipnet(small_run_argv(tmp_path / "run", *extra))
    assert sys.stdout is stdout


FINAL_VIZ = [["--final_viz", "y", "--final_viz_nodes", "root"], ["--final_viz", "y"]]


@pytest.mark.parametrize("extra", FINAL_VIZ, ids=lambda v: str(v))
def test_final_viz_draws_the_galleries(tmp_path, monkeypatch, port_small_backbone, extra):
    """``--final_viz y`` draws the galleries after training (``fit``
    replaced by loading seeded weights): with ``--final_viz_nodes``, the
    hierarchy galleries of those nodes alone; for at most 60 classes (the
    fixture has 8), every prototype's top-10 grid and every node's
    hierarchy galleries (``tests/test_torch_interp.py`` holds them to the
    JAX package's)."""
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.models import params_from_jax, random_jax_params
    from pipnet_tpu_torch.train.trainer import Trainer
    trees = []

    def fit(self, **kw):
        trees.append(self.tree)
        self.model.load_state_dict(params_from_jax(random_jax_params(
            self.cfg.model, self.tree, seed=2, depths=SMALL_DEPTHS, dims=SMALL_DIMS)))
        return {}
    monkeypatch.setattr(Trainer, "fit", fit)
    stdout = sys.stdout
    assert run_pipnet(small_run_argv(tmp_path / "run", *extra)) == 0
    assert sys.stdout is stdout
    out = tmp_path / "run" / "visualization_results"
    names = {os.path.relpath(os.path.join(p, f), out) for p, _, fs in os.walk(out) for f in fs}
    nodes = {n.split("/")[1] for n in names if n.startswith("hierarchy/")}
    top = {n for n in names if "/" not in n}
    assert any(n.endswith("_heatmaps.png") for n in names)
    if "--final_viz_nodes" in extra:
        assert nodes == {"root"} and not top
    else:
        assert nodes == set(trees[0].node_names)
        assert top and all(n.startswith("prototype_") and n.endswith(".png") for n in top)


def test_no_card_is_an_error_not_a_cpu_run(tmp_path, monkeypatch):
    from pipnet_tpu_torch.main import run_pipnet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in small_run_argv(tmp_path / "run") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pipnet(argv)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("layout", ["checkout", "installed"])
def test_build_root(tmp_path, monkeypatch, layout):
    """A checkout builds into its git-ignored ``build/``; an installed
    package (no ``pyproject.toml`` beside it) into the user's cache."""
    from pipnet_tpu_torch.native import BUILD_DIR as native_dir
    from pipnet_tpu_torch.ops.build import BUILD_DIR as kernel_dir
    from pipnet_tpu_torch.paths import build_root
    assert kernel_dir == build_root() / "kernels" and native_dir == build_root() / "native"
    assert build_root() == __import__("pathlib").Path(REPO) / "build"
    pkg = tmp_path / "site-packages" / "pipnet_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if layout == "checkout":
        (tmp_path / "site-packages" / "pyproject.toml").write_text("")
        assert build_root(pkg) == tmp_path / "site-packages" / "build"
    else:
        assert build_root(pkg) == tmp_path / "cache" / "pipnet_tpu_torch"
        monkeypatch.delenv("XDG_CACHE_HOME")
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        assert build_root(pkg) == tmp_path / "home" / ".cache" / "pipnet_tpu_torch"

