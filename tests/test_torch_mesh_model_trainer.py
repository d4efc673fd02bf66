"""The port's Trainer and training CLI on a (data, model) mesh, on the CPU:
``run_pipnet --data_parallel 2 --model_parallel 2 --use_pallas_head n``
(four gloo ranks, ``torch_mesh_worker.py cli``) against the one-process run
(its epochs' losses and metrics, its evaluations, its written checkpoint),
and a checkpoint the (2, 2) run wrote resumed in one process and on a
(1, 2) mesh, each continuing as the run that never stopped.
"""

import json
import shutil

import pytest
import torch

import torch_mesh_util as U
from test_torch_cli import port_small_backbone, small_run_argv  # noqa: F401 (fixture)

# a fixture of its own: test files run side by side
FIXTURE = "synthetic:8:4"
TIMING = {"images_per_sec", "epoch_seconds", "host_rss_mb"}
MODEL_AXIS = ("--model_parallel", "2", "--use_pallas_head", "n")


def _argv(run, *extra):
    return small_run_argv(run, "--dataset", FIXTURE, "--final_viz", "n",
                          "--checkpoint_every", "1", *extra)


def _jsonl(run, split):
    with open(run / f"metrics_{split}.jsonl") as f:
        return [json.loads(line) for line in f]


def _checkpoint(run, name="net_trained_last"):
    path = run / "checkpoints" / name
    return (torch.load(f"{path}.pt", weights_only=True),
            torch.load(f"{path}.state.pt", weights_only=True))


def _same_rows(got, want, rel=1e-4):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in set(b) - TIMING:
            assert a[k] == pytest.approx(b[k], rel=rel, abs=1e-6), k


def _same_checkpoint(got, want, atol=2e-4):
    """Weights within ``atol`` (Adam steps lr * sign(g) where g is ~0) and
    whole moments; the same counts and metadata."""
    (wg, sg), (ww, sw) = got, want
    assert set(wg) == set(ww)
    for k, v in ww.items():
        torch.testing.assert_close(wg[k], v, atol=atol, rtol=0, msg=k)
    for part in ("opt_mu", "opt_nu"):
        for k, v in sw[part].items():
            assert sg[part][k].shape == v.shape, (part, k)
            torch.testing.assert_close(sg[part][k], v, atol=atol, rtol=1e-3, msg=f"{part} {k}")
    assert sg["opt_count"] == sw["opt_count"] and sg["meta"] == sw["meta"]


def test_model_axis_run_equals_one_process(tmp_path, port_small_backbone):  # noqa: F811
    """One pretraining epoch and two training epochs (one evaluation each,
    on the whole head) on a (2, 2) mesh: the JSONL rows of every epoch
    within 1e-4, the log's evaluations and the written checkpoint (whole
    weights and moments) as the one-process run's; the run directory
    written once, by rank 0, and loaded whole for serving."""
    from pipnet_tpu_torch.main import run_pipnet
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    assert run_pipnet(_argv(one, "--data_parallel", "1")) == 0
    U.run_cli_ranks(_argv(mesh, "--data_parallel", "2", *MODEL_AXIS), 4, tmp_path)
    for split in ("pretrain", "train"):
        _same_rows(_jsonl(mesh, split), _jsonl(one, split))
    _same_checkpoint(_checkpoint(mesh), _checkpoint(one))
    assert (mesh / "log.txt").read_text() == (one / "log.txt").read_text()
    out = (mesh / "out.txt").read_text()
    assert out.count("pipnet_tpu_torch: device=cpu") == 1 and "rank 0 of 4" in out
    # the run directory serves: its whole model loads in one process
    from pipnet_tpu_torch.run_io import load_run
    bundle = load_run(str(mesh), device="cpu")
    assert (bundle.cfg.train.data_parallel, bundle.cfg.train.model_parallel) == (2, 2)
    served = bundle.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in _checkpoint(mesh)[0].items())


def test_model_axis_checkpoint_resumes_anywhere(tmp_path, port_small_backbone):  # noqa: F811
    """A (2, 2) run of three training epochs cut short after the second:
    resumed in one process and on a (1, 2) mesh, each ends as the one-process
    run of three epochs does (its last checkpoint's weights, moments and
    counts)."""
    from pipnet_tpu_torch.main import run_pipnet
    three = ("--epochs", "3")
    assert run_pipnet(_argv(tmp_path / "whole", "--data_parallel", "1", *three)) == 0
    cut = tmp_path / "cut"
    U.run_cli_ranks(_argv(cut, "--data_parallel", "2", *MODEL_AXIS, *three), 4, tmp_path,
                    stop_after_epoch=2)
    assert not (cut / "checkpoints" / "net_trained_last.pt").exists()
    shutil.copytree(cut, tmp_path / "cut_one")
    assert run_pipnet(_argv(tmp_path / "cut_one", "--data_parallel", "1", *three,
                            "--resume")) == 0
    U.run_cli_ranks(_argv(cut, "--data_parallel", "1", *MODEL_AXIS, *three, "--resume"), 2,
                    tmp_path)
    want = _checkpoint(tmp_path / "whole")
    for run in (tmp_path / "cut_one", cut):
        _same_checkpoint(_checkpoint(run), want)
        assert [r["epoch"] for r in _jsonl(run, "train")] == [2, 3, 4]


def test_fused_head_on_a_model_axis_is_refused(tmp_path):
    """The Trainer refuses ``use_pallas_head`` with a model axis, with the
    JAX Trainer's message, before it builds a mesh."""
    import dataclasses
    from pipnet_tpu_torch.train.trainer import PALLAS_HEAD_REFUSAL, Trainer
    run = U.make_run("refused", backbone=("convnext", 0.0))
    model, tree = U.build(run)
    cfg = run["cfg"]
    cfg = dataclasses.replace(
        cfg, log_dir=str(tmp_path / "run"),
        model=dataclasses.replace(cfg.model, use_pallas_head=True),
        train=dataclasses.replace(cfg.train, model_parallel=2))
    with pytest.raises(ValueError, match="Pallas head is a single-device kernel") as err:
        Trainer(model, tree, cfg, loaders=None)
    assert str(err.value) == PALLAS_HEAD_REFUSAL
