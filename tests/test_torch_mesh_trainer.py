"""The port's Trainer and training CLI on a data mesh, on the CPU: a run of
``run_pipnet --data_parallel 2`` (two gloo ranks, ``torch_mesh_worker.py
cli``) against ``--data_parallel 1`` (CSV rows, JSONL rows, final weights;
the run directory written once), ZeRO-1 checkpoints (whole moments; a
resume in one process and a resume on the mesh, bit for bit), the ranks
``launch_ranks`` starts, and the batch trimming against the JAX Trainer's
batch counts on meshes of the host devices.
"""

import csv
import dataclasses
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

import torch_mesh_util as U
from test_torch_cli import port_small_backbone, small_run_argv  # noqa: F401 (fixture)

# a fixture of its own: test files run side by side
FIXTURE = "synthetic:8:5"
TIMING = {"images_per_sec", "epoch_seconds", "host_rss_mb"}


def _argv(run, *extra):
    return small_run_argv(run, "--dataset", FIXTURE, "--final_viz", "n",
                          "--checkpoint_every", "1", *extra)


def _csv_rows(run):
    out = {}
    for p, _, fs in os.walk(run):
        for f in fs:
            if f.endswith(".csv"):
                with open(os.path.join(p, f)) as fh:
                    out[os.path.relpath(os.path.join(p, f), run)] = list(csv.reader(fh))
    return out


def _jsonl(run, split):
    with open(run / f"metrics_{split}.jsonl") as f:
        return [json.loads(line) for line in f]


def _weights(run, name="net_trained_last"):
    return torch.load(run / "checkpoints" / f"{name}.pt", weights_only=True)


def _state(run, name="net_trained_last"):
    return torch.load(run / "checkpoints" / f"{name}.state.pt", weights_only=True)


def test_two_rank_run_equals_one_process(tmp_path, port_small_backbone):  # noqa: F811
    """One pretraining epoch, a finetune-classifier epoch and a joint epoch
    with evaluation: the same CSV rows (numbers within the last printed
    digit; images/s is a clock), the same JSONL rows within 1e-4 and final
    weights within 2e-4 (Adam steps lr * sign(g) where g is ~0), each file
    written once."""
    from pipnet_tpu_torch.main import run_pipnet
    one, two = tmp_path / "one", tmp_path / "two"
    assert run_pipnet(_argv(one, "--data_parallel", "1")) == 0
    U.run_cli_ranks(_argv(two, "--data_parallel", "2"), 2, tmp_path)

    want, got = _csv_rows(one), _csv_rows(two)
    assert set(got) == set(want) and len(want) > 10
    for name, rows in want.items():
        assert len(got[name]) == len(rows) and got[name][0] == rows[0], name
        skip = rows[0].index("images_per_sec") if "images_per_sec" in rows[0] else None
        for a, b in zip(got[name][1:], rows[1:]):
            for i, (x, y) in enumerate(zip(a, b)):
                if i == skip or x == y:
                    continue
                assert abs(float(x) - float(y)) <= 2e-5, (name, rows[0][i], x, y)
    for split in ("pretrain", "train"):
        rows_one, rows_two = _jsonl(one, split), _jsonl(two, split)
        assert [r["epoch"] for r in rows_two] == [r["epoch"] for r in rows_one]
        for a, b in zip(rows_two, rows_one):
            assert set(a) == set(b)
            for k in set(b) - TIMING:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-6), (split, k)
    w1, w2 = _weights(one), _weights(two)
    assert set(w1) == set(w2)
    for k, v in w1.items():
        torch.testing.assert_close(w2[k], v, atol=2e-4, rtol=0, msg=k)
    out = (two / "out.txt").read_text()
    assert out.count("pipnet_tpu_torch: device=cpu") == 1 and "rank 0 of 2" in out
    assert (two / "log.txt").read_text() == (one / "log.txt").read_text()


def test_zero1_checkpoints_hold_whole_moments_and_resume(tmp_path, port_small_backbone):  # noqa: F811
    """Runs of three training epochs on two ranks, cut short after the
    second: the ZeRO-1 run's checkpoints are the plain run's bit for bit
    (its update is the plain update on each rank's part, its moments are
    gathered whole); resumed on the mesh it ends bit for bit as the ZeRO-1
    run that never stopped; resumed in one process it continues bit for bit
    as the plain run's checkpoint does."""
    from pipnet_tpu_torch.main import run_pipnet
    three = ("--epochs", "3")
    for name, extra in (("plain", ()), ("zero1", ("--zero1", "y"))):
        U.run_cli_ranks(_argv(tmp_path / name, "--data_parallel", "2", *extra, *three), 2,
                        tmp_path, stop_after_epoch=2)
    for ckpt in ("net_trained", "net_pretrained"):
        a, b = _state(tmp_path / "plain", ckpt), _state(tmp_path / "zero1", ckpt)
        assert a["meta"]["epoch"] == (2 if ckpt == "net_trained" else 0)
        for part in ("opt_mu", "opt_nu"):
            for k, v in a[part].items():
                assert torch.equal(b[part][k], v), (ckpt, part, k)
        assert a["opt_count"] == b["opt_count"]
        wa, wb = _weights(tmp_path / "plain", ckpt), _weights(tmp_path / "zero1", ckpt)
        assert all(torch.equal(wb[k], v) for k, v in wa.items()), ckpt
    assert not (tmp_path / "zero1" / "checkpoints" / "net_trained_last.pt").exists()

    # resumed in one process, from either run's checkpoint
    for name in ("plain", "zero1"):
        shutil.copytree(tmp_path / name, tmp_path / f"{name}_one")
        assert run_pipnet(_argv(tmp_path / f"{name}_one", "--data_parallel", "1", *three,
                                "--resume")) == 0
    wa, wb = _weights(tmp_path / "plain_one"), _weights(tmp_path / "zero1_one")
    assert all(torch.equal(wb[k], v) for k, v in wa.items())
    assert [r["epoch"] for r in _jsonl(tmp_path / "zero1_one", "train")] == [2, 3, 4]

    # resumed on the mesh: as the ZeRO-1 run that never stopped
    U.run_cli_ranks(_argv(tmp_path / "whole", "--data_parallel", "2", "--zero1", "y", *three),
                    2, tmp_path)
    U.run_cli_ranks(_argv(tmp_path / "zero1", "--data_parallel", "2", "--zero1", "y", *three,
                          "--resume"), 2, tmp_path)
    wa, wb = _weights(tmp_path / "whole"), _weights(tmp_path / "zero1")
    assert all(torch.equal(wb[k], v) for k, v in wa.items())
    sa, sb = _state(tmp_path / "whole"), _state(tmp_path / "zero1")
    for part in ("opt_mu", "opt_nu"):
        assert all(torch.equal(sb[part][k], v) for k, v in sa[part].items()), part


def test_launch_ranks_starts_and_stops_the_ranks(tmp_path):
    """Each rank runs the command line with its rank in the environment;
    when one fails the others are stopped and the launch raises (each
    launch within U.RANK_TIMEOUT seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from pipnet_tpu_torch.main import launch_ranks, run_pipnet
    with ThreadPoolExecutor(1) as pool:
        assert pool.submit(launch_ranks, ["--help"], 2).result(timeout=U.RANK_TIMEOUT) == 0
        failing = pool.submit(run_pipnet, [
            "--data_parallel", "2", "--device", "cpu", "--dataset", str(tmp_path / "missing"),
            "--log_dir", str(tmp_path / "run")])
        with pytest.raises(RuntimeError, match=r"rank \d of 2 exited"):
            failing.result(timeout=U.RANK_TIMEOUT)


# -- trimming against the JAX Trainer ----------------------------------------

BATCH, OOD_BATCH = 6, 5


@pytest.fixture(scope="module")
def loaders():
    """Both packages' loaders on one fixture (8 classes of 5 images: ragged
    final batches of 6), device augmentation on, and an OOD fixture's."""
    from pipnet_tpu.data.loader import build_loaders as jax_loaders
    from pipnet_tpu_torch.data import build_loaders as port_loaders
    from pipnet_tpu_torch.datasets import resolve_dataset
    out = {}
    for name, spec, bs in (("id", FIXTURE + ":s4", BATCH), ("ood", "synthetic:4:4:s9", OOD_BATCH)):
        train_dir, test_dir, _, _ = resolve_dataset(spec)
        kw = dict(image_size=32, batch_size=bs, batch_size_pretrain=bs, seed=0,
                  device_photometric=True, device_geometric=True)
        out[name] = (jax_loaders(train_dir, test_dir, **kw), port_loaders(train_dir, test_dir, **kw))
    return out


class _NoState(NamedTuple):
    params: dict


def _jax_batches(monkeypatch, tmp_path, n_shards, loader, ood_loader, cache):
    """The labels of every step the JAX Trainer's ``run_epoch`` takes on a
    data mesh of ``n_shards`` host devices (its step replaced by one that
    records them)."""
    import jax.numpy as jnp
    from pipnet_tpu.config import HeadConfig, ModelConfig, RunConfig, TrainConfig
    from pipnet_tpu.models import build_pipnet
    from pipnet_tpu.train.trainer import Trainer
    import pipnet_tpu.tree as jt
    monkeypatch.setenv("PIPNET_DEVICE_DATA", "1" if cache else "0")
    root = jt.construct_phylo_tree(phylo=jt.Phylogeny(newick=U.TINY_NEWICK))
    root.assign_all_descendents()
    mcfg = ModelConfig(backbone="convnext_tiny_26", image_size=32, num_protos_per_child=4,
                       head=HeadConfig(softmax_tau=1.0, protopool=False))
    model, tree = build_pipnet(root, mcfg)
    cfg = RunConfig(model=mcfg, log_dir=str(tmp_path / "jax"),
                    train=TrainConfig(batch_size=BATCH, data_parallel=n_shards))
    trainer = Trainer(model, tree, cfg, loaders=None)
    trainer.state = _NoState(params={})          # the sparsity read finds no head
    seen, N = [], tree.num_nodes

    def raw(state, xs1, xs2, ys, scalars):
        zero = jnp.zeros((), jnp.int32)
        return state, {"loss": jnp.zeros(()), "fine_correct": zero, "n_fine": zero,
                       "node_correct": jnp.zeros(N, jnp.int32),
                       "node_examples": jnp.zeros(N, jnp.int32)}

    def step(state, xs1, xs2, ys, scalars, acc):
        seen.append(np.asarray(ys))
        return state, acc
    trainer._get_step = lambda statics: (step, raw)
    trainer.run_epoch(2, pretrain=False, net_t0=0, net_T=10, loader=loader,
                      ood_loader=ood_loader)
    return seen


CASES = {"ragged tail, 3 shards, streamed": (3, False, False),
         "every batch ragged, 5 shards, streamed": (5, False, False),
         "ragged tail, 3 shards, device cache": (3, True, False),
         "OOD chunk, 4 shards": (4, False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_trimming_matches_the_jax_trainer(monkeypatch, tmp_path, loaders, case):
    """Every rank's rows of every step, put together, are the rows of the
    JAX Trainer's step on a data mesh of as many devices (a ragged batch
    cut to a multiple of the axis, a batch cut to nothing skipped, the OOD
    chunk shortened so that the combined batch divides the axis)."""
    from pipnet_tpu_torch.train.trainer import Trainer
    n_shards, cache, ood = CASES[case]
    (jl, pl), (jo, po) = loaders["id"], loaders["ood"]
    want = _jax_batches(monkeypatch, tmp_path, n_shards, jl.train, jo.train if ood else None,
                        cache)
    run = U.make_run("trim", backbone=("convnext", 0.0))
    model, tree = U.build(run)
    cfg = dataclasses.replace(run["cfg"], log_dir=str(tmp_path / "port"))
    per_rank = []
    for rank in range(n_shards):
        mesh = U.fake_mesh(n_shards, rank=rank)
        trainer = Trainer(model, tree, cfg, None, mesh=mesh)
        per_rank.append(list(trainer.epoch_batches(pl.train, 2, cache,
                                                   po.train if ood else None)))
    assert len(want) == len(per_rank[0]) > 0
    assert any(len(ys) != BATCH + (ood and OOD_BATCH) for ys in want) or ood
    for i, ys in enumerate(want):
        parts = [batches[i] for batches in per_rank]
        assert all(p[-1] == len(ys) for p in parts)
        np.testing.assert_array_equal(np.concatenate([p[-2] for p in parts]), ys)
