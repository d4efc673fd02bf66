"""The training CLI with the JAX CLI's own defaults ``--align y --uni y``
and an OOD dataset (``--OOD_dataset``), in both packages on the CPU, from
the same seeded weights: the run directories' epoch CSVs and the
per-epoch loss parts agree.

The flagship's flags at a small size (a narrow ConvNeXt, 32^2, batch 4, 6
in pretraining, fixtures no other test file generates: ``synthetic:6:5``
and the OOD set ``synthetic:4:3:s7``), changed so that nothing random
differs between the two packages: the host's augmentation (``--device_augment
n``: both packages' host pipelines give the same views, seeded per batch)
and no mask-prune (its Gumbel sample comes from each package's own
generator); one pretraining epoch and two joint epochs (backbone frozen,
then unfrozen), an evaluation after each.  Losses are compared as the CSVs
print them (5 decimals) within 1e-4 relative, the accuracies exactly.
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest

from test_torch_cli import flagship_argv
from torch_port_util import SMALL_DEPTHS, SMALL_DIMS, small_backbones, to_jax

FIXTURE, OOD_FIXTURE = "synthetic:6:5", "synthetic:4:3:s7"
CHANGES = {"--batch_size": "4", "--batch_size_pretrain": "6", "--epochs": "2",
           "--epochs_pretrain": "1", "--epochs_finetune_classifier": "0",
           "--epochs_finetune": "0", "--freeze_epochs": "1", "--image_size": "32",
           "--eval_every": "1", "--compute_dtype": "float32",
           "--mask_prune_overspecific": "n", "--use_pallas_head": "n"}


def _argv(log_dir):
    argv = flagship_argv()
    for flag in ("--leave_out_classes", "--log_dir", "--dataset", "--align", "--uni"):
        i = argv.index(flag)
        del argv[i:i + 2]
    for flag, value in CHANGES.items():
        argv[argv.index(flag) + 1] = value
    assert "--align" not in argv and "--uni" not in argv      # the CLI's defaults: y
    return argv + ["--log_dir", str(log_dir), "--dataset", FIXTURE,
                   "--OOD_dataset", OOD_FIXTURE, "--device_augment", "n",
                   "--num_workers", "1", "--data_parallel", "1"]


def _weights(cfg, tree):
    from pipnet_tpu_torch.models import random_jax_params
    return random_jax_params(cfg.model, tree, seed=5, depths=SMALL_DEPTHS, dims=SMALL_DIMS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' run directories."""
    import pipnet_tpu.train.optimizer as jax_optimizer
    import pipnet_tpu.train.step as jax_step
    import pipnet_tpu.train.trainer as jax_trainer
    import pipnet_tpu_torch.train.trainer as port_trainer
    from pipnet_tpu.main import run_pipnet as jax_cli
    from pipnet_tpu_torch.main import run_pipnet as port_cli
    from pipnet_tpu_torch.models import params_from_jax
    from pipnet_tpu_torch.train import init_train_state
    root = tmp_path_factory.mktemp("cli_options")
    ood_steps = []

    def jax_init(self, image_size=None):
        params = to_jax(_weights(self.cfg, self.tree))
        self.state = jax_step.TrainState(params=params, batch_stats={},
                                         opt=jax_optimizer.adam_init(params),
                                         rng=jax.random.PRNGKey(self.cfg.train.seed), byol=())
        return self.state

    def port_init(self):
        self.model.load_state_dict(params_from_jax(_weights(self.cfg, self.tree)))
        self.state = init_train_state(self.model, seed=self.cfg.train.seed)
        return self.state

    real_epoch = port_trainer.Trainer.run_epoch

    def port_epoch(self, epoch, **kw):
        ood_steps.append((kw["pretrain"], kw.get("ood_loader") is not None))
        return real_epoch(self, epoch, **kw)

    with pytest.MonkeyPatch.context() as mp, small_backbones():
        mp.setattr(jax_trainer.Trainer, "init_state", jax_init)
        mp.setattr(port_trainer.Trainer, "init_state", port_init)
        mp.setattr(port_trainer.Trainer, "run_epoch", port_epoch)
        stdout = sys.stdout
        try:
            assert jax_cli(_argv(root / "jax")) == 0
        finally:
            sys.stdout = stdout          # the JAX CLI leaves its Tee installed
        assert port_cli(_argv(root / "port") + ["--device", "cpu"]) == 0
        assert sys.stdout is stdout
    return root / "jax", root / "port", ood_steps


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", ["epoch_wise_metrics_pretrain.csv",
                                  "epoch_wise_metrics_train.csv", "log_epoch_overview.csv"])
def test_epoch_csvs_match_jax(runs, name):
    jax_dir, port_dir, _ = runs
    want, got = _csv(jax_dir / name), _csv(port_dir / name)
    assert got[0] == want[0] and len(got) == len(want) > 1
    skip = {want[0].index("images_per_sec")} if "images_per_sec" in want[0] else set()
    for row_g, row_w in zip(got[1:], want[1:]):
        for i, (g, w) in enumerate(zip(row_g, row_w)):
            if i in skip:
                continue
            if "loss" in want[0][i]:
                assert float(g) == pytest.approx(float(w), rel=1e-4, abs=2e-5), (name, i)
            else:
                assert g == w, (name, want[0][i])


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_loss_parts_match_jax(runs):
    """Every epoch's averaged loss parts, the align, uniformity and OOD BCE
    terms among them (the OOD rows train in every joint epoch)."""
    jax_dir, port_dir, ood_steps = runs
    for split, parts in (("pretrain", {"loss/align", "loss/uniform"}),
                         ("train", {"loss/align", "loss/uniform", "loss/ood_bce"})):
        want, got = _jsonl(jax_dir / f"metrics_{split}.jsonl"), \
            _jsonl(port_dir / f"metrics_{split}.jsonl")
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            losses = {k for k in w if k.startswith("loss/")}
            assert parts <= losses and {k for k in g if k.startswith("loss/")} == losses
            for k in losses | {"loss", "fine_accuracy"}:
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), (split, k)
    assert ood_steps == [(True, False), (False, True), (False, True)]
    assert os.path.exists(port_dir / "checkpoints" / "net_trained_last.pt")
