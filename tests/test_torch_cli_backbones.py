"""The training CLI on another backbone with BYOL: ``--net resnet18 --byol
y`` on the fixture at the flagship's flags (``test_torch_cli.py``'s small
run), its checkpoints, its resume, and its run directory served,
evaluated and explained, on the CPU."""

import json
import os

import numpy as np
import torch

from test_torch_cli import small_run_argv


def test_resnet_byol_run_checkpoints_statistics_and_target(tmp_path, monkeypatch):
    """``--net resnet18 --byol y`` trains on the fixture (ResNet-18 at full
    width, 32^2): the checkpoint's weights hold every BatchNorm's running
    statistics (backbone, projector, predictor), moved from their seeded
    start, and its state file BYOL's EMA target; ``--resume`` brings both
    back into the trainer before it continues, and the next save holds the
    target moved on."""
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.train.trainer import Trainer
    run = tmp_path / "run"
    argv = small_run_argv(run, "--net", "resnet18", "--byol", "y")
    assert run_pipnet(argv) == 0
    ckpt = run / "checkpoints"
    weights = torch.load(ckpt / "net_trained.pt", weights_only=True)
    record = torch.load(ckpt / "net_trained.state.pt", weights_only=True)
    stats = [k for k in weights if k.endswith(("running_mean", "running_var"))]
    assert {k.split(".")[0] for k in stats} == {"backbone", "projector", "predictor"}
    assert len([k for k in stats if k.startswith("backbone.")]) == 2 * 20   # 20 BatchNorms
    pre = torch.load(ckpt / "net_pretrained.pt", weights_only=True)
    assert all(not torch.equal(weights[k], pre[k]) for k in stats)
    target = record["byol"]
    assert set(target) == {k for k in weights if k.startswith(("backbone.", "projector."))
                           and "running_" not in k}
    assert any(not torch.equal(target[k], weights[k]) for k in target)

    seen = {}
    fit = Trainer.fit

    def capture(self, **kw):
        seen["byol"] = {k: v.clone() for k, v in self.state.byol.items()}
        seen["buffers"] = {k: v.clone() for k, v in self.state.buffers.items()}
        return fit(self, **kw)
    monkeypatch.setattr(Trainer, "fit", capture)
    assert run_pipnet(argv + ["--resume", "--epochs", "3"]) == 0
    assert set(seen["byol"]) == set(target)
    assert all(torch.equal(seen["byol"][k], target[k]) for k in target)
    assert all(torch.equal(seen["buffers"][k], weights[k]) for k in stats)
    after = torch.load(ckpt / "net_trained.state.pt", weights_only=True)
    assert after["meta"]["epoch"] == 3
    assert any(not torch.equal(after["byol"][k], target[k]) for k in target)

    # the run directory serves, evaluates and explains
    from pipnet_tpu_torch.evaluate import run as evaluate
    from pipnet_tpu_torch.serve import Predictor
    pred = Predictor(str(run), "net_trained_last", device="cpu")
    assert pred.bundle.cfg.model.backbone == "resnet18" and pred.bundle.cfg.model.use_byol
    answer = pred.predict([np.zeros((40, 40, 3), np.uint8)])
    assert answer[0]["class"] in pred.classes
    assert evaluate(["--run_dir", str(run), "--device", "cpu", "--skip_per_node"]) == 0
    with open(run / "eval_report.json") as f:
        report = json.load(f)
    assert report["n"] > 0 and 0.0 <= report["top1"] <= 1.0
    info = pred.explain(np.full((40, 40, 3), 128, np.uint8), str(tmp_path / "explained"))
    assert info and os.listdir(tmp_path / "explained")
