"""The port's host tools (its copies of the JAX package's ``tools.py`` and
``runtime/wandb_export.py``) against the JAX package's: the same names, the
same renamed folders, trees, mappings and exported JSONL, file for file,
and the CLIs."""

import json
import os
import shutil

import pytest

import pipnet_tpu.runtime.wandb_export as jax_wandb
import pipnet_tpu.tools as jax_tools
import pipnet_tpu_torch.runtime.wandb_export as port_wandb
import pipnet_tpu_torch.tools as port_tools

NAMES = ["Parus major", "parus_major!", "Corvus  corax", "a-b c", "ina_003_Already_Done"]
FOLDERS = ["Parus major", "Corvus corax", "ina_003_Already_Done", "Pica-pica"]
NEWICK = "((Parus_major:1,Corvus_corax:1):1,(Pica_pica:1.5,'Sitta europaea':1):0.5);\n"


@pytest.mark.parametrize("prefix", ["ina", "cub"])
def test_normalize_name_matches_jax(prefix):
    for i, name in enumerate(NAMES):
        assert port_tools.normalize_name(name, i, prefix) == \
            jax_tools.normalize_name(name, i, prefix)


@pytest.mark.parametrize("dry_run", [False, True])
def test_rename_folders_matches_jax(tmp_path, dry_run):
    trees = {}
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        root = tmp_path / pkg
        for d in FOLDERS:
            (root / d).mkdir(parents=True)
        mapping = tools.rename_folders(str(root), dry_run=dry_run)
        files = sorted(os.listdir(root))
        saved = (root / "rename_mapping.json").read_text() if not dry_run else None
        trees[pkg] = (mapping, files, saved)
    assert trees["port"] == trees["jax"]


@pytest.mark.parametrize("mapping", [None, {"Pica_pica": "cub_009_Pica"}])
def test_rename_tree_leaves_matches_jax(tmp_path, mapping):
    src = tmp_path / "t.tre"
    src.write_text(NEWICK)
    out = {}
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        dst = tmp_path / f"{pkg}.tre"
        m = tools.rename_tree_leaves(str(src), str(dst), mapping, prefix="cub")
        out[pkg] = (m, dst.read_text())
    assert out["port"] == out["jax"]


def test_tools_cli_matches_jax(tmp_path, capsys):
    outs = {}
    for pkg, tools in (("jax", jax_tools), ("port", port_tools)):
        root = tmp_path / pkg
        (root / "Some bird").mkdir(parents=True)
        (root / "t.tre").write_text(NEWICK)
        assert tools.main(["rename-folders", str(root), "--dry_run"]) == 0
        assert (root / "Some bird").is_dir()
        assert tools.main(["rename-tree", str(root / "t.tre"), str(root / "o.tre")]) == 0
        printed = capsys.readouterr().out.replace(str(root), "ROOT")
        outs[pkg] = (printed, (root / "o.tre").read_text())
    assert outs["port"] == outs["jax"]


def _run_dir(path):
    """A run directory with the files the trainer writes that the exporter
    reads: metrics JSONL per split and per-node loss CSVs."""
    path.mkdir()
    with open(path / "metrics_train.jsonl", "w") as f:
        for epoch in (1, 2):
            f.write(json.dumps({"epoch": epoch, "loss": 1.5 / epoch, "fine_accuracy": 0.1 * epoch,
                                "loss/class": 0.7, "loss/uniform": -3.2, "loss/align": 0.4,
                                "loss/ood_bce": 0.05, "images_per_sec": 99.0}) + "\n")
    with open(path / "metrics_pretrain.jsonl", "w") as f:
        f.write(json.dumps({"epoch": 1, "loss": 2.0, "loss/tanh": 0.3}) + "\n")
    node = path / "node_wise_metrics_train"
    node.mkdir()
    (node / "root_losses.csv").write_text(
        "epoch,class,tanh,tanh_desc,kernel_orth,align_pf,accuracy\n"
        "1,0.50000,0.10000,n.a,n.a,0.20000,0.5000\n2,0.40000,0.10000,n.a,n.a,0.10000,0.7500\n")


def test_wandb_export_matches_jax(tmp_path):
    run = tmp_path / "run"
    _run_dir(run)
    outs = {}
    for pkg, mod in (("jax", jax_wandb), ("port", port_wandb)):
        path = mod.export_run(str(run), str(tmp_path / f"{pkg}.jsonl"))
        outs[pkg] = open(path).read()
    assert outs["port"] == outs["jax"] and outs["port"].count("\n") >= 2
    row = json.loads(outs["port"].splitlines()[-1])
    assert "train/uni_loss" in row or any("uni_loss" in k for k in row)


def test_wandb_export_cli_matches_jax(tmp_path, capsys):
    outs = {}
    for pkg, mod in (("jax", jax_wandb), ("port", port_wandb)):
        run = tmp_path / pkg
        _run_dir(run)
        assert mod.main(["--run_dir", str(run)]) == 0
        names = sorted(os.listdir(run))
        written = [n for n in names if n.endswith(".jsonl") and not n.startswith("metrics_")]
        outs[pkg] = (written, [open(run / n).read() for n in written],
                     capsys.readouterr().out.replace(str(run), "RUN"))
        shutil.rmtree(run)
    assert outs["port"] == outs["jax"] and outs["port"][0]
