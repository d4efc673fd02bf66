"""Offline wandb-compatible metric export (the port's copy of the JAX
package's ``runtime/wandb_export.py``; it reads run directories of either).

The reference logs per-epoch scalars to wandb with a fixed key scheme
(``pipnet/train.py:445-482``): ``<split>/epoch loss``, ``<split>/class_loss``,
per-node ``<split>/node_wise/acc:<node>`` and
``<split>/node_wise_<loss>/<node>``.  The trainer writes JSONL + CSVs
instead, with no network needed; this exporter turns a run directory into
the SAME key scheme as one JSONL stream, replayable into a wandb run on a
host that has it::

    import json, wandb
    run = wandb.init(project="pipnet", ...)
    for line in open("wandb_metrics.jsonl"):
        row = json.loads(line)
        run.log({k: v for k, v in row.items() if k != "step"}, step=row["step"])

Usage::

    python -m pipnet_tpu_torch.runtime.wandb_export --run_dir runs/cub190 \
        [--out runs/cub190/wandb_metrics.jsonl]
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
from typing import Dict, List

# our metric name -> the reference's wandb scalar name (pipnet/train.py:447-465)
_KEY_MAP = {
    "loss": "epoch loss",
    "fine_accuracy": "fine_accuracy",
    "loss/class": "class_loss",
    "loss/tanh": "tanh_loss",
    "loss/ood_bce": "OOD_loss",
    "loss/kernel_orth": "kernel_orth_loss",
    "loss/align": "a_loss",
    "loss/align_pf": "a_loss_pf",
    "loss/uniform": "uni_loss",
    "loss/tanh_desc": "tanh_desc_loss",
    "loss/byol": "byol_loss",
    "loss/overspecificity": "overspecificity_loss",
    "loss/mask_l1": "mask_l1_loss",
    "loss/min_contrast": "minimize_contrasting_set_loss",
}


def export_run(run_dir: str, out_path: str = "") -> str:
    """Collect metrics_{split}.jsonl + node_wise_metrics_{split}/*.csv into
    one wandb-scheme JSONL; returns the written path."""
    rows: Dict[int, Dict[str, float]] = {}

    def row(step: int) -> Dict[str, float]:
        return rows.setdefault(int(step), {"step": int(step)})

    for path in glob.glob(os.path.join(run_dir, "metrics_*.jsonl")):
        split = os.path.basename(path)[len("metrics_"):-len(".jsonl")]
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                r = row(rec.pop("epoch"))
                for k, v in rec.items():
                    name = _KEY_MAP.get(k)
                    if name is not None:
                        r[f"{split}/{name}"] = v

    for sub in glob.glob(os.path.join(run_dir, "node_wise_metrics_*")):
        split = os.path.basename(sub)[len("node_wise_metrics_"):]
        for csv_path in glob.glob(os.path.join(sub, "*_losses.csv")):
            node = os.path.basename(csv_path)[:-len("_losses.csv")]
            with open(csv_path) as f:
                for rec in csv.DictReader(f):
                    r = row(rec.pop("epoch"))
                    for loss_name, v in rec.items():
                        if v in ("n.a", "", None):
                            continue
                        if loss_name == "accuracy":
                            # ref: <split>/node_wise/acc:<node> (train.py:476)
                            r[f"{split}/node_wise/acc:{node}"] = float(v)
                        else:
                            # ref: <split>/node_wise_<loss>/<node> (train.py:481)
                            r[f"{split}/node_wise_{loss_name}/{node}"] = float(v)

    out_path = out_path or os.path.join(run_dir, "wandb_metrics.jsonl")
    with open(out_path, "w") as f:
        for step in sorted(rows):
            f.write(json.dumps(rows[step]) + "\n")
    return out_path


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser("Export a run dir to wandb-scheme JSONL")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    path = export_run(args.run_dir, args.out)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
