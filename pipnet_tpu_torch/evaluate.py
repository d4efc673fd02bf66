"""Standalone evaluation of a trained run with the PyTorch port (the
counterpart of the JAX package's ``evaluate.py``, itself the reference's
``test_nb.py``): rebuild the model from a run directory's saved config and
checkpoint and run the test pass (top-1/5, sparsity and explanation sizes,
abstentions, the held-in and left-out numbers of a leave-out run, per-node
accuracy and F1, optionally the OOD check), with the overspecificity mask,
a path softmax temperature or the leave-out decode.  It writes
``<run_dir>/eval_report{_masked}{_lou}{_tauT}.json`` with the keys and
numbers of the JAX package's report on the same weights.

    python -m pipnet_tpu_torch.evaluate --run_dir ./runs/cub190 \\
        [--checkpoint net_trained_last] [--leave_out_classes file.txt] \\
        [--apply_overspecificity_mask [--fixed_mask_seed S]] \\
        [--path_prob_softmax_tau 1.0] [--OOD_dataset D] [--skip_per_node] \\
        [--device cuda]

The forward runs on the card unless ``--device cpu`` is passed.  The flags
that need ``interp/*`` (``--threshold_prune``, ``--prune_leaf_parents``,
``--part_purity_csv`` with its annotation paths, ``--galleries_nodes``) are
not ported (ROADMAP.md item 9) and raise before any evaluation runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _unported(args) -> list:
    return [flag for flag, on in (
        ("--threshold_prune", args.threshold_prune is not None),
        ("--prune_leaf_parents", args.prune_leaf_parents),
        ("--part_purity_csv", args.part_purity_csv),
        ("--parts_loc", args.parts_loc is not None),
        ("--parts_name", args.parts_name is not None),
        ("--images_id", args.images_id is not None),
        ("--galleries_nodes", args.galleries_nodes is not None)) if on]


def run(argv=None) -> int:
    p = argparse.ArgumentParser("Evaluate a trained run with the PyTorch port")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default="net_trained_last")
    p.add_argument("--apply_overspecificity_mask", action="store_true")
    p.add_argument("--fixed_mask_seed", type=int, default=None,
                   help="with the overspecificity mask: draw ONE presence "
                        "sample for the whole pass (the deterministic pruned "
                        "model serve.py deploys) instead of the reference's "
                        "per-batch resampling")
    p.add_argument("--path_prob_softmax_tau", type=float, default=1.0)
    p.add_argument("--leave_out_classes", default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--OOD_dataset", default=None,
                   help="OOD dataset name: adds the eval_ood ID-fraction "
                        "report (ref pipnet/test.py:242-292)")
    p.add_argument("--skip_per_node", action="store_true",
                   help="skip the per-node accuracy/F1 sweep")
    p.add_argument("--threshold_prune", default=None, help="not ported (ROADMAP.md item 9)")
    p.add_argument("--prune_leaf_parents", action="store_true",
                   help="not ported (ROADMAP.md item 9)")
    p.add_argument("--part_purity_csv", action="store_true",
                   help="not ported (ROADMAP.md item 9)")
    p.add_argument("--parts_loc", default=None, help="not ported (ROADMAP.md item 9)")
    p.add_argument("--parts_name", default=None, help="not ported (ROADMAP.md item 9)")
    p.add_argument("--images_id", default=None, help="not ported (ROADMAP.md item 9)")
    p.add_argument("--galleries_nodes", default=None, help="not ported (ROADMAP.md item 9)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    unported = _unported(args)
    if unported:
        raise NotImplementedError(
            f"{unported}: not ported yet: they need interp/* (ROADMAP.md item 9)")

    from .data import build_loaders
    from .datasets import resolve_dataset
    from .device import resolve_device
    from .eval.metrics import (abstained_count, eval_ood, pred_path_explanation_size,
                               sparsity_stats)
    from .run_io import load_run, load_run_config
    from .runtime.log import RunLog
    from .train.checkpoint import checkpoint_meta
    from .train.trainer import Trainer, evaluate_per_node

    dev = resolve_device(args.device)
    cfg = load_run_config(args.run_dir)
    dataset = args.dataset or cfg.dataset
    train_dir, test_dir, project_dir, dkw = resolve_dataset(dataset, seed=cfg.train.seed)
    loaders = build_loaders(train_dir, test_dir, project_dir=project_dir,
                            image_size=cfg.model.image_size,
                            batch_size=cfg.train.batch_size,
                            batch_size_pretrain=cfg.train.batch_size_pretrain,
                            seed=cfg.train.seed)
    bundle = load_run(args.run_dir, checkpoint=args.checkpoint, dataset=dataset,
                      classes=loaders.classes, phylo_path=dkw.get("phylo_path"), device=dev)
    model, tree = bundle.model, bundle.tree
    extra = checkpoint_meta(os.path.join(args.run_dir, "checkpoints", args.checkpoint)) or {}
    # evaluation runs on one device: a run trained on a mesh must still
    # evaluate here, so the trained mesh is not replayed
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, data_parallel=1, model_parallel=1, zero1=False))
    trainer = Trainer(model, tree, cfg, loaders, log=RunLog(args.run_dir))
    print(f"restored {os.path.join(args.run_dir, 'checkpoints', args.checkpoint)}: {extra}")

    leave_out = None
    if args.leave_out_classes:
        with open(args.leave_out_classes) as f:
            leave_out = [line.strip() for line in f if line.strip()]
    result = trainer.evaluate(
        loaders.test, leave_out_classes=leave_out,
        apply_overspecificity_mask=args.apply_overspecificity_mask,
        path_prob_softmax_tau=args.path_prob_softmax_tau,
        fixed_mask_seed=args.fixed_mask_seed)

    with torch.no_grad():
        w_eff = model.head.effective_cls_weight().float().cpu().numpy()

    # full test-set sweep collecting joint scores / pooled / logits for the
    # metrics the reference reports in pipnet/test.py:66-96,152-292: the
    # plain decode (no leave-out short-circuit), with the mask a fresh
    # sample a batch (or the fixed one); one read after the pass
    step = trainer.get_eval_step(args.path_prob_softmax_tau, args.apply_overspecificity_mask)

    def collect(loader):
        keeps = (trainer.mask_samples(max(len(loader), 1), args.fixed_mask_seed)
                 if args.apply_overspecificity_mask else None)
        logps, pooleds, logitss, ys = [], [], [], []
        for i, (xs, y) in enumerate(trainer.eval_batches(loader)):
            out = step(xs, None if keeps is None else keeps[min(i, len(keeps) - 1)])
            logps.append(out["log_joint"].float())
            pooleds.append(out["pooled"].float())
            logitss.append(out["logits"].float())
            ys.append(y)
        flat = [torch.cat(t) for t in (logps, pooleds, logitss)]
        widths = [t.shape[1] for t in flat]
        host = torch.cat(flat, dim=1).cpu().numpy()
        logp, pooled, logits = np.split(host, np.cumsum(widths)[:-1], axis=1)
        scores = np.exp(logp.astype(np.float64))
        return scores, pooled, logits, np.concatenate(ys)

    scores, pooled, logits, ys = collect(loaders.test)
    result.update(sparsity_stats(w_eff, pooled))
    result.update(pred_path_explanation_size(
        pooled, w_eff, tree.leaf_child_col, tree.leaf_under_node,
        np.argmax(scores, axis=-1)))
    # abstain: no positive classifier evidence anywhere (ref pipnet/test.py:66-70)
    result["abstained"] = abstained_count(logits)

    if leave_out:
        # the calc_acc_LOU.ipynb surface reports BOTH numbers: top1/top5
        # above are the left-out images under the LOU decode short-circuit
        # (ref util/node.py:319-325); held_in_* is the plain decode
        # restricted to the classes the model actually trained on
        lo = {i for i, c in enumerate(tree.class_names) if c in leave_out}
        held = np.asarray([y not in lo for y in ys])
        order = np.argsort(scores, axis=-1)[:, ::-1]
        result["left_out_n"] = int((~held).sum())
        result["held_in_n"] = int(held.sum())
        result["held_in_top1"] = float((order[held, 0] == ys[held]).mean())
        result["held_in_top5"] = float(
            (order[held, :5] == ys[held, None]).any(axis=1).mean())

    if not args.skip_per_node:
        result["per_node"] = evaluate_per_node(trainer, loaders.test)

    if args.OOD_dataset:
        otrain, otest, oproj, _ = resolve_dataset(args.OOD_dataset, seed=cfg.train.seed)
        ood_loaders = build_loaders(otrain, otest, project_dir=oproj,
                                    image_size=cfg.model.image_size,
                                    batch_size=cfg.train.batch_size,
                                    seed=cfg.train.seed)
        ood_scores, *_ = collect(ood_loaders.test)
        result["ood"] = eval_ood(scores, ys, ood_scores, tree.num_classes)

    suffix = ""
    if args.apply_overspecificity_mask:
        suffix += "_masked"
    if leave_out:
        suffix += "_lou"
    if args.path_prob_softmax_tau != 1.0:
        suffix += f"_tau{args.path_prob_softmax_tau:g}"
    report_path = os.path.join(args.run_dir, f"eval_report{suffix}.json")
    # merge-on-write: a cheaper re-run (e.g. --skip_per_node, no --OOD_dataset)
    # refreshes only the keys it computed and keeps the expensive sections of
    # the previous report of the SAME suffix, provided it came from the same
    # checkpoint; a report from another checkpoint is discarded, not mixed
    result["checkpoint_id"] = {
        "checkpoint": args.checkpoint,
        "epoch": extra.get("epoch"),
        "phase": extra.get("phase"),
    }
    if os.path.exists(report_path):
        try:
            with open(report_path) as f:
                merged = json.load(f)
            if merged.get("checkpoint_id") == result["checkpoint_id"]:
                merged.update(result)
                result = merged
            else:
                print(f"eval_report: previous report was from checkpoint "
                      f"{merged.get('checkpoint_id')}, current is "
                      f"{result['checkpoint_id']}; starting fresh")
        except (json.JSONDecodeError, OSError):
            pass
    with open(report_path, "w") as f:
        json.dump(result, f, indent=2, default=float)

    print(json.dumps(result, indent=2, default=float))
    print(f"report written to {report_path}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
