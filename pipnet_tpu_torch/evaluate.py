"""Standalone evaluation of a trained run with the PyTorch port (the
counterpart of the JAX package's ``evaluate.py``, itself the reference's
``test_nb.py``): rebuild the model from a run directory's saved config and
checkpoint and run the test pass (top-1/5, sparsity and explanation sizes,
abstentions, the held-in and left-out numbers of a leave-out run, per-node
accuracy and F1, optionally the OOD check), with the overspecificity mask,
a path softmax temperature or the leave-out decode.  It writes
``<run_dir>/eval_report{_masked}{_lou}{_tauT}.json`` with the keys and
numbers of the JAX package's report on the same weights.  The interp flags
add a projection over the projection loader (``interp/topk.py``) and, from
it, the threshold-pruning sweep with ``prototype_report.txt``, the top-k
patch CSV with part purity, and node galleries (written after the report,
then merged into it).

    python -m pipnet_tpu_torch.evaluate --run_dir ./runs/cub190 \\
        [--checkpoint net_trained_last] [--leave_out_classes file.txt] \\
        [--apply_overspecificity_mask [--fixed_mask_seed S]] \\
        [--path_prob_softmax_tau 1.0] [--OOD_dataset D] [--skip_per_node] \\
        [--threshold_prune 0.1,0.2,0.3 [--prune_leaf_parents]] \\
        [--part_purity_csv [--parts_loc F --parts_name F --images_id F]] \\
        [--galleries_nodes auto:6 | name,name] [--device cuda]

The forward runs on the card unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def resolve_gallery_nodes(spec: str, tree) -> list:
    """``--galleries_nodes`` spec -> internal-node index list.

    ``'auto:K'`` picks K nodes spread across the tree (internal nodes
    sorted by leaf-descendant count — a depth proxy — sampled evenly, so
    the root, mid-level clades and near-leaf nodes all appear); otherwise
    a comma-separated node-name list resolved against ``tree.node_names``.
    """
    if spec.startswith("auto:"):
        k = min(max(1, int(spec.split(":", 1)[1])), tree.num_nodes)
        order = sorted(range(tree.num_nodes),
                       key=lambda ni: -int(tree.node_num_leaves[ni]))
        idx = [order[int(round(i * (len(order) - 1) / max(k - 1, 1)))]
               for i in range(k)]
        return sorted(set(idx))
    name_to_idx = {n: i for i, n in enumerate(tree.node_names)}
    missing = [n for n in spec.split(",") if n not in name_to_idx]
    if missing:
        raise SystemExit(f"--galleries_nodes: unknown nodes {missing}; "
                         f"known: {tree.node_names[:5]}...")
    return [name_to_idx[n] for n in spec.split(",")]


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
    p.add_argument("--threshold_prune", default=None,
                   help="prune_by_threshold.ipynb cells 11-14: zero the "
                        "classifier columns of prototypes whose top-k mean "
                        "activation over ANY relevant leaf's projection "
                        "images falls below this threshold; writes "
                        "prototype_report.txt and re-evaluates.  A comma-"
                        "separated list sweeps thresholds (the accuracy-vs-"
                        "pruned curve) computing the projection stats once")
    p.add_argument("--prune_leaf_parents", action="store_true",
                   help="with --threshold_prune: ALSO prune prototypes at "
                        "nodes whose children are all leaves — the reference "
                        "notebook exempts those nodes (cell 11's "
                        "non_leaf_children check); this flag reproduces the "
                        "non-reference behavior for A/B")
    p.add_argument("--part_purity_csv", action="store_true",
                   help="write the per-prototype top-k patch-box CSV "
                        "(util/eval_cub_csv.py get_topk_cub); with the three "
                        "annotation paths below, also score part purity")
    p.add_argument("--parts_loc", default=None,
                   help="CUB parts/part_locs.txt (with --part_purity_csv)")
    p.add_argument("--parts_name", default=None,
                   help="CUB parts/parts.txt (with --part_purity_csv)")
    p.add_argument("--images_id", default=None,
                   help="CUB images.txt id<->path map (with --part_purity_csv)")
    p.add_argument("--galleries_nodes", default=None,
                   help="node-scoped hierarchy galleries on THIS run: a "
                        "comma-separated internal-node name list, or "
                        "'auto:K' to pick K nodes spread across tree depths. "
                        "Lifts the training CLI's <=60-class final-viz gate (ref "
                        "main.py:835) for real-tree-scale artifacts; "
                        "descendant + non-descendant grids and heatmap "
                        "overlays per util/vis_hpipnet.py:184-389.")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

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

    if args.threshold_prune is not None or args.part_purity_csv or args.galleries_nodes:
        from .interp import run_projection
        proj = run_projection(model, tree, loaders.project, image_size=cfg.model.image_size)
    if args.part_purity_csv:
        from .interp import eval_prototypes_parts_csv, write_topk_patch_csv
        csv_path = os.path.join(args.run_dir, "topk_patches.csv")
        write_topk_patch_csv(proj, csv_path, k=10, tree=tree, w_eff=w_eff)
        result["topk_patch_csv"] = csv_path
        if args.parts_loc and args.parts_name and args.images_id:
            result["part_purity"] = eval_prototypes_parts_csv(
                csv_path, args.parts_loc, args.parts_name, args.images_id,
                image_size=cfg.model.image_size)
    if args.threshold_prune is not None:
        result[("threshold_prune_leaf_parents_ab" if args.prune_leaf_parents
                else "threshold_prune")] = _threshold_sweep(
            args, trainer, proj, w_eff, result, leave_out)

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

    # galleries last, after the metrics are on disk: a gallery failure (say
    # out of memory at an unusually large node) must not lose the report
    if args.galleries_nodes:
        from .interp import save_hierarchy_galleries
        from .interp.hierarchy_viz import make_heatmap_forward
        node_idx = resolve_gallery_nodes(args.galleries_nodes, tree)
        t0 = time.perf_counter()
        gdir = os.path.join(args.run_dir, "node_galleries")
        written = save_hierarchy_galleries(
            proj, tree, w_eff, model.head.proto_presence.detach().float().cpu().numpy(),
            gdir, k=10, heatmap_forward=make_heatmap_forward(model, tree, proj),
            nodes=node_idx)
        result["node_galleries"] = {
            "nodes": [tree.node_names[i] for i in node_idx],
            "files": len(written), "dir": gdir,
            "seconds": round(time.perf_counter() - t0, 1),
        }
        print(f"node galleries: {len(written)} files in "
              f"{result['node_galleries']['seconds']}s -> {gdir}")
        with open(report_path, "w") as f:
            json.dump(result, f, indent=2, default=float)

    print(json.dumps(result, indent=2, default=float))
    print(f"report written to {report_path}")
    return 0


def _threshold_sweep(args, trainer, proj, w_eff, result, leave_out) -> dict:
    """Zero overspecific prototypes' classifier columns, report, re-test (ref
    prune_by_threshold.ipynb cells 11-14: accuracy before/after) for each
    threshold of ``--threshold_prune``, off ONE projection.  Each threshold
    copies its pruned weights into ``head.cls_weight`` in place; the
    original tensor's values are copied back afterwards, bit for bit."""
    from .interp import prototype_report
    from .interp.pruning import apply_threshold_prune, prune_means
    tree, head = trainer.tree, trainer.model.head
    thresholds = [float(t) for t in str(args.threshold_prune).split(",")]
    original = head.cls_weight.detach().clone()
    cls_w = original.float().cpu().numpy()
    means = prune_means(proj, tree, w_eff)
    rp = os.path.join(args.run_dir, "prototype_report.txt")
    with open(rp, "w") as f:
        f.write(prototype_report(proj, tree, w_eff,
                                 head.proto_presence.detach().float().cpu().numpy()) + "\n")
    dead_before = int((np.abs(cls_w).sum(0) == 0).sum())
    sweep = []
    try:
        for t in thresholds:
            new_w = apply_threshold_prune(means, tree, cls_w, threshold=t,
                                          include_leaf_parent_nodes=args.prune_leaf_parents)
            dead_after = int((np.abs(new_w).sum(0) == 0).sum())
            with torch.no_grad():
                head.cls_weight.copy_(torch.from_numpy(new_w))
            after = trainer.evaluate(
                trainer.loaders.test, leave_out_classes=leave_out,
                apply_overspecificity_mask=args.apply_overspecificity_mask,
                path_prob_softmax_tau=args.path_prob_softmax_tau)
            sweep.append({"threshold": t, "pruned_columns": dead_after - dead_before,
                          "top1_after": after["top1"], "top5_after": after["top5"]})
            print(f"threshold_prune {t}: pruned {dead_after - dead_before} "
                  f"columns, top1 {result['top1']:.4f} -> {after['top1']:.4f}")
    finally:
        with torch.no_grad():
            head.cls_weight.copy_(original)
    # the non-reference A/B (leaf parents pruned too) goes under its own key
    # in the report, so a later merge never clobbers the reference sweep
    return {**sweep[0], "top1_before": result["top1"], "top5_before": result["top5"],
            "prune_leaf_parents": bool(args.prune_leaf_parents),
            "prototype_report": rp, "sweep": sweep}


if __name__ == "__main__":
    sys.exit(run())
