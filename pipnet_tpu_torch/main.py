"""The PyTorch port's command line: the reference-flag-compatible training
entry point (the counterpart of the JAX package's ``main.py``).

``python -m pipnet_tpu_torch.main --dataset synthetic --phylo_config auto ...``

Accepts the JAX package's flags, defaults and the reference's string DSLs
(``util/args.py:14-402``), so the ``scripts/runs/run_*.sh`` invocations
translate directly, and resolves them once into the static ``RunConfig``.
Training runs on the card unless ``--device cpu`` asks for the CPU.
Options the port does not have yet raise before any training, naming their
``ROADMAP.md`` item: the OOD dataset and the losses still to be ported
(item 11) and the mesh options (item 10).  Every backbone of the JAX
package (``--net``) and ``--byol y`` train.  After training,
``--final_viz y`` draws the prototype galleries (``final_galleries``): for
60 classes or fewer, or for the nodes of ``--final_viz_nodes``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Train PIP-Net / HComP-Net with the PyTorch port")
    add = p.add_argument
    add("--dataset", type=str, default="synthetic")
    add("--OOD_dataset", type=str, default=None)
    add("--validation_size", type=float, default=0.0)
    add("--net", type=str, default="convnext_tiny_26")
    add("--batch_size", type=int, default=64)
    add("--batch_size_pretrain", type=int, default=128)
    add("--epochs", type=int, default=60)
    add("--epochs_pretrain", type=int, default=10)
    add("--epochs_finetune", type=int, default=5)
    add("--epochs_finetune_classifier", type=int, default=3)
    add("--epochs_finetune_mask_prune", type=int, default=999999999)
    add("--freeze_epochs", type=int, default=10)
    add("--optimizer", type=str, default="Adam")
    add("--lr", type=float, default=0.05)
    add("--lr_block", type=float, default=0.0005)
    add("--lr_net", type=float, default=0.0005)
    add("--weight_decay", type=float, default=0.0)
    # NOT in the reference (which never clips and NaN-raises instead,
    # pipnet/train.py:1126-1128); needed to train from random init — see
    # OptimConfig.clip_grad.  0 disables (default = reference behavior).
    add("--clip_grad", type=float, default=0.0)
    # Clip each parameter group by its own norm instead of one global
    # scale — decouples the just-thawed backbone's noisy gradient norm
    # from the learning groups' step sizes.  See OptimConfig.
    add("--clip_grad_per_group", type=str, default="n")
    # NOT in the reference either (same random-init rationale): linear lr
    # warmup for the deep-backbone group over N epochs after the
    # freeze_epochs unfreeze — see OptimConfig.unfreeze_warmup_epochs.
    add("--unfreeze_warmup_epochs", type=float, default=0.0)
    # NOT in the reference (same random-init rationale): override the
    # epsilon inside -log(tanh(x)+eps), bounding that term's 1/(x+eps)
    # gradient — see LossConfig.tanh_eps.  Unset = reference-exact
    # (1e-8, or 1e-12 after the min-contrast rebinding quirk).
    add("--tanh_eps", type=float, default=None)
    # NOT in the reference (same random-init rationale): override the
    # epsilon inside align_pf's -log(<pf1,pf2>+eps), bounding its 1/(ip+eps)
    # gradient — see LossConfig.align_eps.  Unset = reference-exact 1e-12.
    add("--align_eps", type=float, default=None)
    add("--log_dir", type=str, default="./runs/run_pipnet")
    add("--num_features", type=int, default=0)
    add("--image_size", type=int, default=224)
    add("--state_dict_dir_net", type=str, default="")
    add("--state_dict_dir_backbone", type=str, default="")
    add("--state_dict_dir_fullmodel", type=str, default="")
    add("--dir_for_saving_images", type=str, default="visualization_results")
    add("--disable_pretrained", action="store_true")
    add("--weighted_loss", action="store_true")
    add("--seed", type=int, default=1)
    add("--num_workers", type=int, default=8)
    add("--device_augment", type=str, default="full",
        help="'full' (default): run transform1 (geometric TrivialAugment + "
             "flip + RandomResizedCrop, ops/device_geometric) AND transform2 "
             "(photometric + crop + normalize, ops/device_augment) on the "
             "device, with the host caching decoded resized bases; 'y': "
             "transform2 only; 'n': all-host PIL pipeline.  Auto-disabled "
             "for grayscale / disable_transform2 recipes")
    add("--bias", action="store_true")
    add("--add_on_bias", action="store_true")
    add("--phylo_config", type=str, default=None)
    add("--experiment_note", type=str, default="")
    add("--kernel_orth", type=str, default="n")
    # Per-node bound on the kernel-orth term (value AND gradient) — guards
    # against the measured saturated-node runaway that starves the add-on
    # group under grad clipping (LossConfig.kernel_orth_cap).  Unset =
    # reference-exact unbounded.
    add("--kernel_orth_cap", type=float, default=None)
    add("--num_protos_per_descendant", type=int, default=4)
    add("--num_protos_per_child", type=int, default=0)
    add("--tanh_desc", type=str, default="y")
    add("--align", type=str, default="y")
    add("--uni", type=str, default="y")
    add("--align_pf", type=str, default="n")
    add("--tanh", type=str, default="n")
    add("--tanh_during_second_phase", type=str, default="n")
    add("--minmaximize", type=str, default="n")
    add("--minimize_contrasting_set", type=str, default="n")
    add("--OOD_ent", type=str, default="n")
    add("--softmax", type=str, default="n")
    add("--gumbel_softmax", type=str, default="n")
    add("--gs_tau", type=float, default=0.5)
    add("--multiply_cs_softmax", type=str, default="n")
    add("--unitconv2d", type=str, default="n")
    add("--projectconv2d", type=str, default="n")
    add("--l2conv2d", type=str, default="n")
    add("--focal", type=str, default="n")
    add("--training_wheels", type=str, default="n")
    add("--weighted_ce_loss", type=str, default="n")
    add("--protopool", type=str, default="y")
    add("--focal_loss", type=str, default="n")
    add("--focal_loss_gamma", type=float, default=2.0)
    add("--stage4_reducer_net", type=str, default="")
    add("--sg_before_protos", type=str, default="n")
    add("--leave_out_classes", type=str, default="")
    add("--byol", type=str, default="n")
    add("--disable_transform2", type=str, default="n")
    add("--softmax_over_channel", type=str, default="n")
    add("--classifier", type=str, default="NonNegative")
    add("--pipnet_sparsity", type=str, default="y")
    add("--mask_prune_overspecific", type=str, default="n")
    add("--sg_before_masking", type=str, default="y")
    add("--geometric_mean_overspecificity_score", type=str, default="n")
    add("--cl_weight", type=float, default=2.0)
    add("--wandb", type=str, default="n")
    add("--copy_files", type=str, default="n")
    # extensions of the JAX package (its mesh options raise here: the port
    # trains on one device, ROADMAP item 10)
    add("--data_parallel", type=int, default=0,
        help="data-parallel shards: 0 = all visible devices (the port: one "
             "device; above 1 is not ported)")
    add("--zero1", type=str, default="n",
        help="y: shard the Adam moments over the data axis (ZeRO-1; a "
             "dp-fold cut in optimizer-state HBM for one extra all-gather)")
    add("--model_parallel", type=int, default=1,
        help="shard the stacked prototype axis of the head over this many "
             "devices (2-D data x model mesh; for very large phylogenies — "
             "see runtime/mesh.py; requires the XLA head)")
    add("--compute_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"])
    add("--fast_gelu", type=str, default="n",
        help="(y/n) tanh-approximate GELU: faster, breaks exact torchvision parity")
    add("--use_pallas_head", type=str, default="n",
        help="(y/n) fused prototype-head kernel; recorded in the config (the "
             "port's head always runs its CUDA kernel K1 on the card)")
    add("--use_pallas_backbone", type=str, default="n",
        help="(y/n) fused ConvNeXt-block kernel (K4)")
    add("--eval_every", type=int, default=5)
    add("--profile_epoch", type=int, default=0,
        help="capture a torch.profiler trace of a few steady-state "
             "steps of this train epoch into <log_dir>/traces/ "
             "(Chrome / Perfetto); 0 = off")
    add("--checkpoint_every", type=int, default=1,
        help="epochs between rolling net_trained saves (1 = reference "
             "parity: every epoch; the last epoch always saves)")
    add("--final_viz", type=str, default="y")
    add("--final_viz_nodes", type=str, default=None,
        help="comma-separated internal-node names: write hierarchy "
             "galleries for JUST these nodes, lifting the <=60-class gate "
             "(ref main.py:835 gates final viz entirely at scale; this "
             "keeps the gallery surface reachable for 190-class trees)")
    add("--device", type=str, default="cuda",
        help="cuda (default) or cpu: the port runs on the card unless asked "
             "for the CPU")
    add("--resume", action="store_true",
        help="restore the latest net_trained checkpoint from log_dir and "
             "continue (replaces the reference's filename-parsing resume, "
             "main_dist.py:405-408)")
    return p


def _refuse_unported(args) -> None:
    """Raise, before any work, on the flags whose code is not ported yet."""
    if args.state_dict_dir_net:
        raise ValueError("use --state_dict_dir_backbone (the reference forbids "
                         "state_dict_dir_net too, main.py:291)")
    refused = [why for why, on in (
        ("--OOD_dataset: the OOD losses, ROADMAP item 11", args.OOD_dataset is not None),
        ("--align y / --uni y (the defaults; the flagship passes n): the align and "
         "uniformity losses, ROADMAP item 11", "y" in (args.align[:1], args.uni[:1])),
        ("--OOD_ent y: ROADMAP item 11", args.OOD_ent[:1] == "y"),
        ("--minmaximize y: ROADMAP item 11", args.minmaximize[:1] == "y"),
        (f"--data_parallel {args.data_parallel}: ROADMAP item 10", args.data_parallel > 1),
        (f"--model_parallel {args.model_parallel}: ROADMAP item 10", args.model_parallel > 1),
        ("--zero1 y: ROADMAP item 10", args.zero1 == "y")) if on]
    if refused:
        raise NotImplementedError(f"not ported yet: {'; '.join(refused)}")


def run_pipnet(argv=None) -> int:
    """Train from the command line ``argv``.  ``sys.stdout`` is duplicated
    into ``<log_dir>/out.txt`` while the run lasts and restored when it
    returns or raises."""
    args = build_arg_parser().parse_args(argv)
    _refuse_unported(args)
    from .config import from_reference_flags
    from .device import resolve_device
    from .runtime.log import RunLog, Tee

    dev = resolve_device(args.device)

    cfg = from_reference_flags(args)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype=args.compute_dtype,
                                  fast_gelu=args.fast_gelu == "y",
                                  use_pallas_head=args.use_pallas_head == "y",
                                  use_pallas_backbone=args.use_pallas_backbone == "y"),
        train=dataclasses.replace(cfg.train, data_parallel=args.data_parallel,
                                  model_parallel=args.model_parallel,
                                  zero1=args.zero1 == "y"))
    log = RunLog(cfg.log_dir)
    stdout = sys.stdout
    tee = Tee(os.path.join(cfg.log_dir, "out.txt"), stdout)
    sys.stdout = tee
    try:
        return _train(args, cfg, log, dev)
    finally:
        sys.stdout = stdout
        tee.close()


def _train(args, cfg, log, dev) -> int:
    import torch

    from .data import build_loaders
    from .datasets import resolve_dataset
    from .models import build_pipnet
    from .train.checkpoint import (latest_train_checkpoint, load_backbone_only,
                                   resolve_checkpoint, restore_checkpoint)
    from .train.trainer import Trainer
    from .tree import build_tree_from_config, flat_tree

    t_start = time.time()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"pipnet_tpu_torch: device={dev} ({name}), torch {torch.__version__}")
    device_augment = args.device_augment in ("y", "full")
    device_geometric = args.device_augment == "full"

    # data
    train_dir, test_dir, project_dir, dkw = resolve_dataset(cfg.dataset, seed=cfg.train.seed)
    leave_out = None
    if cfg.leave_out_classes:
        with open(cfg.leave_out_classes) as f:
            leave_out = [line.strip() for line in f if line.strip()]
    loaders = build_loaders(
        train_dir, test_dir, project_dir=project_dir,
        image_size=cfg.model.image_size,
        batch_size=cfg.train.batch_size,
        batch_size_pretrain=cfg.train.batch_size_pretrain,
        seed=cfg.train.seed, weighted=cfg.weighted_sampler,
        leave_out_classes=leave_out,
        disable_transform2=cfg.disable_transform2,
        cars=dkw.get("cars", False), grayscale=dkw.get("grayscale", False),
        validation_size=cfg.validation_size, num_workers=cfg.num_workers,
        device_photometric=device_augment, device_geometric=device_geometric)
    if dkw.get("cars", False):
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, device_augment_cars=True))

    # tree: explicit phylogeny yaml, auto (synthetic bundles one), or flat
    phylo_path, distances = None, None
    if args.phylo_config in ("auto", None) and "phylo_path" in dkw:
        phylo_path = dkw["phylo_path"]
    elif args.phylo_config:
        import yaml
        with open(args.phylo_config) as f:
            pc = yaml.safe_load(f)
        # the reference's yamls hard-code cluster paths (configs/*.yaml);
        # these accept $ENV_VAR references so shipped configs are portable
        phylo_path = os.path.expandvars(pc["phylogeny_path"])
        distances = pc.get("phyloDistances_string")
        if distances in ("None", None):
            distances = None
    if phylo_path:
        root = build_tree_from_config(phylo_path, distances)
        if args.phylo_config in ("auto", None):
            # the auto-resolved phylogeny goes into the saved config so that
            # serving can rebuild the tree from the run dir alone
            cfg = dataclasses.replace(cfg, phylo_config=str(phylo_path))
    else:
        root = flat_tree(loaders.classes, cfg.model.num_features or 512)
    print(f"tree: {len(root.nodes_with_children())} internal nodes, "
          f"{len(root.leaves())} leaves")
    log.save_tree(root)
    try:
        root.save_visualization(os.path.join(cfg.log_dir, "tree"))
    except Exception as e:                      # the picture is best-effort
        print(f"tree visualization skipped: {e!r}")

    # model
    model, tree = build_pipnet(root, cfg.model, weighted=cfg.train.loss.weighted_ce,
                               class_names=loaders.classes, device=dev)
    print(tree.summary())

    trainer = Trainer(model, tree, cfg, loaders, log=log)
    if args.profile_epoch > 0:
        trainer.trace_epoch = args.profile_epoch
    trainer.checkpoint_every = max(1, args.checkpoint_every)
    trainer.init_state()

    # partial restore (the --state_dict_dir_* contract, main.py:289-388), from
    # the port's own checkpoints (checkpoints/<name>, train/checkpoint.py)
    if args.state_dict_dir_backbone:
        trainer.adopt_state(load_backbone_only(args.state_dict_dir_backbone, trainer.state))
    elif args.state_dict_dir_fullmodel:
        restored, extra = restore_checkpoint(args.state_dict_dir_fullmodel, trainer.state)
        trainer.adopt_state(restored)
        print(f"restored full model: {extra}")

    start_epoch, skip_pretrain = 0, False
    if args.resume:
        # the NEWEST train-phase checkpoint by recorded epoch: with
        # --checkpoint_every > 1 a periodic net_trained_<E> snapshot can be
        # newer than the rolling net_trained
        ckpt, _ = latest_train_checkpoint(log.checkpoint_dir)
        pretrained = os.path.join(log.checkpoint_dir, "net_pretrained")
        if ckpt is not None:
            restored, extra = restore_checkpoint(ckpt, trainer.state)
            trainer.adopt_state(restored)
            start_epoch = int(extra.get("epoch", 0))
            print(f"resumed from epoch {start_epoch} ({os.path.basename(ckpt)})")
        elif resolve_checkpoint(pretrained):
            restored, _ = restore_checkpoint(pretrained, trainer.state)
            trainer.adopt_state(restored)
            skip_pretrain = True
            print("resumed from net_pretrained (no train-phase checkpoint)")

    if args.training_wheels == "y":
        print("training wheels: smoke run, 1 pretrain + 1 train epoch")
        result = trainer.fit(epochs=1, epochs_pretrain=1, eval_every=1)
    else:
        result = trainer.fit(eval_every=args.eval_every, start_epoch=start_epoch,
                             skip_pretrain=skip_pretrain)

    viz_nodes = None
    if args.final_viz_nodes:
        names = {n: i for i, n in enumerate(tree.node_names)}
        viz_nodes = [names[n] for n in args.final_viz_nodes.split(",") if n in names]
    if args.final_viz == "y" and (viz_nodes is not None or len(loaders.classes) <= 60):
        gallery_dir = os.path.join(cfg.log_dir, args.dir_for_saving_images)
        final_galleries(model, tree, loaders.project, gallery_dir,
                        image_size=cfg.model.image_size, nodes=viz_nodes)
        print(f"prototype galleries written to {gallery_dir}")

    mins = (time.time() - t_start) / 60.0
    print(f"done in {mins:.1f} min; eval: {result.get('eval')}")
    return 0


def final_galleries(model, tree, loader, gallery_dir: str, *, image_size: int,
                    nodes=None) -> list:
    """The galleries a run draws at its end (ref main.py:835-866): one
    projection over ``loader`` (K1 on the card); without ``nodes``, every
    prototype's top-10 patch grid (``save_topk_gallery``); and the per-node
    hierarchical galleries with real activation-map overlays
    (``save_hierarchy_galleries`` under ``<gallery_dir>/hierarchy``, its
    heatmaps re-forwarded through K1) for ``nodes`` (node indices), or for
    every node.  Returns the paths written."""
    import torch

    from .interp import (run_projection, save_hierarchy_galleries, save_topk_gallery,
                         topk_per_prototype)
    from .interp.hierarchy_viz import make_heatmap_forward
    proj = run_projection(model, tree, loader, image_size=image_size)
    written = []
    if nodes is None:
        written += save_topk_gallery(proj, topk_per_prototype(proj, k=10), gallery_dir)
    with torch.no_grad():
        w_eff = model.head.effective_cls_weight().float().cpu().numpy()
        presence = model.head.proto_presence.float().cpu().numpy()
    written += save_hierarchy_galleries(
        proj, tree, w_eff, presence, os.path.join(gallery_dir, "hierarchy"), k=10,
        heatmap_forward=make_heatmap_forward(model, tree, proj), nodes=nodes)
    return written


if __name__ == "__main__":
    sys.exit(run_pipnet())
