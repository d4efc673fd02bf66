"""The PyTorch port's command line: the reference-flag-compatible training
entry point (the counterpart of the JAX package's ``main.py``).

``python -m pipnet_tpu_torch.main --dataset synthetic --phylo_config auto ...``

Accepts the JAX package's flags, defaults and the reference's string DSLs
(``util/args.py:14-402``), so the ``scripts/runs/run_*.sh`` invocations
translate directly, and resolves them once into the static ``RunConfig``.
Training runs on the card unless ``--device cpu`` asks for the CPU.

``--data_parallel N`` (0, the default: every local card; one process on
the CPU) trains on a data mesh of N ranks (``runtime/mesh.py``), one
process a rank: this command starts them itself (``launch_ranks``: rank r
on card r, or N processes on the CPU, joined through gloo; a rendezvous
file in a fresh temporary directory), or ``torchrun --nproc_per_node N -m
pipnet_tpu_torch.main ...`` starts them (NCCL on cards, gloo on the CPU).
Every rank trains the same numbers; rank 0 writes the run directory.
``--zero1 y`` splits the Adam moments over the data ranks.
``--model_parallel M`` adds a model axis: N * M ranks (``launch_ranks`` or
``torchrun`` start them; ``--data_parallel 0`` then means the ranks over
M, one data rank on the CPU), each holding its columns of the head's
stacked prototype axis (``runtime/mesh.py``); the head runs its composed
operations there, and ``--use_pallas_head y`` with it raises the JAX
package's refusal.  ``--minmaximize y`` raises, as the JAX package refuses
it too.  Every backbone of the JAX package
(``--net``), ``--byol y``, the default ``--align y --uni y`` losses, the
head variants, ``--OOD_dataset`` (its train loader feeds OOD rows into
every phase-2 step) and ``--stage4_reducer_net`` train.  After training,
``--final_viz y`` draws the prototype galleries (``final_galleries``): for
60 classes or fewer, or for the nodes of ``--final_viz_nodes``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time

# the rendezvous a rank started by ``launch_ranks`` joins (torchrun's ranks
# join through env://)
RENDEZVOUS_ENV = "PIPNET_RANKS_RENDEZVOUS"


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
    # extensions of the JAX package: the mesh (runtime/mesh.py)
    add("--data_parallel", type=int, default=0,
        help="data-parallel shards: 0 = all visible devices (the port: one "
             "process a rank; every local card, or one process on the CPU)")
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
    """Raise, before any work, on the flags the JAX package refuses:
    ``--model_parallel`` above 1 with ``--use_pallas_head y`` (its Trainer's
    refusal) and ``--minmaximize y`` (at its first step)."""
    if args.state_dict_dir_net:
        raise ValueError("use --state_dict_dir_backbone (the reference forbids "
                         "state_dict_dir_net too, main.py:291)")
    if args.minmaximize[:1] == "y":
        from .losses.aggregate import MINMAXIMIZE_REFUSAL
        raise NotImplementedError(f"--minmaximize y: {MINMAXIMIZE_REFUSAL}")
    if args.model_parallel > 1 and args.use_pallas_head == "y":
        from .train.trainer import PALLAS_HEAD_REFUSAL
        raise ValueError(PALLAS_HEAD_REFUSAL)


def launch_ranks(argv, world: int) -> int:
    """Run the command line ``argv`` on ``world`` local processes, the ranks
    of one mesh (rank r on card r of a card run), joined through a
    rendezvous file in a fresh temporary directory.  Rank 0 prints; the
    others' output is dropped, their errors are not.  Returns 0 when every
    rank does; when one fails the others are stopped and this raises."""
    tmp = tempfile.mkdtemp(prefix="pipnet_ranks_")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join([root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                       PYTHONPATH=path,
                       **{RENDEZVOUS_ENV: "file://" + os.path.join(tmp, "rendezvous")})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pipnet_tpu_torch.main", *argv], env=env,
                stdout=None if r == 0 else subprocess.DEVNULL))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {world} exited {failed[0][1]}")
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_pipnet(argv=None) -> int:
    """Train from the command line ``argv``.  ``sys.stdout`` is duplicated
    into ``<log_dir>/out.txt`` while the run lasts and restored when it
    returns or raises.  With more than one rank (data times model ranks),
    either this process is a rank (``WORLD_SIZE`` set, by ``torchrun`` or
    ``launch_ranks``) or it starts the ranks (``launch_ranks``) and trains
    nothing itself."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    _refuse_unported(args)
    from .config import from_reference_flags
    from .device import resolve_device
    from .runtime.log import Tee, open_run_log
    from .runtime.mesh import close_ranks, data_mesh, dp_mp_mesh, init_ranks

    dev = resolve_device(args.device)
    n_model = max(args.model_parallel, 1)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if world % n_model or args.data_parallel not in (0, world // n_model):
            raise ValueError(f"--data_parallel {args.data_parallel} --model_parallel "
                             f"{n_model} in a process group of {world} ranks")
        if dev.type == "cuda":
            dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    else:
        import torch
        n_data = args.data_parallel or max(
            (torch.cuda.device_count() if dev.type == "cuda" else 1) // n_model, 1)
        world = n_data * n_model
        if world > 1:
            return launch_ranks(argv, world)

    cfg = from_reference_flags(args)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype=args.compute_dtype,
                                  fast_gelu=args.fast_gelu == "y",
                                  use_pallas_head=args.use_pallas_head == "y",
                                  use_pallas_backbone=args.use_pallas_backbone == "y"),
        train=dataclasses.replace(cfg.train, data_parallel=world // n_model,
                                  model_parallel=n_model, zero1=args.zero1 == "y"))
    mesh = None
    if world > 1:
        init_ranks(world, int(os.environ["RANK"]), dev,
                   init_method=os.environ.get(RENDEZVOUS_ENV, "env://"))
        mesh = (dp_mp_mesh(world // n_model, n_model, device=dev) if n_model > 1
                else data_mesh(world, device=dev))
    try:
        log = open_run_log(cfg.log_dir, 0 if mesh is None else mesh.rank)
        if not log.writes:
            return _train(args, cfg, log, dev, mesh)
        stdout = sys.stdout
        tee = Tee(os.path.join(cfg.log_dir, "out.txt"), stdout)
        sys.stdout = tee
        try:
            return _train(args, cfg, log, dev, mesh)
        finally:
            sys.stdout = stdout
            tee.close()
    finally:
        if mesh is not None:
            close_ranks()


def _train(args, cfg, log, dev, mesh=None) -> int:
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
    ranks = "" if mesh is None else f", rank {mesh.rank} of {mesh.world}"
    print(f"pipnet_tpu_torch: device={dev} ({name}), torch {torch.__version__}{ranks}")
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
    ood_loaders = None
    if cfg.ood_dataset:
        otrain, otest, oproj, _ = resolve_dataset(cfg.ood_dataset, seed=cfg.train.seed)
        ood_loaders = build_loaders(
            otrain, otest, project_dir=oproj, image_size=cfg.model.image_size,
            batch_size=cfg.train.batch_size,
            batch_size_pretrain=cfg.train.batch_size_pretrain,
            validation_size=cfg.validation_size, num_workers=cfg.num_workers,
            device_photometric=device_augment, device_geometric=device_geometric,
            seed=cfg.train.seed)

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
    log.save_tree_picture(root)

    # model
    model, tree = build_pipnet(root, cfg.model, weighted=cfg.train.loss.weighted_ce,
                               class_names=loaders.classes, device=dev)
    print(tree.summary())

    trainer = Trainer(model, tree, cfg, loaders, log=log, ood_loaders=ood_loaders, mesh=mesh)
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
    if log.writes and args.final_viz == "y" and (viz_nodes is not None
                                              or len(loaders.classes) <= 60):
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
