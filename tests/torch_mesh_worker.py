"""One rank of the port's multi-process mesh tests (``tests/test_torch_mesh*.py``).

``python tests/torch_mesh_worker.py cli JOB RANK WORLD`` runs the training
CLI as one rank (``run_cli``).  ``python tests/torch_mesh_worker.py JOB
RANK WORLD`` joins a gloo process
group of WORLD ranks on the CPU (a ``FileStore`` beside JOB, with the job's
timeout), runs every train-step run of JOB (a pickle the test wrote) on
``dp_mp_mesh(WORLD / M, M)`` (M the job's ``n_model``, 1 by default) with
this rank's rows of each global batch, and writes
``JOB.rank<RANK>`` (a pickle) with each run's metrics, gradients, weights,
whole Adam moments and generator state (or, for a ``backbone64`` run,
ResNet-18's features and gradients in float64).  The same functions with
no mesh are the one-process step the tests hold these against.  Imports
the port only.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle
import sys

import torch

SMALL_DEPTHS = (1, 1, 2, 1)
SMALL_DIMS = (8, 16, 32, 64)


@contextlib.contextmanager
def port_backbone(spec):
    """``spec`` None leaves the configured backbone as it is; ``("convnext",
    p)`` points ``convnext_tiny_26`` at the narrow ConvNeXt of
    ``torch_port_util`` (SMALL_DEPTHS / SMALL_DIMS, stride threshold 10)
    with stochastic depth ``p``."""
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny
    if spec is None:
        yield
        return
    _, sd_prob = spec
    old = tp.BACKBONES["convnext_tiny_26"]
    tp.BACKBONES["convnext_tiny_26"] = (functools.partial(
        ConvNeXtTiny, stride_threshold=10, depths=SMALL_DEPTHS, dims=SMALL_DIMS,
        stochastic_depth_prob=sd_prob), SMALL_DIMS[-1])
    try:
        yield
    finally:
        tp.BACKBONES["convnext_tiny_26"] = old


def build(run):
    """The run's model (its weights loaded, where the run has them) and
    compiled tree, on the CPU."""
    import pipnet_tpu_torch.tree as tt
    from pipnet_tpu_torch.models import build_pipnet
    root = tt.construct_phylo_tree(phylo=tt.Phylogeny(newick=run["newick"]))
    root.assign_all_descendents()
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=0, num_protos_per_child=run["per_child"],
                            min_protos=0, split_protos=True)
    with port_backbone(run["backbone"]):
        model, tree = build_pipnet(root, run["cfg"].model, weighted=True, device="cpu")
    if run["state_dict"] is not None:
        model.load_state_dict(run["state_dict"])
    return model, tree


def run_steps(run, mesh):
    """The run's steps from a fresh train state (seed 0), on ``mesh`` (this
    rank's rows; on a model axis the head's columns of this rank) or in one
    process (``mesh`` None).  Returns the metrics and the (all-reduced,
    unclipped, whole) gradients of each step, then the whole weights, the
    whole moments and counts, and the generator state."""
    from pipnet_tpu_torch.runtime.mesh import (PROTO_AXIS_PARAMS, on_axis, shard_batch,
                                               split_moments, state_shardings, whole_moments)
    from pipnet_tpu_torch.train import (Scalars, StepStatics, init_train_state,
                                        make_train_step, phase_for_epoch)
    model, tree = build(run)
    cfg = run["cfg"]
    columns = mesh is not None and mesh.n_model > 1
    if columns:
        model.head.shard_columns(mesh)
    state = init_train_state(model, seed=0)
    zero1 = run.get("zero1", False) and mesh is not None
    specs = state_shardings(mesh, state, zero1=zero1) if mesh is not None else None
    if zero1:
        state.opt = split_moments(mesh, state.opt, on_axis(specs, "data"))

    def whole_grad(n, g):
        if columns and n in PROTO_AXIS_PARAMS:
            return mesh.all_gather(g, dim=PROTO_AXIS_PARAMS[n], axis="model")
        return g
    out = {"metrics": [], "grads": []}
    for st in run["steps"]:
        epoch, pretrain, mask_prune = st["phase"]
        statics = StepStatics(phase=phase_for_epoch(epoch, cfg.train, pretrain=pretrain),
                              mask_prune_active=mask_prune, has_ood=st.get("has_ood", False),
                              eta_min_net=5e-6)
        step = make_train_step(model, tree, cfg, statics,
                               fuse_align_pf=run.get("fuse_align_pf", False), mesh=mesh,
                               zero1=zero1)
        xs1, xs2, ys = st["xs1"], st["xs2"], st["ys"]
        if mesh is not None:
            xs1, xs2, ys = shard_batch(mesh, xs1, xs2, ys)
        noise = st.get("noise")
        state, metrics = step(state, torch.from_numpy(xs1),
                              None if xs2 is None else torch.from_numpy(xs2),
                              torch.from_numpy(ys), Scalars(**st["scalars"]),
                              presence_noise=None if noise is None else torch.from_numpy(noise))
        out["metrics"].append({k: v.detach().numpy().copy() for k, v in metrics.items()})
        out["grads"].append({n: whole_grad(n, p.grad.detach()).numpy().copy()
                             for n, p in state.params.items() if p.grad is not None})
    opt = whole_moments(mesh, state.opt, specs) if zero1 or columns else state.opt
    out["local_mu"] = {n: tuple(t.shape) for n, t in state.opt.mu.items()}
    if columns:
        model.head.gather_columns()
    out["weights"] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    out["mu"] = {n: t.numpy().copy() for n, t in opt.mu.items()}
    out["nu"] = {n: t.numpy().copy() for n, t in opt.nu.items()}
    out["count"] = dict(opt.count)
    out["generator"] = state.generator.get_state().numpy().copy()
    return out


def run_backbone64(run, mesh):
    """ResNet-18's backbone alone in float64 on the run's global batch
    ``x`` (this rank's rows on ``mesh``, BatchNorm over the whole batch):
    the features, the gradients of sum(features * w) (summed over the
    ranks) and the running statistics after the forward."""
    from pipnet_tpu_torch.models.resnet import resnet18_features
    from pipnet_tpu_torch.runtime.mesh import BatchShard, shard_batch
    model = resnet18_features(dtype=torch.float64).double()
    model.load_state_dict(run["state_dict"])
    x, w, shard = run["x"], run["w"], None
    if mesh is not None:
        x, w = shard_batch(mesh, x, w)
        shard = BatchShard(mesh, views=1)
    y = model(torch.from_numpy(x), train=True, shard=shard)
    (y * torch.from_numpy(w)).sum().backward()
    params = dict(model.named_parameters())
    if mesh is not None:
        mesh.all_reduce_grads(params)
    return {"y": y.detach().numpy().copy(),
            "grads": {n: p.grad.numpy().copy() for n, p in params.items()},
            "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()}}


RUNNERS = {"steps": run_steps, "backbone64": run_backbone64}


class Stopped(Exception):
    """The run stopped where the job asked (a run cut short)."""


def run_cli(job_path: str, rank: int, world: int) -> int:
    """``run_pipnet(job["argv"])`` as rank ``rank`` of ``world`` (the
    environment ``launch_ranks`` gives a rank), with the narrow ConvNeXt
    (no stochastic depth) as ``convnext_tiny_26``.  With
    ``job["stop_after_epoch"]`` E the run stops right after its rolling
    checkpoint of epoch E is written, as a run cut short there."""
    from pipnet_tpu_torch.main import RENDEZVOUS_ENV, run_pipnet
    from pipnet_tpu_torch.train.trainer import Trainer
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      **{RENDEZVOUS_ENV: "file://" + job_path + ".store"})
    stop, save = job.get("stop_after_epoch"), Trainer._save

    def save_then_stop(self, name, **meta):
        save(self, name, **meta)
        if name == "net_trained" and meta.get("epoch") == stop:
            raise Stopped
    Trainer._save = save_then_stop
    try:
        with port_backbone(("convnext", 0.0)):
            return run_pipnet(job["argv"])
    except Stopped:
        return 0


def main(argv) -> int:
    if argv[0] == "cli":
        torch.set_num_threads(1)
        return run_cli(argv[1], int(argv[2]), int(argv[3]))
    job_path, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    from pipnet_tpu_torch.runtime.mesh import close_ranks, dp_mp_mesh, init_ranks
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    timeout = datetime.timedelta(seconds=job["timeout"])
    store = torch.distributed.FileStore(job_path + ".store", world)
    init_ranks(world, rank, "cpu", store=store, timeout=timeout)
    try:
        n_model = job.get("n_model", 1)
        mesh = dp_mp_mesh(world // n_model, n_model, device="cpu")
        results = {run["name"]: RUNNERS[run.get("kind", "steps")](run, mesh)
                   for run in job["runs"]}
    finally:
        close_ranks()
    tmp = f"{job_path}.rank{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, f"{job_path}.rank{rank}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
