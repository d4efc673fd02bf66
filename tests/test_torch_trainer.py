"""The port's ``Trainer`` against the JAX package's, on the CPU at a small
size: a narrow ConvNeXt (``small_backbones``), 32^2 images and the
``synthetic:8:8`` fixture (8 classes, 64 training images).

- schedule: both trainers' ``fit`` with the step replaced by a recorder
  that does no model compute, through pretraining, finetune-classifier,
  finetune, the frozen and unfrozen joint phases (with the unfreeze
  warm-up) and mask-only; every step's statics, scalars, dataset rows and
  labels, and where the optimizer is reset, the checkpoints are written
  and the evaluations run, are equal;
- the CSV and JSONL files two ``_log_epoch``s write from the same epoch
  record are byte for byte equal;
- the eval step against the JAX one on the same weights (within 1e-5 in
  f32), and ``Trainer.evaluate``'s top-1 and top-5 counts against the JAX
  ``Trainer.evaluate`` on the same loader (equal); the decode options and
  the rest of evaluation are in ``test_torch_eval.py``;
- resume: a run stopped after epoch E and resumed from its checkpoint ends
  bit for bit where the uninterrupted run does; a save cut between its
  writes leaves the previous checkpoint restorable; without a cut save,
  saving and finding checkpoints load and hash nothing;
- the profiling helpers: a span lands in the trace.

No JAX ``fit`` takes a real step here (those tests are ``slow`` in
``tests/test_train.py``).
"""

import dataclasses
import filecmp
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.trainer as jax_trainer
import pipnet_tpu_torch.train.trainer as port_trainer
from torch_port_util import FLAGSHIP_META, SMALL_DEPTHS, SMALL_DIMS, small_backbones, to_jax

S, B, B_PRE = 32, 4, 6
FIXTURE = "synthetic:8:8"


def _configs(unfreeze_warmup_epochs=0.0, **train):
    """(JAX RunConfig, port RunConfig): the flagship run config in f32 at
    32^2, batch 4 (6 pretraining), one device, mask-prune from epoch 4,
    with ``train`` applied."""
    from pipnet_tpu.run_io import load_run_config as jax_load
    from pipnet_tpu_torch.run_io import load_run_config as port_load
    out = []
    for load in (jax_load, port_load):
        cfg = load(os.path.dirname(FLAGSHIP_META))
        optim = dataclasses.replace(cfg.train.optim,
                                    unfreeze_warmup_epochs=unfreeze_warmup_epochs)
        loss = dataclasses.replace(cfg.train.loss, mask_prune_start_epoch=4)
        t = dataclasses.replace(cfg.train, batch_size=B, batch_size_pretrain=B_PRE,
                                data_parallel=1, optim=optim, loss=loss, **train)
        out.append(dataclasses.replace(
            cfg, train=t, model=dataclasses.replace(cfg.model, image_size=S,
                                                    compute_dtype="float32",
                                                    use_pallas_head=False)))
    return tuple(out)


def _loaders(pkg):
    """``pkg``'s loaders and phylogeny on the fixture, as its CLI builds them
    with ``--device_augment full``."""
    import importlib
    data = importlib.import_module(f"{pkg}.data")
    datasets = importlib.import_module(f"{pkg}.datasets")
    train_dir, test_dir, _, dkw = datasets.resolve_dataset(FIXTURE)
    loaders = data.build_loaders(train_dir, test_dir, image_size=S, batch_size=B,
                                 batch_size_pretrain=B_PRE, seed=1, num_workers=1,
                                 device_photometric=True, device_geometric=True)
    return loaders, dkw["phylo_path"]


def _models(jcfg, tcfg, jloaders, tloaders, phylo):
    """Both packages' narrow models on the fixture's tree, the port's with
    seeded weights; (JAX model, JAX tree, port model, port tree, weights in
    the JAX layout)."""
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu.tree import build_tree_from_config as jax_tree
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.tree import build_tree_from_config as port_tree
    with small_backbones():
        mj, tj = jax_build(jax_tree(phylo, None), jcfg.model,
                           weighted=jcfg.train.loss.weighted_ce, class_names=jloaders.classes)
        mt, tt = build_pipnet(port_tree(phylo, None), tcfg.model,
                              weighted=tcfg.train.loss.weighted_ce,
                              class_names=tloaders.classes, device="cpu")
    params = random_jax_params(tcfg.model, tt, seed=5, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    return mj, tj, mt, tt, params


# -- schedule parity -------------------------------------------------------

SCHEDULE = dict(epochs=6, epochs_pretrain=2, epochs_finetune_classifier=1, epochs_finetune=2,
                freeze_epochs=3, epochs_finetune_mask_prune=5, unfreeze_warmup_epochs=1.5)


def _jax_recorder(events, num_nodes):
    def get_step(self, statics):
        def raw(state, xs1, xs2, ys, scalars, acc=None):
            n = jnp.int32(ys.shape[0])
            m = {"loss": jnp.float32(1.0), "fine_correct": n, "n_fine": n,
                 "node_correct": jnp.zeros(num_nodes, jnp.int32),
                 "node_examples": jnp.ones(num_nodes, jnp.int32)}
            if acc is not None:
                m = jax.tree_util.tree_map(lambda a, b: a + b.astype(a.dtype), acc, m)
            return state, m

        def step(state, xs1, xs2, ys, scalars, acc=None):
            events.append(("step", dataclasses.asdict(statics), np.asarray(scalars.vec),
                           np.asarray(xs1), np.asarray(ys)))
            return raw(state, xs1, xs2, ys, scalars, acc)
        return step, raw
    return get_step


def _port_recorder(events, num_nodes):
    def get_step(self, statics):
        def step(state, xs1, xs2, ys, scalars, acc=None):
            events.append(("step", dataclasses.asdict(statics),
                           np.asarray(dataclasses.astuple(scalars), np.float32),
                           xs1.numpy(), ys.numpy()))
            n = torch.tensor(ys.shape[0])
            m = {"loss": torch.tensor(1.0), "fine_correct": n, "n_fine": n,
                 "node_correct": torch.zeros(num_nodes, dtype=torch.int64),
                 "node_examples": torch.ones(num_nodes, dtype=torch.int64)}
            if acc is not None:
                m = {k: acc[k] + v for k, v in m.items()}
            return state, m
        return step
    return get_step


def _record_fit(monkeypatch, module, trainer, recorder, fit_kw, events):
    """``trainer.fit(**fit_kw)`` with the step, the checkpoint writes, the
    optimizer reset, the evaluation and the learning-rate plots recorded
    instead of run."""
    cls = module.Trainer
    monkeypatch.setattr(cls, "_get_step", recorder)
    monkeypatch.setattr(cls, "_save_lr_curves", lambda self, n: events.append(("lr_curves", n)))
    monkeypatch.setattr(cls, "evaluate", lambda self, loader, **kw: (
        events.append(("eval",)), {"top1": 0.5, "top5": 1.0, "n": 4})[1])
    monkeypatch.setattr(module, "reinit_optimizer",
                        lambda state: (events.append(("reinit",)), state)[1])
    def save(name, **meta):
        events.append(("save", name, meta["epoch"], meta["phase"]))
    # the port's Trainer saves through its run log (only rank 0 writes)
    if module is port_trainer:
        monkeypatch.setattr(trainer.log, "save_checkpoint",
                            lambda name, *a, **meta: save(name, **meta))
    else:
        monkeypatch.setattr(module, "save_checkpoint",
                            lambda d, name, *a, **meta: save(name, **meta))
    trainer.checkpoint_every = 2
    trainer.fit(eval_every=2, save_every=3, **fit_kw)


@pytest.fixture(scope="module")
def fixture_loaders():
    return _loaders("pipnet_tpu"), _loaders("pipnet_tpu_torch")


@pytest.mark.parametrize("fit_kw", [{}, {"start_epoch": 3}, {"skip_pretrain": True}],
                         ids=["fresh", "resume_epoch_3", "skip_pretrain"])
def test_fit_schedule_matches_jax(monkeypatch, tmp_path, fixture_loaders, fit_kw):
    from pipnet_tpu.data.device_cache import DeviceDataCache as JaxCache
    from pipnet_tpu.runtime.log import RunLog as JaxLog
    from pipnet_tpu.train.step import TrainState as JaxState
    from pipnet_tpu_torch.data.device_cache import DeviceDataCache as PortCache
    from pipnet_tpu_torch.runtime.log import RunLog as PortLog
    (jloaders, phylo), (tloaders, _) = fixture_loaders
    jcfg, tcfg = _configs(**SCHEDULE)
    mj, tj, mt, tt, _ = _models(jcfg, tcfg, jloaders, tloaders, phylo)
    # the caches hand the step the dataset rows instead of the images
    monkeypatch.setattr(JaxCache, "gather", lambda self, rows: rows)
    monkeypatch.setattr(PortCache, "fetch", lambda self, rows: torch.from_numpy(rows))
    runs = {}
    for name, module, model, tree, cfg, loaders, log, recorder in (
            ("jax", jax_trainer, mj, tj, jcfg, jloaders, JaxLog, _jax_recorder),
            ("port", port_trainer, mt, tt, tcfg, tloaders, PortLog, _port_recorder)):
        events = []
        trainer = module.Trainer(model, tree, cfg, loaders,
                                 log=log(str(tmp_path / name)))
        trainer.state = (JaxState(params={}, batch_stats={}, opt=(), rng=jnp.zeros(2, jnp.uint32))
                         if name == "jax" else types.SimpleNamespace(params={}))
        _record_fit(monkeypatch, module, trainer, recorder(events, tree.num_nodes), fit_kw,
                    events)
        runs[name] = events
    jax_events, port_events = runs["jax"], runs["port"]
    assert [e[0] for e in port_events] == [e[0] for e in jax_events]
    phases = set()
    for i, (want, got) in enumerate(zip(jax_events, port_events)):
        if want[0] != "step":
            assert got == want, i
            continue
        assert got[1] == want[1], i                       # statics
        np.testing.assert_array_equal(got[2], want[2], err_msg=f"scalars of step {i}")
        np.testing.assert_array_equal(got[3], want[3], err_msg=f"rows of step {i}")
        np.testing.assert_array_equal(got[4], want[4], err_msg=f"labels of step {i}")
        phases.add(got[1]["phase"]["name"])
    steps = [e for e in port_events if e[0] == "step"]
    if not fit_kw:
        assert phases == {"pretrain", "finetune_classifier", "finetune", "train", "mask_only"}
        # the warm-up ramp's statics and a mask-prune epoch are among them
        assert {s[1]["backbone_warmup_steps"] for s in steps} == {0.0, 1.5 * len(tloaders.train)}
        assert any(s[1]["mask_prune_active"] for s in steps)
    assert ("reinit",) in port_events or fit_kw.get("start_epoch")
    assert ("save", "net_trained_last", 6, "train") in port_events


# -- CSV and JSONL files ---------------------------------------------------

def test_log_epoch_files_match_jax(tmp_path):
    from pipnet_tpu.runtime.log import RunLog as JaxLog
    from pipnet_tpu_torch.runtime.log import RunLog as PortLog
    from torch_port_util import MULTI_NEWICK, compiled_pair
    tj, tt = compiled_pair(MULTI_NEWICK)
    r = np.random.default_rng(3)
    N = tt.num_nodes
    info = {"loss": 3.25, "loss/total": 3.25, "loss/class": 0.8125, "grad_norm": 1.5,
            "fine_accuracy": 0.3125, "images_per_sec": 417.123456, "epoch_seconds": 3.5,
            "host_rss_mb": 1024.25, "nonzero_protos": 120.0, "nonzero_connections": 300.0,
            "net_t_end": 32,
            "node_accuracy": r.uniform(0, 1, N),
            "per_node": {f"per_node/{k}_per_node": r.standard_normal(N).astype(np.float32)
                         for k in ("class", "tanh_desc", "align_pf")}}
    dirs = []
    for name, cls, log in (("jax", jax_trainer.Trainer, JaxLog),
                           ("port", port_trainer.Trainer, PortLog)):
        d = tmp_path / name
        me = types.SimpleNamespace(log=log(str(d)), tree=tj if name == "jax"
                                   else tt, history=[], NODE_LOSS_COLS=cls.NODE_LOSS_COLS)
        for split, epoch in (("pretrain", 1), ("train", 2), ("train", 3)):
            cls._log_epoch(me, split, epoch, info)
        dirs.append(d)
    files = sorted(os.path.relpath(os.path.join(p, f), dirs[1])
                   for p, _, fs in os.walk(dirs[1]) for f in fs if not f.startswith("."))
    want = sorted(os.path.relpath(os.path.join(p, f), dirs[0])
                  for p, _, fs in os.walk(dirs[0]) for f in fs if not f.startswith("."))
    assert files == want
    assert len([f for f in files if f.startswith("node_wise_metrics_train/")]) == N
    match, mismatch, errors = filecmp.cmpfiles(dirs[0], dirs[1], files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# -- eval ------------------------------------------------------------------

def test_eval_step_matches_jax():
    from pipnet_tpu.train.step import make_eval_step as jax_eval_step
    from pipnet_tpu_torch.train import make_eval_step
    from test_torch_train_step import _models as step_models
    _, _, mj, tj, mt, tt, params = step_models()
    xs = np.random.default_rng(4).standard_normal((3, 48, 48, 3)).astype(np.float32)
    with small_backbones():
        want = jax_eval_step(mj, tj)(to_jax(params), {}, jnp.asarray(xs),
                                     jnp.zeros(3, jnp.int32), jax.random.PRNGKey(0))
    got = make_eval_step(mt, tt)(torch.from_numpy(xs))
    assert set(got) == set(want)
    for k in ("logits", "pooled", "log_joint"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))
    assert not got["logits"].requires_grad


@pytest.mark.parametrize("tied", [False, True], ids=["seeded", "tied"])
def test_evaluate_counts_match_jax(fixture_loaders, tied):
    """Top-1 and top-5 counts over the fixture's test loader (from each
    package's eval cache) are the JAX trainer's.  ``tied``: with the add-on
    kernel zeroed every pooled value falls under the 0.1 inference cut, all
    children of a node tie, and leaves share their log probability: the
    case the counting rule exists for."""
    from pipnet_tpu.train.optimizer import adam_init
    from pipnet_tpu.train.step import TrainState as JaxState
    from pipnet_tpu_torch.models import params_from_jax
    from pipnet_tpu_torch.train import init_train_state
    (jloaders, phylo), (tloaders, _) = fixture_loaders
    jcfg, tcfg = _configs()
    mj, tj, mt, tt, params = _models(jcfg, tcfg, jloaders, tloaders, phylo)
    if tied:
        params["head"]["add_on_kernel"] = np.zeros_like(params["head"]["add_on_kernel"])
        mt.load_state_dict(params_from_jax(params))
    jt = jax_trainer.Trainer(mj, tj, jcfg, jloaders, log=types.SimpleNamespace())
    jt.state = JaxState(params=to_jax(params), batch_stats={}, opt=adam_init(to_jax(params)),
                        rng=jax.random.PRNGKey(0))
    with small_backbones():
        want = jt.evaluate(jloaders.test)
    pt = port_trainer.Trainer(mt, tt, tcfg, tloaders, log=types.SimpleNamespace())
    pt.state = init_train_state(mt)
    got = pt.evaluate(tloaders.test)
    assert got == want
    assert got["n"] == len(tloaders.test.dataset)
    xs = pt.device_cache_for(tloaders.test).fetch(np.arange(8))
    logp = pt.eval_step(xs)["log_joint"]
    assert any(len(torch.unique(row)) < row.numel() for row in logp) == tied


def test_topk_counts_rank_ties_by_lower_index():
    from pipnet_tpu_torch.train.trainer import _topk_counts
    logp = torch.tensor([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [-2.0, -1.0, 0.0]])
    got = _topk_counts(logp, torch.tensor([1, 1, 0]), k=2)
    want = np.zeros(3, np.int64)
    _, top = jax.lax.top_k(jnp.asarray(logp.numpy()), 2)
    ys = np.asarray([1, 1, 0])
    want[0] = int((np.asarray(top[:, 0]) == ys).sum())
    want[1] = int((np.asarray(top) == ys[:, None]).any(axis=1).sum())
    want[2] = 3
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == 1 and want[1] == 2


# -- resume and crash-safe checkpoints -------------------------------------

RESUME = dict(epochs=4, epochs_pretrain=1, epochs_finetune_classifier=1, epochs_finetune=2,
              freeze_epochs=3, unfreeze_warmup_epochs=1.0)
STOP_AFTER = 2


def _port_trainer(log_dir, loaders, phylo):
    from pipnet_tpu_torch.models import build_pipnet
    from pipnet_tpu_torch.runtime.log import RunLog
    from pipnet_tpu_torch.tree import build_tree_from_config
    _, tcfg = _configs(**RESUME)
    with small_backbones():
        model, tree = build_pipnet(build_tree_from_config(phylo, None), tcfg.model,
                                   weighted=tcfg.train.loss.weighted_ce,
                                   class_names=loaders.classes, device="cpu")
    trainer = port_trainer.Trainer(model, tree, tcfg, loaders, log=RunLog(str(log_dir)))
    trainer.init_state()
    return trainer


def _final(trainer):
    st = trainer.state
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in st.opt.mu.items()},
            {k: v.clone() for k, v in st.opt.nu.items()}, dict(st.opt.count),
            st.generator.get_state().clone())


def test_resumed_fit_equals_uninterrupted(monkeypatch, tmp_path, fixture_loaders):
    from pipnet_tpu_torch.train import latest_train_checkpoint, restore_checkpoint
    _, (loaders, phylo) = fixture_loaders
    whole = _port_trainer(tmp_path / "whole", loaders, phylo)
    whole.fit(eval_every=2)
    want = _final(whole)

    cut = _port_trainer(tmp_path / "cut", loaders, phylo)
    run_epoch = port_trainer.Trainer.run_epoch

    def stop(self, epoch, *, pretrain, **kw):
        if not pretrain and epoch > STOP_AFTER:
            raise KeyboardInterrupt
        return run_epoch(self, epoch, pretrain=pretrain, **kw)
    monkeypatch.setattr(port_trainer.Trainer, "run_epoch", stop)
    with pytest.raises(KeyboardInterrupt):
        cut.fit(eval_every=2)
    monkeypatch.setattr(port_trainer.Trainer, "run_epoch", run_epoch)

    resumed = _port_trainer(tmp_path / "cut", loaders, phylo)
    path, meta = latest_train_checkpoint(str(tmp_path / "cut" / "checkpoints"))
    assert os.path.basename(path) == "net_trained" and meta == {"epoch": STOP_AFTER,
                                                                "phase": "train"}
    state, _ = restore_checkpoint(path, resumed.state)
    resumed.adopt_state(state)
    resumed.fit(eval_every=2, start_epoch=meta["epoch"])
    got = _final(resumed)
    for w, g in zip(want[:3], got[:3]):
        assert w.keys() == g.keys()
        for k in w:
            assert torch.equal(w[k], g[k]), k
    assert got[3] == want[3]
    assert torch.equal(got[4], want[4])
    assert any(torch.any(v != 0) for v in got[1].values())


def test_interrupted_save_keeps_the_previous_checkpoint(monkeypatch, tmp_path,
                                                        fixture_loaders):
    import pipnet_tpu_torch.train.checkpoint as ckpt
    _, (loaders, phylo) = fixture_loaders
    trainer = _port_trainer(tmp_path, loaders, phylo)
    d, model, state = trainer.log.checkpoint_dir, trainer.model, trainer.state
    ckpt.save_checkpoint(d, "net_trained", model, state, epoch=1, phase="train")
    first = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    state.opt.count = {k: c + 7 for k, c in state.opt.count.items()}

    # cut after the weights were written, before the state file (the commit)
    write = ckpt._write

    def die_on_state(path, data):
        if path.endswith(ckpt.STATE + ".new"):
            raise OSError("disk gone")
        write(path, data)
    monkeypatch.setattr(ckpt, "_write", die_on_state)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(d, "net_trained", model, state, epoch=2, phase="train")
    monkeypatch.setattr(ckpt, "_write", write)
    assert os.path.exists(os.path.join(d, "net_trained.pt.new"))
    assert ckpt.checkpoint_meta(os.path.join(d, "net_trained")) == {"epoch": 1,
                                                                    "phase": "train"}
    restored, meta = ckpt.restore_checkpoint(os.path.join(d, "net_trained"), state)
    assert meta["epoch"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, first[k]), k
    assert set(restored.opt.count.values()) == {0}
    with open(os.path.join(d, "net_trained.pt"), "rb") as f:
        served = torch.load(f, weights_only=True)
    assert all(torch.equal(served[k], first[k]) for k in first)

    # cut between the two swaps: the finished save wins
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    replace = os.replace

    def die_on_state_swap(src, dst):
        if dst.endswith(ckpt.STATE):
            raise OSError("power cut")
        replace(src, dst)
    monkeypatch.setattr(ckpt.os, "replace", die_on_state_swap)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(d, "net_trained", model, state, epoch=3, phase="train")
    monkeypatch.setattr(ckpt.os, "replace", replace)
    second = {k: v.clone() for k, v in model.state_dict().items()}
    assert ckpt.checkpoint_meta(os.path.join(d, "net_trained"))["epoch"] == 3
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    _, meta = ckpt.restore_checkpoint(os.path.join(d, "net_trained"), state)
    assert meta["epoch"] == 3
    assert all(torch.equal(v, second[k]) for k, v in model.state_dict().items())
    # the next save promotes the finished one before writing its own
    ckpt.save_checkpoint(d, "net_trained_last", model, state, epoch=3, phase="train")
    ckpt.save_checkpoint(d, "net_trained", model, state, epoch=4, phase="train")
    assert sorted(os.listdir(d)) == ["net_trained.pt", "net_trained.state.pt",
                                     "net_trained_last.pt", "net_trained_last.state.pt"]
    assert ckpt.latest_train_checkpoint(d)[1]["epoch"] == 4


def test_latest_train_checkpoint_prefers_newest_epoch_then_rolling(tmp_path, fixture_loaders):
    from pipnet_tpu_torch.train import checkpoint_meta, latest_train_checkpoint, save_checkpoint
    _, (loaders, phylo) = fixture_loaders
    trainer = _port_trainer(tmp_path, loaders, phylo)
    d = trainer.log.checkpoint_dir
    assert latest_train_checkpoint(d) == (None, {})
    for name, epoch in (("net_trained", 10), ("net_trained_20", 20), ("net_pretrained", 0)):
        save_checkpoint(d, name, trainer.model, trainer.state, epoch=epoch, phase="train")
    path, meta = latest_train_checkpoint(d)
    assert os.path.basename(path) == "net_trained_20" and meta["epoch"] == 20
    save_checkpoint(d, "net_trained", trainer.model, trainer.state, epoch=20, phase="train")
    assert os.path.basename(latest_train_checkpoint(d)[0]) == "net_trained"
    assert checkpoint_meta(os.path.join(d, "missing")) is None


def test_load_backbone_only_keeps_the_fresh_head(tmp_path, fixture_loaders):
    from pipnet_tpu_torch.train import load_backbone_only, save_checkpoint
    _, (loaders, phylo) = fixture_loaders
    trainer = _port_trainer(tmp_path, loaders, phylo)
    model = trainer.model
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    save_checkpoint(trainer.log.checkpoint_dir, "net_trained", model, trainer.state,
                    epoch=3, phase="train")
    trainer.init_state()
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    load_backbone_only(os.path.join(trainer.log.checkpoint_dir, "net_trained"), trainer.state)
    for k, v in model.state_dict().items():
        if k.startswith("backbone.") or k == "head.add_on_kernel":
            assert torch.equal(v, saved[k]), k
        elif k == "head.multiplier":
            assert torch.equal(v, torch.full_like(v, 2.0))
        else:
            assert torch.equal(v, fresh[k]), k


def test_uncut_checkpoints_are_found_without_loading_or_hashing(monkeypatch, tmp_path,
                                                                fixture_loaders):
    """Without a save cut by a crash (no ``.new`` file), a save reads no
    earlier checkpoint and hashes nothing, and finding the newest one reads
    only its metadata, from a memory map; the Trainer times each save."""
    import pipnet_tpu_torch.train.checkpoint as ckpt
    _, (loaders, phylo) = fixture_loaders
    trainer = _port_trainer(tmp_path, loaders, phylo)
    d = trainer.log.checkpoint_dir
    trainer._save("net_trained", epoch=1, phase="train")
    loads, hashes = [], []
    load, sha = ckpt._load, ckpt._sha256
    monkeypatch.setattr(ckpt, "_load", lambda p, mmap=False: (
        loads.append((os.path.basename(p), mmap)), load(p, mmap))[1])
    monkeypatch.setattr(ckpt, "_sha256", lambda p: (hashes.append(p), sha(p))[1])
    trainer._save("net_trained", epoch=2, phase="train")
    trainer._save("net_trained_2", epoch=2, phase="train")
    assert loads == [] and hashes == []
    path, meta = ckpt.latest_train_checkpoint(d)
    assert os.path.basename(path) == "net_trained" and meta == {"epoch": 2, "phase": "train"}
    assert sorted(loads) == [("net_trained.state.pt", True), ("net_trained_2.state.pt", True)]
    assert hashes == []
    assert [n for n, _ in trainer.save_seconds] == ["net_trained", "net_trained",
                                                    "net_trained_2"]
    assert all(s > 0 for _, s in trainer.save_seconds)


def test_trace_holds_annotated_regions(tmp_path):
    """A span inside ``trace`` is a region of the written trace, around
    the operations run in it."""
    from pipnet_tpu_torch.runtime import span, trace
    with trace(str(tmp_path / "t")):
        with span("backbone"):
            torch.ones(8).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    region = next(e for e in events if e.get("name") == "backbone")
    inner = next(e for e in events if e.get("name") == "aten::sum")
    assert region["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= region["ts"] + region["dur"]
