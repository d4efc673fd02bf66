"""The port's evaluation path against the JAX package's, on the CPU at a
small size (narrow ConvNeXts, ``small_backbones``; the ``synthetic:8:8``
fixture at 32^2 for the passes over a loader).

- ``eval/metrics.py``: every function on seeded arrays (ints equal, floats
  within 1e-12);
- ``segment_hard_gumbel`` on one Gumbel sample: the mask bit for bit (the
  straight-through ``hard + y - y`` can sit one ulp below 1), gradients
  within 1e-6;
- the masked head and the degenerate-node verdict on one presence sample
  (presence logits set so that one node is degenerate and others are not):
  logits and pooled within 1e-5 in f32, the verdict equal;
- ``make_eval_step`` with each decode option and with all three: logits,
  pooled and log_joint within 1e-5 in f32, ``pred`` equal;
- ``Trainer.evaluate``'s counts on the fixture's test loader for the
  leave-out and the masked decodes (both packages handed the same
  per-batch samples), and ``evaluate_per_node``: equal;
- ``evaluate.run`` on one run directory holding both packages' checkpoints
  of the same weights: the same report keys, equal integers and top-k
  ratios, sparsity means within 1e-9;
- the ``interp/*`` flags (``--threshold_prune``, ``--prune_leaf_parents``,
  ``--part_purity_csv``, ``--galleries_nodes``) against the JAX package's
  report sections and files; the masked ``Predictor`` and the serve CLI's
  ``--mask_seed``.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.eval.metrics as jax_metrics
import pipnet_tpu.train.trainer as jax_trainer
import pipnet_tpu_torch.eval.metrics as port_metrics
import pipnet_tpu_torch.train.trainer as port_trainer
from test_torch_trainer import FIXTURE, _configs, _loaders, _models
from torch_port_util import small_backbones, to_jax

ATOL = 1e-5


@pytest.fixture(scope="module")
def fixture_loaders():
    return _loaders("pipnet_tpu"), _loaders("pipnet_tpu_torch")


def _valid_leave_out(tree, count):
    """The first ``count`` classes whose leave-out decode is defined."""
    from pipnet_tpu_torch.models.pipnet import leave_out_decode_tables
    out = []
    for i in range(tree.num_classes):
        try:
            leave_out_decode_tables(tree, out + [i])
        except ValueError:
            continue
        out.append(i)
        if len(out) == count:
            return out
    raise AssertionError("no leave-out set of that size")


# -- eval/metrics.py -------------------------------------------------------

def _metric_cases():
    from torch_port_util import MULTI_NEWICK, compiled_pair
    r = np.random.default_rng(21)
    tj, tt = compiled_pair(MULTI_NEWICK)
    L, C, P, B = tt.num_classes, tt.num_children_total, tt.num_protos_padded, 24
    scores = r.dirichlet(np.ones(L), B)
    ys = r.integers(0, L, B)
    ys[:8] = scores[:8].argmax(-1)                  # some correct predictions
    w = np.where(r.uniform(size=(C, P)) < 0.3, r.uniform(0, 1, (C, P)), 0.0).astype(np.float32)
    pooled = np.where(r.uniform(size=(B, P)) < 0.4, r.uniform(0, 1, (B, P)), 0.0).astype(np.float32)
    keep = (r.uniform(size=P) < 0.5).astype(np.float32)
    preds = r.integers(0, 3, 40)
    gts = r.integers(0, 3, 40)
    ood = r.dirichlet(np.ones(L) * 0.5, 16)
    return {
        "topk_accuracy": lambda m, t: m.topk_accuracy(scores, ys, (1, 3, 5, 100)),
        "sparsity_stats": lambda m, t: m.sparsity_stats(w, pooled),
        "pred_path_explanation_size": lambda m, t: m.pred_path_explanation_size(
            pooled, w, t.leaf_child_col, t.leaf_under_node, scores.argmax(-1)),
        "abstained_count": lambda m, t: m.abstained_count(scores - 0.2),
        "per_node_prf": lambda m, t: m.per_node_prf(preds, gts, 3),
        "ood_id_fraction": lambda m, t: m.ood_id_fraction(scores, ood, 0.2),
        "fpr95_threshold": lambda m, t: m.fpr95_threshold(scores, ys),
        "per_class_fpr95_thresholds": lambda m, t: m.per_class_fpr95_thresholds(scores, ys, L),
        "eval_ood": lambda m, t: m.eval_ood(scores, ys, ood, L),
        "degenerate_nodes_from_mask": lambda m, t: m.degenerate_nodes_from_mask(t, w, keep),
    }, tj, tt


METRICS = ["topk_accuracy", "sparsity_stats", "pred_path_explanation_size", "abstained_count",
           "per_node_prf", "ood_id_fraction", "fpr95_threshold", "per_class_fpr95_thresholds",
           "eval_ood", "degenerate_nodes_from_mask"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name):
    cases, tj, tt = _metric_cases()
    want, got = cases[name](jax_metrics, tj), cases[name](port_metrics, tt)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert type(got[k]) is type(want[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    elif isinstance(want, (int, np.ndarray)) and np.asarray(want).dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# -- segment_hard_gumbel ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_hard_gumbel_matches_jax(seed):
    from pipnet_tpu.ops.segment import segment_hard_gumbel as jax_hard
    from pipnet_tpu_torch.ops import segment_hard_gumbel
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((3840, 2)) * 3).astype(np.float32)
    wts = r.standard_normal((3840, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    want = np.asarray(jax_hard(jnp.asarray(logits), key))
    want_jit = np.asarray(jax.jit(jax_hard)(jnp.asarray(logits), key))
    want_grad = np.asarray(jax.grad(lambda l: (jax_hard(l, key) * wts).sum())(
        jnp.asarray(logits)))
    lt = torch.from_numpy(logits).requires_grad_()
    got = segment_hard_gumbel(lt, None, tau=0.5, noise=torch.from_numpy(noise))
    (got * torch.from_numpy(wts)).sum().backward()
    # the values: one-hot rows, some of them one ulp below 1, bit for bit
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(got.detach().numpy(), want_jit)
    assert ((want > 0) & (want < 1)).any()          # the ulp below 1 occurs here
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=0, atol=1e-6)


def test_exp_f32_is_the_jax_packages_exp():
    from pipnet_tpu_torch.ops.segment import _exp_f32
    r = np.random.default_rng(3)
    x = np.concatenate([r.uniform(-100, 0, 200_000), r.standard_normal(200_000) * 8,
                        [0.0, -87.8, -88.0, 88.7, -1e-30]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(_exp_f32(torch.from_numpy(x)).numpy(), want)


# -- the masked head and the degenerate-node verdict -----------------------

def _step_models_with_presence():
    """The train-step tests' narrow models (MULTI_NEWICK tree), with the
    presence logits set so that the first node's prototypes are all pruned
    (that node degenerate) and the others' kept."""
    from pipnet_tpu_torch.models import params_from_jax
    from test_torch_train_step import _models as step_models
    _, _, mj, tj, mt, tt, params = step_models()
    node0 = tt.proto_node == 0
    params["head"]["proto_presence"] = np.where(node0[:, None], [[10.0, -10.0]],
                                                [[-10.0, 10.0]]).astype(np.float32)
    mt.load_state_dict(params_from_jax(params))
    return mj, tj, mt, tt, params


def _jax_keep(params, key):
    from pipnet_tpu.ops.segment import segment_hard_gumbel
    return np.asarray(jax.jit(lambda p, k: segment_hard_gumbel(p, k)[:, 1])(
        jnp.asarray(params["head"]["proto_presence"]), key))


def test_masked_head_and_degenerate_nodes_match_jax():
    from pipnet_tpu.models.pipnet import masked_decode_degenerates as jax_degenerates
    from pipnet_tpu_torch.models.pipnet import (degenerate_nodes_traced,
                                                masked_decode_degenerates)
    mj, tj, mt, tt, params = _step_models_with_presence()
    key = jax.random.PRNGKey(7)
    xs = np.random.default_rng(4).standard_normal((3, 48, 48, 3)).astype(np.float32)
    with small_backbones():
        want = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True,
                        apply_overspecificity_mask=True, mask_rng=key)
        want_deg = np.asarray(jax_degenerates(mj, to_jax(params), tj, key))
    keep = torch.from_numpy(_jax_keep(params, key))
    with torch.no_grad():
        got = mt(torch.from_numpy(xs), inference=True, apply_overspecificity_mask=True,
                 keep=keep)
        got_deg = masked_decode_degenerates(mt, tt, keep)
        w = mt.head.effective_cls_weight() * keep[None]
    for k in ("logits", "pooled"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    assert (got["pooled"].numpy()[:, tt.proto_node == 0] == 0).all()
    np.testing.assert_array_equal(got_deg.numpy(), want_deg)
    assert want_deg[0] and not want_deg.all()
    np.testing.assert_array_equal(degenerate_nodes_traced(w, tt).numpy(), want_deg)
    with pytest.raises(ValueError, match="keep"):
        mt(torch.from_numpy(xs), inference=True, apply_overspecificity_mask=True)


@pytest.mark.parametrize("option", ["mask", "tau", "leave_out", "all"])
def test_eval_step_options_match_jax(option):
    from pipnet_tpu.train.step import make_eval_step as jax_eval_step
    from pipnet_tpu_torch.train import make_eval_step
    mj, tj, mt, tt, params = _step_models_with_presence()
    kw = {}
    if option in ("mask", "all"):
        kw["apply_overspecificity_mask"] = True
    if option in ("tau", "all"):
        kw["path_prob_softmax_tau"] = 0.5
    if option in ("leave_out", "all"):
        kw["leave_out_idx"] = tuple(_valid_leave_out(tt, 2))
    key = jax.random.PRNGKey(9)
    xs = np.random.default_rng(5).standard_normal((3, 48, 48, 3)).astype(np.float32)
    with small_backbones():
        want = jax_eval_step(mj, tj, **kw)(to_jax(params), {}, jnp.asarray(xs),
                                           jnp.zeros(3, jnp.int32), key)
    keep = torch.from_numpy(_jax_keep(params, key)) if kw.get(
        "apply_overspecificity_mask") else None
    got = make_eval_step(mt, tt, **kw)(torch.from_numpy(xs), keep)
    assert set(got) == set(want)
    for k in ("logits", "pooled", "log_joint"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))


# -- Trainer.evaluate and evaluate_per_node --------------------------------

def _trainers(fixture_loaders):
    from pipnet_tpu.train.optimizer import adam_init
    from pipnet_tpu.train.step import TrainState as JaxState
    (jloaders, phylo), (tloaders, _) = fixture_loaders
    jcfg, tcfg = _configs()
    mj, tj, mt, tt, params = _models(jcfg, tcfg, jloaders, tloaders, phylo)
    jt = jax_trainer.Trainer(mj, tj, jcfg, jloaders, log=types.SimpleNamespace())
    jt.state = JaxState(params=to_jax(params), batch_stats={}, opt=adam_init(to_jax(params)),
                        rng=jax.random.PRNGKey(0))
    pt = port_trainer.Trainer(mt, tt, tcfg, tloaders, log=types.SimpleNamespace())
    return jt, pt, params


@pytest.mark.parametrize("decode", ["leave_out", "masked", "masked_fixed_seed"])
def test_evaluate_counts_match_jax(fixture_loaders, monkeypatch, decode):
    """Both trainers on the fixture's test loader; for the masked decodes
    the port is handed the JAX trainer's per-batch samples (its keys'
    masks, as numpy)."""
    from pipnet_tpu.ops.segment import segment_hard_gumbel
    jt, pt, params = _trainers(fixture_loaders)
    loader = pt.loaders.test
    kw = {}
    if decode == "leave_out":
        kw["leave_out_classes"] = [pt.tree.class_names[i] for i in _valid_leave_out(pt.tree, 2)]
    else:
        kw["apply_overspecificity_mask"] = True
        presence = jnp.asarray(params["head"]["proto_presence"])
        n = len(loader)
        if decode == "masked_fixed_seed":
            kw["fixed_mask_seed"] = 3
            keys = [jax.random.PRNGKey(3)] * n
        else:
            keys = list(jax.random.split(jax.random.PRNGKey(0), n))
        keeps = np.stack([np.asarray(jax.jit(lambda p, k: segment_hard_gumbel(p, k)[:, 1])(
            presence, k)) for k in keys])
        assert 0 < keeps.mean() < 1
        monkeypatch.setattr(pt, "mask_samples", lambda num, seed=None: torch.from_numpy(keeps))
    with small_backbones():
        want = jt.evaluate(jax_trainer_loader(fixture_loaders), **kw)
    got = pt.evaluate(loader, **kw)
    assert got == want
    if decode == "leave_out":
        left = set(_valid_leave_out(pt.tree, 2))
        ys = np.concatenate([ys for _, ys in loader.epoch_index_batches(0)])
        assert got["n"] == sum(int(y) in left for y in ys) > 0


def jax_trainer_loader(fixture_loaders):
    return fixture_loaders[0][0].test


def test_mask_samples_draw_one_per_batch_or_one_fixed(fixture_loaders):
    from pipnet_tpu_torch.models import presence_keep
    _, pt, _ = _trainers(fixture_loaders)
    presence = pt.model.head.proto_presence
    per_batch = pt.mask_samples(4)
    fixed = pt.mask_samples(4, fixed_mask_seed=5)
    assert per_batch.shape == fixed.shape == (4, presence.shape[0])
    assert len({tuple(row.tolist()) for row in per_batch}) == 4
    assert all(torch.equal(row, presence_keep(presence, 5)) for row in fixed)
    assert torch.equal(per_batch, pt.mask_samples(4))


def test_evaluate_per_node_matches_jax(fixture_loaders):
    jt, pt, _ = _trainers(fixture_loaders)
    with small_backbones():
        want = jax_trainer.evaluate_per_node(jt, jax_trainer_loader(fixture_loaders))
    got = port_trainer.evaluate_per_node(pt, pt.loaders.test)
    assert got == want
    assert len(got) == pt.tree.num_nodes


# -- evaluate.run ----------------------------------------------------------

@pytest.fixture(scope="module")
def eval_run_dir(tmp_path_factory, fixture_loaders):
    """A run directory with metadata written by the port's RunLog and the
    same seeded weights as both packages' checkpoints: the JAX package's
    ``checkpoints/net_trained_last/`` and the port's ``.pt`` pair."""
    import dataclasses
    from pipnet_tpu.train.checkpoint import save_checkpoint as jax_save
    from pipnet_tpu.train.optimizer import adam_init
    from pipnet_tpu.train.step import TrainState as JaxState
    from pipnet_tpu_torch.runtime.log import RunLog
    from pipnet_tpu_torch.train import init_train_state, save_checkpoint
    from pipnet_tpu_torch.tree import build_tree_from_config
    (jloaders, phylo), (tloaders, _) = fixture_loaders
    jcfg, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, dataset=FIXTURE)
    mj, tj, mt, tt, params = _models(jcfg, tcfg, jloaders, tloaders, phylo)
    run = tmp_path_factory.mktemp("eval_run")
    log = RunLog(str(run))
    log.save_config(tcfg)
    log.save_classes(tloaders.classes)
    log.save_tree(build_tree_from_config(phylo, None))
    ckpt = os.path.join(str(run), "checkpoints")
    save_checkpoint(ckpt, "net_trained_last", mt, init_train_state(mt), epoch=3, phase="train")
    jax_save(ckpt, "net_trained_last",
             JaxState(params=to_jax(params), batch_stats={}, opt=adam_init(to_jax(params)),
                      rng=jax.random.PRNGKey(0)), epoch=3, phase="train")
    leave_out = run / "leave_out.txt"
    leave_out.write_text("".join(tt.class_names[i] + "\n" for i in _valid_leave_out(tt, 2)))
    return str(run), str(leave_out), params


def _report(run_dir, suffix):
    path = os.path.join(run_dir, f"eval_report{suffix}.json")
    with open(path) as f:
        out = json.load(f)
    os.remove(path)
    return out


@pytest.mark.parametrize("case", ["leave_out", "masked_tau"])
def test_evaluate_run_matches_jax(eval_run_dir, monkeypatch, case):
    """Both packages' ``evaluate.run`` on the same run directory.  With the
    mask, one fixed sample (``--fixed_mask_seed 0``): the port is handed the
    JAX package's (its key 0's mask)."""
    from pipnet_tpu.evaluate import run as jax_run
    from pipnet_tpu.ops.segment import segment_hard_gumbel
    from pipnet_tpu_torch.evaluate import run as port_run
    run_dir, leave_out, params = eval_run_dir
    argv = ["--run_dir", run_dir, "--skip_per_node"]
    if case == "leave_out":
        argv += ["--leave_out_classes", leave_out]
        suffix = "_lou"
    else:
        argv += ["--apply_overspecificity_mask", "--fixed_mask_seed", "0",
                 "--path_prob_softmax_tau", "0.5"]
        suffix = "_masked_tau0.5"
        keep = torch.from_numpy(np.asarray(segment_hard_gumbel(
            jnp.asarray(params["head"]["proto_presence"]), jax.random.PRNGKey(0))[:, 1]))
        monkeypatch.setattr(port_trainer.Trainer, "mask_samples",
                            lambda self, num, seed=None: keep[None].expand(num, -1))
    with small_backbones():
        assert jax_run(argv) == 0
        want = _report(run_dir, suffix)
        assert port_run(argv + ["--device", "cpu"]) == 0
        got = _report(run_dir, suffix)
    assert set(got) == set(want)
    assert got["checkpoint_id"] == want["checkpoint_id"] == {
        "checkpoint": "net_trained_last", "epoch": 3, "phase": "train"}
    for k, v in want.items():
        if isinstance(v, int) or k in ("top1", "top5", "held_in_top1", "held_in_top5"):
            assert got[k] == v, k
        elif isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9, err_msg=k)
    if case == "leave_out":
        assert got["left_out_n"] == got["n"] > 0 and got["held_in_n"] > 0


def test_evaluate_run_writes_per_node_and_merges(eval_run_dir):
    from pipnet_tpu_torch.evaluate import run
    run_dir, leave_out, _ = eval_run_dir
    with small_backbones():
        assert run(["--run_dir", run_dir, "--device", "cpu"]) == 0
        with open(os.path.join(run_dir, "eval_report.json")) as f:
            full = json.load(f)
        assert run(["--run_dir", run_dir, "--device", "cpu", "--skip_per_node"]) == 0
        again = _report(run_dir, "")
    assert len(full["per_node"]) > 0 and again["per_node"] == full["per_node"]


def _interp_flags(case, run_dir, tmp_path):
    """The argv of one interp case on ``run_dir`` and the files it writes
    into the run directory."""
    from pipnet_tpu_torch.data import scan_image_folder
    from pipnet_tpu_torch.datasets import resolve_dataset
    from pipnet_tpu_torch.tree import Node
    from test_torch_interp import write_part_files
    if case == "threshold_prune":
        return ["--threshold_prune", "0.1,0.3"], ["prototype_report.txt"]
    if case == "prune_leaf_parents":
        return ["--threshold_prune", "0.3", "--prune_leaf_parents"], ["prototype_report.txt"]
    if case == "part_purity_csv":
        files = write_part_files(scan_image_folder(resolve_dataset(FIXTURE)[0]), str(tmp_path))
        return (["--part_purity_csv", "--parts_loc", files[0], "--parts_name", files[1],
                 "--images_id", files[2]], ["topk_patches.csv"])
    with open(os.path.join(run_dir, "metadata", "tree.json")) as f:
        node = Node.from_dict(json.load(f)).nodes_with_children()[-1].name
    return ["--galleries_nodes", node], ["node_galleries"]


@pytest.mark.parametrize("case", ["threshold_prune", "prune_leaf_parents", "part_purity_csv",
                                  "galleries_nodes"])
def test_interp_flags_raise_before_any_work(eval_run_dir, tmp_path, case):
    """The interp flags (refused before ``interp/*`` was ported) run, and
    their report sections and files equal the JAX package's on the same
    weights (``tests/test_torch_interp.py`` has the bars)."""
    from test_torch_interp import compare_interp_sections, run_both_evaluates
    run_dir = eval_run_dir[0]
    argv, outputs = _interp_flags(case, run_dir, tmp_path)
    got, want = run_both_evaluates(run_dir, argv, outputs)
    key = {"threshold_prune": "threshold_prune",
           "prune_leaf_parents": "threshold_prune_leaf_parents_ab",
           "part_purity_csv": "part_purity", "galleries_nodes": "node_galleries"}[case]
    assert key in want
    compare_interp_sections(got, want, run_dir)


def test_evaluate_defaults_to_cuda(eval_run_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from pipnet_tpu_torch.evaluate import run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--run_dir", eval_run_dir[0]])


# -- the masked Predictor --------------------------------------------------

def test_masked_predictor_is_fixed_and_matches_the_eval_step(eval_run_dir):
    from pipnet_tpu_torch.models import presence_keep
    from pipnet_tpu_torch.serve import Predictor
    from pipnet_tpu_torch.train import make_eval_step
    run_dir = eval_run_dir[0]
    images = [np.random.default_rng(i).integers(0, 256, (40, 48, 3), dtype=np.uint8)
              for i in range(5)]
    with small_backbones():
        a, b = (Predictor(run_dir, batch_size=4, apply_overspecificity_mask=True, mask_seed=2,
                          device="cpu") for _ in range(2))
        plain = Predictor(run_dir, batch_size=4, device="cpu")
    assert a.predict(images) == b.predict(images)
    assert torch.equal(a.keep, presence_keep(a.model.head.proto_presence, 2))
    assert 0 < a.keep.mean() < 1
    xs = torch.from_numpy(a._prep(images[:2]))
    logits, _, logp = a.forward(torch.cat([xs, xs]))
    want = make_eval_step(a.model, a.tree, apply_overspecificity_mask=True)(xs, a.keep)
    assert torch.equal(logits[:2], want["logits"])
    assert torch.equal(logp[:2], want["log_joint"])
    assert not torch.equal(plain.forward(torch.cat([xs, xs]))[0][:2], logits[:2])


def test_serve_cli_serves_the_masked_model(eval_run_dir, tmp_path, capsys):
    from PIL import Image
    from pipnet_tpu_torch.serve import Predictor, run
    run_dir = eval_run_dir[0]
    path = str(tmp_path / "a.png")
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (40, 48, 3),
                                                      dtype=np.uint8)).save(path)
    with small_backbones():
        assert run(["--run_dir", run_dir, "--images", path, "--device", "cpu",
                    "--apply_overspecificity_mask", "--mask_seed", "4"]) == 0
        want = Predictor(run_dir, apply_overspecificity_mask=True, mask_seed=4,
                         device="cpu").predict([path])[0]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"image": path, **want}
