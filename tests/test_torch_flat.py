"""Flat PIP-Net in the port: one node of ``num_features`` prototypes over
every class (the JAX package's ``flat_tree``), against the JAX package.

The head kernels cut a node wider than their column tile into parts
(``ops/fused_head.py::column_groups``); the plans are checked here.  On the
CPU the wrappers run their plain versions, held here to the Pallas kernels
in interpret mode where the JAX package tiles the node (width 256) and to
its ``segment_softmax`` composition where it does not (300, and 2000, the
flat tree at ``num_protos_per_child`` 10).  Then the whole flat model's
forward, the conversion of its weights, and its first train step on paths
A and B.  The CUDA kernels on these trees run on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (MIXED_NEWICK, MULTI_NEWICK, SMALL_DEPTHS, SMALL_DIMS, budget,
                             compiled_pair, flagship_configs, flagship_roots, flat_classes,
                             flat_pair, flat_root, small_backbones, to_jax)

WIDE_TREES = ("flat256", "flat300", "flat768", "flat2000", "mixed")


def _pair(name):
    if name.startswith("flat"):
        return flat_pair(200, int(name[4:]))
    return compiled_pair(MIXED_NEWICK, 10, 0)


# ---------------------------------------------------------------------------
# column plans
# ---------------------------------------------------------------------------

def _plans(tree):
    """name -> ((G, 3) plan, tile columns, TMA alignment, sector columns) of
    each kernel: K1 and K2 in f32 (SIMT tile) and bf16, K1b in both dtypes
    at the 26x26 map and at 9x11 (a wider window)."""
    from pipnet_tpu_torch.ops.fused_head import _backward_groups, column_groups
    out = {"head_f32": (column_groups(tree, 128), 128, 1, 1),
           "head_bf16": (column_groups(tree, 128, 16, 8), 128, 8, 1)}
    for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
        for hw in (676, 99):
            sv, tile, plan = _backward_groups(tree, dtype, hw)
            out[f"k1b_{str(dtype)[6:]}_{hw}"] = (plan, tile, 16 // es, 32 // es)
    return out


@pytest.mark.parametrize("tree_name", WIDE_TREES)
def test_wide_plans_cover_each_column_once_in_ordered_parts(tree_name):
    """Every column in exactly one group; a wide node's parts follow one
    another from its first column to its last, each fits its kernel's tile
    from the aligned column at or below its start (TMA, 16-byte vectors),
    every part but a node's last ends on a sector, and the parts' records
    say where in the node each starts and how many there are."""
    from pipnet_tpu_torch.ops.fused_head import plan_parts
    _, tree = _pair(tree_name)
    starts = set(int(o) for o in tree.node_proto_offset)
    for name, (groups, tile, align, sector) in _plans(tree).items():
        full = plan_parts(groups)
        covered = np.zeros(tree.num_protos_padded, int)
        n_parts = 0
        for i, (c0, ncols, width, off, part, parts) in enumerate(full):
            covered[c0:c0 + ncols] += 1
            assert ncols > 0
            if width == 0:
                assert (tree.proto_node[c0:c0 + ncols] == -1).all(), name
                continue
            assert c0 % align + ncols <= tile, (name, i)
            if parts == 1:                       # whole nodes
                assert ncols % width == 0 and off == 0 and part == 0 and c0 in starts
                continue
            n_parts += 1
            assert ncols < width and c0 - off in starts, (name, i)
            assert (tree.proto_node[c0:c0 + ncols] == tree.proto_node[c0 - off]).all()
            if part == 0:
                assert off == 0
            else:
                p0, pn = full[i - 1][:2]
                assert full[i - 1][4] == part - 1 and p0 + pn == c0 and full[i - 1][5] == parts
            if part == parts - 1:
                assert off + ncols == width, (name, i)
            else:
                assert (c0 + ncols) % sector == 0, (name, i)
        assert (covered == 1).all(), name
        # the plan cuts a node exactly when it does not fit the tile from its start
        cut = any(s % align + w > tile for s, w in zip(tree.node_proto_offset,
                                                       tree.node_proto_width))
        assert (n_parts > 1) == cut, name


@pytest.mark.parametrize("tree_name", WIDE_TREES)
def test_split_plan_launches_parts_apart_from_whole_nodes(tree_name):
    """``split_plan``: the parts in one table (their node's parts together,
    in order), whole-node groups in the other, the padded tail with the
    whole nodes unless there are none; a kernel launch count per call."""
    from pipnet_tpu_torch.ops.fused_head import (column_groups, head_plan, plan_launches,
                                                 plan_parts, split_plan)
    _, tree = _pair(tree_name)
    cpu = torch.device("cpu")
    groups = column_groups(tree, 128, 16, 8)
    whole, wide = split_plan(groups, cpu)
    full = plan_parts(groups)
    assert wide is not None and (wide[:, 2] == 0).sum() + (wide[:, 5] > 1).sum() == len(wide)
    rows = [w.numpy() for w in (whole, wide) if w is not None]
    assert sorted(map(tuple, np.concatenate(rows))) == sorted(map(tuple, full))
    g = wide.numpy()
    for i, (_, _, w, _, part, parts) in enumerate(g):
        if w:
            assert (g[i - part:i - part + parts, 4] == np.arange(parts)).all()
    if tree_name == "mixed":
        assert whole is not None and (whole[:, 5] == 1).all() and (whole[:, 2] == 0).any()
        assert plan_launches(whole, wide, 2) == 3
    else:
        assert whole is None and plan_launches(whole, wide, 3) == 3
    # K1 and K2 launch the bf16 plan as split here, made once for the tree
    got = head_plan(tree, torch.bfloat16, cpu)
    assert head_plan(tree, torch.bfloat16, cpu) is got
    for a, b in zip(got, (whole, wide)):
        assert (a is None and b is None) or torch.equal(a, b)


def _old_column_groups(tree, tile_cols, max_nodes=None, align=1, sector=1):
    """``column_groups`` as it was before wide nodes: whole nodes only."""
    import math
    groups, covered = [], 0
    for b in tree.buckets:
        assert b.width <= tile_cols - (align - 1)
        first = 0
        while first < b.num_nodes:
            start = b.proto_offset + first * b.width
            n = min((tile_cols - start % align) // b.width, b.num_nodes - first)
            if max_nodes is not None:
                n = min(n, max_nodes)
            whole = sector // math.gcd(b.width, sector)
            if n > whole:
                n -= n % whole
            groups.append((start, n * b.width, b.width))
            first += n
        covered = b.proto_offset + b.num_nodes * b.width
    for start in range(covered, tree.num_protos_padded, tile_cols):
        groups.append((start, min(tile_cols, tree.num_protos_padded - start), 0))
    return np.asarray(groups, np.int32).reshape(-1, 3)


@pytest.mark.parametrize("tree_name", ["flagship10", "flagship1", "multi_bucket"])
def test_narrow_plans_are_unchanged(tiny_newick, tree_name):
    """Trees without a wide node keep exactly the groups they had: no parts,
    one launch over whole nodes, in every kernel's plan."""
    from pipnet_tpu_torch.ops.fused_head import _backward_groups, split_plan
    from pipnet_tpu_torch.tree import compile_tree
    if tree_name.startswith("flagship"):
        _, rt, classes = flagship_roots()
        tree = compile_tree(budget(rt, int(tree_name[8:])), class_names=classes,
                            protopool=False)
    else:
        tree = compiled_pair(MULTI_NEWICK, 2, 3)[1]
    for name, (groups, tile, align, sector) in _plans(tree).items():
        max_nodes = 16 if name == "head_bf16" else None
        np.testing.assert_array_equal(
            groups, _old_column_groups(tree, tile, max_nodes, align, sector), err_msg=name)
        whole, wide = split_plan(groups, torch.device("cpu"))
        assert wide is None and (whole[:, 3:].numpy() == (0, 0, 1)).all()
        np.testing.assert_array_equal(whole[:, :3].numpy(), groups)
    assert _backward_groups(tree, torch.bfloat16, 676)[0] <= 32


# ---------------------------------------------------------------------------
# the head's plain versions against the JAX package
# ---------------------------------------------------------------------------

def _inputs(tree, B=2, H=4, W=5, D=24, seed=0, scale=0.4):
    r = np.random.default_rng(seed)
    f = r.standard_normal((B, H, W, D)).astype(np.float32)
    k = (scale * r.standard_normal((D, tree.num_protos_padded))).astype(np.float32)
    return f, k


def _jax_head(tj, tau, interpret):
    """The JAX package's K1: its Pallas kernel in interpret mode, or (for a
    node it does not tile) the segment_softmax composition."""
    from pipnet_tpu.ops import segment_softmax
    from pipnet_tpu.ops.pallas_head import _plan_tiles, make_fused_head
    if interpret:
        assert _plan_tiles(tj) is not None
        return make_fused_head(tj, tau=tau, interpret=True)
    assert _plan_tiles(tj) is None

    def head(f, k):
        pf = segment_softmax(f @ k, tj, tau=tau)
        return pf, pf.max(axis=(1, 2))
    return head


def _which_side_moved(f, k, tree, tau, pf, pf_j, rerun):
    """What a mismatch of the two heads' pf shows: each side's distance from a
    float64 evaluation, the rows where it is off and their denominators'
    relative error (the median over the row's node of pf / pf64 - 1), and
    whether a second call of each side gives the same bits."""
    z = f.astype(np.float64) @ k.astype(np.float64) / tau
    want = np.zeros_like(z)
    for n in np.unique(tree.proto_node[tree.proto_node >= 0]):
        cols = tree.proto_node == n
        e = np.exp(z[..., cols] - z[..., cols].max(-1, keepdims=True))
        want[..., cols] = e / e.sum(-1, keepdims=True)
    valid = tree.proto_valid
    lines = []
    for name, got, again in (("port", pf, rerun[0]), ("jax", pf_j, rerun[1])):
        err = np.abs(got.astype(np.float64) - want)[..., valid].max(-1)
        bad = np.argwhere(err > 1e-6)
        ratio = np.median(got[..., valid] / want[..., valid], axis=-1) - 1.0
        lines.append(f"{name}: max |pf - pf64| {err.max():.3g}; rows (b, h, w) off by "
                     f"more than 1e-6: {bad.tolist()[:16]}; their denominators' "
                     f"relative error {[float(ratio[tuple(i)]) for i in bad[:16]]}; "
                     f"second call bit-equal: {np.array_equal(got, again)}")
    return "\n".join(lines)


FLAT_HEAD_CASES = [("flat256", 1.0, True), ("flat256", 0.5, True), ("flat300", 0.5, False),
                   ("flat2000", 1.0, False)]


@pytest.mark.parametrize("tree_name,tau,interpret", FLAT_HEAD_CASES)
def test_plain_fused_head_matches_jax_on_flat_trees(tree_name, tau, interpret):
    """K1's plain version (f32): pf and pooled within 2e-6, padded tail 0."""
    from pipnet_tpu_torch.ops.fused_head import fused_head
    tj, tt = _pair(tree_name)
    f, k = _inputs(tt, seed=1)
    pf, pooled = fused_head(torch.from_numpy(f), torch.from_numpy(k), tt, tau=tau)
    pf_j, pooled_j = _jax_head(tj, tau, interpret)(jnp.asarray(f), jnp.asarray(k))
    try:
        np.testing.assert_allclose(pf.numpy(), np.asarray(pf_j), atol=2e-6, rtol=0)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=2e-6, rtol=0)
    except AssertionError as e:
        rerun = (fused_head(torch.from_numpy(f), torch.from_numpy(k), tt, tau=tau)[0].numpy(),
                 np.asarray(_jax_head(tj, tau, interpret)(jnp.asarray(f), jnp.asarray(k))[0]))
        raise AssertionError(f"{e}\n" + _which_side_moved(f, k, tt, tau, pf.numpy(),
                                                         np.asarray(pf_j), rerun)) from None
    assert (pf.numpy()[..., ~tt.proto_valid] == 0).all()
    np.testing.assert_allclose(pf.numpy()[..., tt.proto_valid].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("tree_name,tau,interpret", FLAT_HEAD_CASES)
def test_plain_head_backward_matches_jax_on_flat_trees(tree_name, tau, interpret):
    """``FusedHead``'s gradients (K1b's plain version and the projection
    products) for random cotangents of pf and pooled, f32: within 1e-4."""
    from pipnet_tpu_torch.ops.fused_head import fused_head
    tj, tt = _pair(tree_name)
    f, k = _inputs(tt, seed=2)
    r = np.random.default_rng(3)
    cot_pf = r.standard_normal((2, 4, 5, tt.num_protos_padded)).astype(np.float32)
    cot_pooled = r.standard_normal((2, tt.num_protos_padded)).astype(np.float32)
    head = _jax_head(tj, tau, interpret)

    def loss(f, k):
        pf, pooled = head(f, k)
        return jnp.sum(pf * cot_pf) + jnp.sum(pooled * cot_pooled)
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(k))
    ft, kt = torch.from_numpy(f).requires_grad_(), torch.from_numpy(k).requires_grad_()
    pf, pooled = fused_head(ft, kt, tt, tau=tau)
    ((pf * torch.from_numpy(cot_pf)).sum() + (pooled * torch.from_numpy(cot_pooled)).sum()
     ).backward()
    for got, w in zip((ft.grad, kt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=0)
        assert np.abs(np.asarray(w)).max() > 0.1


@pytest.mark.parametrize("tree_name,tau,interpret", FLAT_HEAD_CASES)
def test_plain_nopf_head_matches_jax_on_flat_trees(tree_name, tau, interpret):
    """K2's plain version (f32): both views' pooled within 2e-6, the node's
    log sum to 1e-5 relative."""
    from pipnet_tpu.ops import segment_softmax
    from pipnet_tpu.ops.pallas_head import fused_head_nopf_forward
    from pipnet_tpu.ops.segment import _node_onehot
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tj, tt = _pair(tree_name)
    f, k = _inputs(tt, B=4, seed=4)
    pooled, logsum = fused_head_nopf(torch.from_numpy(f), torch.from_numpy(k), tt, tau=tau,
                                     eps=1e-12)
    if interpret:
        pooled_j, logsum_j = fused_head_nopf_forward(jnp.asarray(f), jnp.asarray(k), tj,
                                                     tau=tau, eps=1e-12, interpret=True)
    else:
        pf = segment_softmax(jnp.asarray(f) @ jnp.asarray(k), tj, tau=tau)
        ip = (pf[:2] * pf[2:]) @ jnp.asarray(_node_onehot(tj))
        pooled_j, logsum_j = pf.max(axis=(1, 2)), jnp.log(ip + 1e-12).sum((1, 2))
    assert logsum.shape == (2, 1)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=2e-6, rtol=0)
    np.testing.assert_allclose(logsum.numpy(), np.asarray(logsum_j), rtol=1e-5, atol=1e-4)


def test_plain_nopf_vjp_matches_jax_on_flat_tree():
    """``FusedHeadNoPF``'s gradients on the flat tree the Pallas kernels tile
    (width 256) against ``make_fused_head_nopf``, f32, within 1e-5."""
    from pipnet_tpu.ops.pallas_head import make_fused_head_nopf
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tj, tt = _pair("flat256")
    f, k = _inputs(tt, B=4, seed=5)
    cot = np.random.default_rng(6).standard_normal((4, tt.num_protos_padded)).astype(np.float32)
    fused = make_fused_head_nopf(tj, tau=0.5, eps=1e-12, interpret=True)

    def loss(f, k):
        pooled, logsum = fused(f, k)
        return jnp.sum(pooled * cot) - jnp.sum(logsum)
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(k))
    ft, kt = torch.from_numpy(f).requires_grad_(), torch.from_numpy(k).requires_grad_()
    pooled, logsum = fused_head_nopf(ft, kt, tt, tau=0.5, eps=1e-12)
    ((pooled * torch.from_numpy(cot)).sum() - logsum.sum()).backward()
    for got, w in zip((ft.grad, kt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the flat model: forward, weights, first train step
# ---------------------------------------------------------------------------

FLAT_FEATURES, FLAT_CLASSES = 768, 200


def _flat_cfgs(**model_overrides):
    from pipnet_tpu.config import HeadConfig as JH, ModelConfig as JM
    from pipnet_tpu_torch.config import HeadConfig as TH, ModelConfig as TM
    kw = dict(backbone="convnext_tiny_26", image_size=64, num_features=FLAT_FEATURES,
              num_protos_per_child=0, compute_dtype="float32", use_pallas_head=True,
              fast_gelu=True, **model_overrides)
    return JM(head=JH(protopool=False), **kw), TM(head=TH(protopool=False), **kw)


@pytest.fixture(scope="module")
def flat_models():
    """(jax model, jax tree, port model, port tree, params, images) of flat
    PIP-Net: 768 prototypes over 200 generated classes."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    cj, ct = _flat_cfgs()
    classes = flat_classes(FLAT_CLASSES)
    with small_backbones():
        mj, tj = jax_build(jt.flat_tree(classes, FLAT_FEATURES), cj, class_names=classes)
        mt, tree = build_pipnet(tt.flat_tree(classes, FLAT_FEATURES), ct, class_names=classes,
                                device="cpu")
    assert tree.num_nodes == 1 and [(b.num_nodes, b.width) for b in tree.buckets] == [(1, 768)]
    params = random_jax_params(ct, tree, seed=7, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    # a softmax over 768 prototypes from the xavier-scaled add-on is nearly
    # uniform (every pooled value under the 0.1 inference cut, all logits
    # 0); scaled up, it peaks as a trained head's does
    params["head"]["add_on_kernel"] = params["head"]["add_on_kernel"] * 40.0
    mt.load_state_dict(params_from_jax(params))
    xs = np.random.default_rng(8).standard_normal((3, 64, 64, 3)).astype(np.float32)
    return mj, tj, mt, tree, params, xs


@pytest.mark.parametrize("key", ["features", "pooled", "logits", "proto_features"])
def test_flat_forward_matches_jax(flat_models, key):
    """The flat model's inference forward (K1's plain version; the JAX
    package runs its Pallas K1 in interpret mode): f32 within 1e-5."""
    mj, tj, mt, tt, params, xs = flat_models
    with small_backbones():
        oj = mj.apply({"params": to_jax(params)}, jnp.asarray(xs), inference=True)
    with torch.no_grad():
        ot = mt(torch.from_numpy(xs), inference=True)
    np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]), atol=1e-5, rtol=0)
    if key == "logits":           # the cut and the classifier both matter
        assert ot[key].shape == (3, FLAT_CLASSES) and np.ptp(ot[key].numpy()) > 0.1
        assert (ot["pooled"].numpy() == 0).any() and (ot["pooled"].numpy() > 0.1).any()


def test_flat_params_from_jax_map_every_leaf_once(flat_models):
    from pipnet_tpu_torch.models import params_from_jax
    _, _, mt, tt, params, _ = flat_models
    state = params_from_jax(params)
    n_leaves = sum(len(m) for m in params["backbone"].values()) + len(params["head"])
    assert len(state) == n_leaves and set(state) == set(mt.state_dict())
    assert state["head.add_on_kernel"].shape == (SMALL_DIMS[-1], FLAT_FEATURES)
    assert state["head.cls_weight"].shape == (FLAT_CLASSES, FLAT_FEATURES)
    np.testing.assert_array_equal(state["head.add_on_kernel"].numpy(),
                                  params["head"]["add_on_kernel"])


def test_flat_run_dir_loads(tmp_path, flat_models):
    """A flat run directory (config with num_features, the flat tree as
    ``metadata/tree.json``, the port's state_dict) loads through
    ``load_run`` into the same model."""
    import json
    from pipnet_tpu_torch.run_io import load_run
    _, _, mt, tt, _, xs = flat_models
    _, tcfg = flagship_configs(image_size=64)
    cfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, num_features=FLAT_FEATURES, num_protos_per_child=0))
    import pipnet_tpu_torch.tree as ttree
    os_meta = tmp_path / "metadata"
    os_meta.mkdir()
    (tmp_path / "checkpoints").mkdir()
    (os_meta / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    (os_meta / "classes.json").write_text(json.dumps(flat_classes(FLAT_CLASSES)))
    (os_meta / "tree.json").write_text(json.dumps(
        ttree.flat_tree(flat_classes(FLAT_CLASSES), FLAT_FEATURES).to_dict()))
    torch.save(mt.state_dict(), tmp_path / "checkpoints" / "net_trained_last.pt")
    with small_backbones():
        bundle = load_run(str(tmp_path), device="cpu")
    assert bundle.tree.num_protos_padded == FLAT_FEATURES and bundle.tree.num_nodes == 1
    with torch.no_grad():
        got = bundle.model(torch.from_numpy(xs), inference=True)["logits"]
        want = mt(torch.from_numpy(xs), inference=True)["logits"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


B, S = 4, 48


def _flat_step_models(align_eps):
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    from pipnet_tpu.models import build_pipnet as jax_build
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    cfgs = []
    for cfg in flagship_configs(image_size=S, batch_size=B, align_eps=align_eps):
        cfgs.append(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_features=FLAT_FEATURES, num_protos_per_child=0)))
    jcfg, tcfg = cfgs
    classes = flat_classes(FLAT_CLASSES)
    with small_backbones():
        mj, tj = jax_build(flat_root(jt, FLAT_CLASSES, FLAT_FEATURES), jcfg.model,
                           weighted=True, class_names=classes)
        mt, tree = build_pipnet(flat_root(tt, FLAT_CLASSES, FLAT_FEATURES), tcfg.model,
                                weighted=True, class_names=classes, device="cpu")
    params = random_jax_params(tcfg.model, tree, seed=11, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    return jcfg, tcfg, mj, tj, mt, tree, params


@pytest.mark.parametrize("path", ["A", "B"])
def test_flat_first_train_step_matches_jax(path):
    """The flat model's first step in the joint phase (epoch 20, mask-prune
    on) against the JAX package's step (XLA head composition) from the same
    parameters, batch and presence sample, at ``test_torch_train_step``'s
    bars: every metric to 1e-5, gradients to 1e-4 (Adam's first moment),
    updated parameters to 1e-6 where the gradient is not ~0.  Path A
    materialises pf (align_eps 0.01); path B runs the no-pf head
    (``fuse_align_pf``) with align_eps unset, against the JAX step with
    align_eps unset."""
    from test_torch_train_step import _check_metrics, _check_update, _run_jax, _run_port
    from pipnet_tpu_torch.models import params_from_jax
    jcfg, tcfg, mj, tj, mt, tt, params = _flat_step_models(0.01 if path == "A" else None)
    r = np.random.default_rng(12)
    xs = r.standard_normal((2, B, S, S, 3)).astype(np.float32)
    ys = r.integers(0, FLAT_CLASSES, B)
    (noise, jparams, jopt, jmetrics), = _run_jax(mj, tj, jcfg, "train", params, xs[0], xs[1],
                                                 ys, steps=1)
    state, metrics = _run_port(mt, tt, tcfg, "train", xs[0], xs[1], ys, noise,
                               fuse_align_pf=path == "B")
    _check_metrics(metrics, jmetrics)
    g_jax = {n: m.numpy() / 0.1 for n, m in params_from_jax(jopt.mu).items()}
    _check_update(dict(mt.state_dict()), state.opt, jparams, jopt, g_jax, lr_max=1e-3)
    assert state.params["head.add_on_kernel"].grad is not None
