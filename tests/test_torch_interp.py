"""The port's interpretability (``pipnet_tpu_torch.interp`` and the entry
points wired to it) against the JAX package's ``interp``, on the CPU at the
JAX tests' size: the synthetic fixture of 4 classes and 4 images a class at
48^2, a narrow ConvNeXt (``small_backbones``), the same seeded weights in
both models (``params_from_jax``).  The JAX side runs as
``tests/test_interp.py`` runs it (its XLA head, no Pallas kernel).

Tolerances: f32 values (pooled, cosine similarities, prune means, explain
similarities and weights) within 1e-5; adversarial images within 1e-4;
integrated gradients within 1e-4 of their largest value; heatmap overlays
within 3 grey levels (a one-level change of the uint8 activation passes
through PIL's bicubic resize and the JET table); crops, boxes, CSVs and
paths equal.  Where a decision compares a value with a boundary (an argmax
between two values, a ``.3f`` file name, a prune threshold, the report's
0.2), the two packages must agree unless the JAX value lies within the
tolerance of that boundary."""

import csv
import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pipnet_tpu.interp as jinterp
import pipnet_tpu_torch.interp as tinterp
from torch_port_util import SMALL_DEPTHS, SMALL_DIMS, small_backbones, to_jax

S = 48
TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from pipnet_tpu.config import HeadConfig as JHead, ModelConfig as JModel
    from pipnet_tpu.data import (EvalDataset as JEval, EvalTransform as JTransform,
                                 Loader as JLoader, generate_synthetic_dataset,
                                 scan_image_folder as jscan)
    from pipnet_tpu.models import build_pipnet as jbuild
    from pipnet_tpu.tree import build_tree_from_config as jtree
    from pipnet_tpu_torch.config import HeadConfig, ModelConfig
    from pipnet_tpu_torch.data import EvalDataset, EvalTransform, Loader, scan_image_folder
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.tree import build_tree_from_config
    root = tmp_path_factory.mktemp("interp")
    train_dir, test_dir, phy = generate_synthetic_dataset(
        str(root), num_classes=4, images_per_class=4, image_size=S)
    kw = dict(backbone="convnext_tiny_26", image_size=S, num_protos_per_child=4)
    jcfg = JModel(**kw, head=JHead(softmax_tau=1.0, protopool=False))
    tcfg = ModelConfig(**kw, head=HeadConfig(softmax_tau=1.0, protopool=False))
    with small_backbones():
        mj, tj = jbuild(jtree(phy, None), jcfg)
        mt, tt = build_pipnet(build_tree_from_config(phy, None), tcfg, device="cpu")
    params = random_jax_params(tcfg, tt, seed=3, depths=SMALL_DEPTHS, dims=SMALL_DIMS)
    mt.load_state_dict(params_from_jax(params))
    jparams = to_jax(params)
    jfolder, tfolder = jscan(train_dir), scan_image_folder(train_dir)
    jloader = JLoader(JEval(jfolder, JTransform(S)), 1, shuffle=False, drop_last=False,
                      prefetch=0)
    tloader = Loader(EvalDataset(tfolder, EvalTransform(S)), 1, shuffle=False,
                     drop_last=False, prefetch=0)
    with small_backbones():
        jproj = jinterp.run_projection(mj, tj, jparams, {}, jloader, image_size=S,
                                       batch_size=8)
        # the JAX maps of every projection image, for the argmax tie rule
        jmaps = np.asarray(jinterp.make_projection_step(mj, tj)(
            jparams, {}, jnp.asarray(np.stack([b.xs1[0] for b in jloader.epoch(0)]))
        )["proto_features"])
        jw = np.asarray(mj.apply({"params": jparams},
                                 method=lambda m: m.head.effective_cls_weight()))
    tproj = tinterp.run_projection(mt, tt, tloader, image_size=S, batch_size=8)
    with torch.no_grad():
        tw = mt.head.effective_cls_weight().numpy()
    return types.SimpleNamespace(
        root=root, train_dir=train_dir, test_dir=test_dir, phy=phy, mj=mj, tj=tj, mt=mt,
        tt=tt, params=params, jparams=jparams, jproj=jproj, tproj=tproj, jmaps=jmaps,
        jw=jw, tw=tw, jfolder=jfolder, tfolder=tfolder, jloader=jloader, tloader=tloader,
        tcfg=tcfg)


def _normalized(folder, i):
    from pipnet_tpu.data.augment import resize, to_normalized_array
    img, _ = folder.load(i)
    return to_normalized_array(resize(img, S))


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int16)


def _files(root):
    return sorted(os.path.relpath(os.path.join(p, f), root)
                  for p, _, fs in os.walk(root) for f in fs)


# -- patches and heatmaps ----------------------------------------------------

@pytest.mark.parametrize("size,hw", [(224, 26), (224, 7), (48, 4), (32, 2)])
def test_patch_geometry_matches_jax(size, hw):
    assert tinterp.get_patch_size(size, hw) == jinterp.get_patch_size(size, hw)
    ps, skip = jinterp.get_patch_size(size, hw)
    for h in range(hw):
        for w in range(hw):
            assert tinterp.get_img_coordinates(size, (hw, hw), ps, skip, h, w) == \
                jinterp.get_img_coordinates(size, (hw, hw), ps, skip, h, w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jet_table_is_matplotlibs(dtype):
    from matplotlib import cm
    from pipnet_tpu_torch.interp.heatmaps import jet
    x = np.linspace(0, 1, 4096).astype(dtype)
    np.testing.assert_array_equal(jet(x), cm.jet(x))
    levels = np.arange(256, dtype=np.float32) / 255.0
    np.testing.assert_array_equal(jet(levels.astype(dtype)), cm.jet(levels.astype(dtype)))


def test_heatmap_overlay_matches_jax():
    r = np.random.default_rng(0)
    act = r.uniform(0, 1, (5, 5)).astype(np.float32)
    img = r.integers(0, 256, (S, S, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tinterp.overlay_heatmap(img, act),
                                  jinterp.overlay_heatmap(img, act))
    np.testing.assert_array_equal(tinterp.jet_heatmap(act, (S, 40)),
                                  jinterp.jet_heatmap(act, (S, 40)))


# -- the head's cosine maps and the projection --------------------------------

def test_cosine_maps_match_jax(setup):
    f = np.random.default_rng(1).standard_normal((2, 4, 4, SMALL_DIMS[-1])).astype(np.float32)
    with small_backbones():
        want = np.asarray(setup.mj.apply({"params": setup.jparams}, jnp.asarray(f),
                                         method=lambda m, x: m.head.cosine_maps(x)))
    with torch.no_grad():
        got = setup.mt.head.cosine_maps(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_projection_matches_jax(setup):
    jp, tp, maps = setup.jproj, setup.tproj, setup.jmaps
    assert tp.latent_hw == jp.latent_hw and tp.image_size == jp.image_size
    assert tp.paths == jp.paths and np.array_equal(tp.ys, jp.ys)
    assert tp.h_idx.dtype == jp.h_idx.dtype
    np.testing.assert_allclose(tp.pooled, jp.pooled, rtol=0, atol=TOL)
    np.testing.assert_allclose(tp.cs_at_max, jp.cs_at_max, rtol=0, atol=TOL)
    # argmax: equal wherever a column's top two values are more than TOL
    # apart; elsewhere the port's index holds a value within TOL of the max
    n, H, W, P = maps.shape
    flat = maps.reshape(n, H * W, P)
    top2 = -np.sort(-flat, axis=1)[:, :2]
    clear = top2[:, 0] - top2[:, 1] > TOL
    got = tp.h_idx * W + tp.w_idx
    want = jp.h_idx * W + jp.w_idx
    assert clear[:, setup.tt.proto_valid].mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])
    at = np.take_along_axis(flat, got[:, None, :].astype(np.int64), axis=1)[:, 0]
    np.testing.assert_allclose(at, top2[:, 0], rtol=0, atol=TOL)


def test_projection_step_matches_jax(setup):
    xs = np.stack([b.xs1[0] for b in setup.tloader.epoch(0)])[:5]
    with small_backbones():
        want = jinterp.make_projection_step(setup.mj, setup.tj)(
            setup.jparams, {}, jnp.asarray(xs))
    got = tinterp.make_projection_step(setup.mt, setup.tt)(torch.from_numpy(xs))
    assert set(got) == set(want)
    for k in ("pooled", "cs_at_max", "pf_at_max", "proto_features", "logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)


def test_topk_matches_jax(setup):
    for k in (3, 16):
        got = tinterp.topk_per_prototype(setup.tproj, k=k)
        want = jinterp.topk_per_prototype(setup.jproj, k=k)
        assert {p: [i for i, _ in e] for p, e in got.items()} == \
            {p: [i for i, _ in e] for p, e in want.items()}
        for p in want:
            np.testing.assert_allclose([s for _, s in got[p]], [s for _, s in want[p]],
                                       rtol=0, atol=TOL)
    got = tinterp.topk_per_prototype(setup.tproj, threshold=0.3)
    want = jinterp.topk_per_prototype(setup.jproj, threshold=0.3)
    assert {p: [i for i, _ in e] for p, e in got.items()} == \
        {p: [i for i, _ in e] for p, e in want.items()}
    got = tinterp.topk_per_prototype_per_leaf(setup.tproj, setup.tt, setup.tw, k=2)
    want = jinterp.topk_per_prototype_per_leaf(setup.jproj, setup.tj, setup.jw, k=2)
    assert {p: {li: [i for i, _ in e] for li, e in m.items()} for p, m in got.items()} == \
        {p: {li: [i for i, _ in e] for li, e in m.items()} for p, m in want.items()}
    assert got


# -- pruning and part purity -------------------------------------------------

def test_prune_matches_jax(setup):
    from pipnet_tpu.interp.pruning import apply_threshold_prune as japply, prune_means as jmeans
    from pipnet_tpu_torch.interp.pruning import apply_threshold_prune, prune_means
    want = jmeans(setup.jproj, setup.tj, setup.jw, topk=2)
    got = prune_means(setup.tproj, setup.tt, setup.tw, topk=2)
    assert {p: set(m) for p, m in got.items()} == {p: set(m) for p, m in want.items()}
    for p, m in want.items():
        np.testing.assert_allclose([got[p][li] for li in m], list(m.values()), rtol=0, atol=TOL)
    cls_w = setup.params["head"]["cls_weight"]
    values = np.asarray([v for m in want.values() for v in m.values()])
    for q in (0.1, 0.5, 0.9):
        t = float(np.quantile(values, q))
        for leaf_parents in (False, True):
            a = apply_threshold_prune(got, setup.tt, cls_w, threshold=t,
                                      include_leaf_parent_nodes=leaf_parents)
            b = japply(want, setup.tj, cls_w, threshold=t,
                       include_leaf_parent_nodes=leaf_parents)
            # a column may differ only where a JAX mean sits at the threshold
            near = {p for p, m in want.items() if any(abs(v - t) <= TOL for v in m.values())}
            differ = set(np.nonzero((a != b).any(axis=0))[0])
            assert differ <= near, (t, differ - near)
            assert (a == 0).all(axis=0).sum() > (cls_w == 0).all(axis=0).sum() or q == 0.1
    presence = setup.params["head"]["proto_presence"]
    got_r = tinterp.prototype_report(setup.tproj, setup.tt, setup.tw, presence, topk=2)
    want_r = jinterp.prototype_report(setup.jproj, setup.tj, setup.jw, presence, topk=2)
    per_leaf = jinterp.topk_per_prototype_per_leaf(setup.jproj, setup.tj, setup.jw, k=2)
    for line_g, line_w, ni in zip(got_r.splitlines(), want_r.splitlines(), range(99)):
        if line_g != line_w:   # only a "Good" count, and only at the 0.2 boundary
            sl = setup.tj.node_proto_slice(ni)
            assert any(abs(np.mean([s for _, s in v]) - 0.2) <= TOL
                       for p in range(sl.start, sl.stop) for v in per_leaf.get(p, {}).values())
    assert len(got_r.splitlines()) == len(want_r.splitlines()) == setup.tt.num_nodes
    new_w, means = tinterp.threshold_prune(setup.tproj, setup.tt, cls_w, setup.tw, topk=2,
                                           threshold=0.0)
    assert np.array_equal(new_w, cls_w) and set(means) == set(got)


def write_part_files(folder, out_dir):
    """Synthetic CUB-style annotations for ``folder``'s images: one part at
    the centre, a left wing near the corner (merged into the right wing),
    as ``tests/test_interp.py`` writes them.  Returns (parts_loc,
    parts_name, images_id) paths."""
    paths = [os.path.join(out_dir, n) for n in ("part_locs.txt", "parts.txt", "images.txt")]
    with open(paths[2], "w") as f:
        for i, (p, _) in enumerate(folder.samples):
            f.write(f"{i} {'/'.join(p.split('/')[-2:])}\n")
    with open(paths[0], "w") as f:
        for i, (p, _) in enumerate(folder.samples):
            with Image.open(p) as im:
                w, h = im.size
            f.write(f"{i} 1 {w / 2:.1f} {h / 2:.1f} 1\n{i} 2 2.0 2.0 1\n")
    with open(paths[1], "w") as f:
        f.write("1 beak\n2 left wing\n3 right wing\n")
    return paths


def test_part_purity_matches_jax(setup, tmp_path):
    kw = dict(k=2, tree=None, w_eff=None)
    for name, w in (("all", None), ("relevant", "w")):
        a = tinterp.write_topk_patch_csv(setup.tproj, str(tmp_path / f"t_{name}.csv"),
                                         **dict(kw, w_eff=setup.tw if w else None))
        b = jinterp.write_topk_patch_csv(setup.jproj, str(tmp_path / f"j_{name}.csv"),
                                         **dict(kw, w_eff=setup.jw if w else None))
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    node = tinterp.write_topk_patch_csv(setup.tproj, str(tmp_path / "t_node.csv"), k=2,
                                        tree=setup.tt, w_eff=setup.tw, node=1)
    jnode = jinterp.write_topk_patch_csv(setup.jproj, str(tmp_path / "j_node.csv"), k=2,
                                         tree=setup.tj, w_eff=setup.jw, node=1)
    with open(node) as fa, open(jnode) as fb:
        rows = list(csv.reader(fa))
        assert rows == list(csv.reader(fb)) and len(rows) > 1
    files = write_part_files(setup.tfolder, str(tmp_path))
    got = tinterp.eval_prototypes_parts_csv(str(tmp_path / "t_relevant.csv"), *files,
                                            image_size=S)
    want = jinterp.eval_prototypes_parts_csv(str(tmp_path / "j_relevant.csv"), *files,
                                             image_size=S)
    assert got == want and got["num_prototypes"] > 0


# -- galleries ---------------------------------------------------------------

def test_heatmap_forward_matches_jax(setup, monkeypatch):
    import pipnet_tpu_torch.interp.hierarchy_viz as hv
    from pipnet_tpu.interp.hierarchy_viz import make_heatmap_forward as jfwd
    idx = list(range(len(setup.tproj.paths)))
    p = int(np.nonzero(setup.tt.proto_valid)[0][3])
    monkeypatch.setattr(hv, "MAX_BATCH", 5)            # four chunks, the last of one
    got = hv.make_heatmap_forward(setup.mt, setup.tt, setup.tproj)(idx, p)
    with small_backbones():
        want = jfwd(setup.mj, setup.tj, setup.jparams, {}, setup.jproj)(idx, p)
    assert got.shape == want.shape == (len(idx), *setup.tproj.latent_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def compare_gallery_dirs(got_dir, want_dir):
    """The same files; heatmap overlays within 3 grey levels, every other
    image equal pixel for pixel."""
    files = _files(want_dir)
    assert _files(got_dir) == files and files
    for rel in files:
        a, b = _png(os.path.join(got_dir, rel)), _png(os.path.join(want_dir, rel))
        assert a.shape == b.shape, rel
        if "_heatmaps" in rel:
            assert np.abs(a - b).max() <= 3, rel
        else:
            np.testing.assert_array_equal(a, b, err_msg=rel)
    return files


def test_galleries_match_jax(setup, tmp_path):
    from pipnet_tpu.interp.hierarchy_viz import make_heatmap_forward as jfwd
    from pipnet_tpu_torch.interp.hierarchy_viz import make_heatmap_forward
    presence = setup.params["head"]["proto_presence"]
    nodes = [0, setup.tt.num_nodes - 1]
    got = tinterp.save_hierarchy_galleries(
        setup.tproj, setup.tt, setup.tw, presence, str(tmp_path / "t"), k=2, nodes=nodes,
        heatmap_forward=make_heatmap_forward(setup.mt, setup.tt, setup.tproj))
    with small_backbones():
        want = jinterp.save_hierarchy_galleries(
            setup.jproj, setup.tj, setup.jw, presence, str(tmp_path / "j"), k=2, nodes=nodes,
            heatmap_forward=jfwd(setup.mj, setup.tj, setup.jparams, {}, setup.jproj))
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == \
        [os.path.relpath(p, tmp_path / "j") for p in want]
    files = compare_gallery_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    assert any("_heatmaps" in f for f in files) and any("nondesc_" in f for f in files)
    got = tinterp.save_topk_gallery(setup.tproj, tinterp.topk_per_prototype(setup.tproj, k=3),
                                    str(tmp_path / "tk"))
    want = jinterp.save_topk_gallery(setup.jproj, jinterp.topk_per_prototype(setup.jproj, k=3),
                                     str(tmp_path / "jk"))
    assert len(got) == len(want) > 0
    compare_gallery_dirs(str(tmp_path / "tk"), str(tmp_path / "jk"))


# -- explanations ------------------------------------------------------------

def _near_3f(v):
    """Whether ``v`` lies within TOL of a boundary of its ``.3f`` rounding."""
    return abs((v * 1000) % 1 - 0.5) * 1e-3 <= TOL


def test_explain_image_matches_jax(setup, tmp_path):
    from pipnet_tpu_torch.interp import explain_image
    x = _normalized(setup.tfolder, 5)
    got = explain_image(setup.mt, setup.tt, x, str(tmp_path / "t"), image_size=S,
                        top_classes=3)
    with small_backbones():
        want = jinterp.explain_image(setup.mj, setup.tj, setup.jparams, {}, x,
                                     str(tmp_path / "j"), image_size=S, top_classes=3)
    assert [c["name"] for c in got["classes"]] == [c["name"] for c in want["classes"]]
    np.testing.assert_allclose([c["score"] for c in got["classes"]],
                               [c["score"] for c in want["classes"]], rtol=0, atol=TOL)
    near = any(_near_3f(c["score"]) for c in want["classes"])
    evidence = 0
    for cg, cw in zip(got["classes"], want["classes"]):
        assert [(e["prototype"], e["box"]) for e in cg["evidence"]] == \
            [(e["prototype"], e["box"]) for e in cw["evidence"]]
        for eg, ew in zip(cg["evidence"], cw["evidence"]):
            evidence += 1
            np.testing.assert_allclose([eg["similarity"], eg["weight"]],
                                       [ew["similarity"], ew["weight"]], rtol=0, atol=TOL)
            near |= _near_3f(ew["similarity"]) or _near_3f(ew["weight"])
    assert evidence > 0
    if not near:
        assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for rel in _files(tmp_path / "j"):
        if rel.endswith(("_patch.png", "_rect.png")) and os.path.exists(tmp_path / "t" / rel):
            np.testing.assert_array_equal(_png(tmp_path / "t" / rel), _png(tmp_path / "j" / rel))
        elif "heatmap_p" in rel:
            assert np.abs(_png(tmp_path / "t" / rel) - _png(tmp_path / "j" / rel)).max() <= 3


# -- adversarial relocation, integrated gradients, MIPS ----------------------

def test_adversarial_locs_mask_matches_jax():
    act = np.random.default_rng(2).uniform(0, 0.8, (7, 9)).astype(np.float32)
    got = tinterp.adversarial_locs_mask(torch.from_numpy(act), 0.4, 5).numpy()
    want = np.asarray(jinterp.adversarial_locs_mask(jnp.asarray(act), 0.4, 5))
    np.testing.assert_array_equal(got, want)


def test_adversarial_attack_matches_jax(setup):
    x = _normalized(setup.tfolder, 2)
    p = int(np.nonzero(setup.tt.proto_valid)[0][5])
    moved, adv = tinterp.adversarial_attack(setup.mt, x, p, num_steps=3, threshold=0.05)
    with small_backbones():
        jmoved, jadv = jinterp.adversarial_attack(setup.mj, setup.jparams, {}, jnp.asarray(x),
                                                  p, num_steps=3, threshold=0.05)
    assert moved == jmoved
    assert np.abs(adv - np.asarray(x * jinterp.adversarial.IMAGENET_STD
                                   + jinterp.adversarial.IMAGENET_MEAN)).max() > 0
    np.testing.assert_allclose(adv, jadv, rtol=0, atol=1e-4)
    assert all(p.requires_grad for p in setup.mt.parameters())
    g = torch.Generator().manual_seed(0)
    moved_r, adv_r = tinterp.adversarial_attack(setup.mt, x, p, num_steps=1, generator=g)
    assert adv_r.shape == x.shape and np.isfinite(adv_r).all()


def test_integrated_gradients_match_jax(setup):
    from pipnet_tpu.interp.adversarial import integrated_gradients_patch as jig
    from pipnet_tpu_torch.interp.adversarial import integrated_gradients_patch
    x = _normalized(setup.tfolder, 7)
    p = int(np.argmax(setup.tproj.pooled[7]))
    got = integrated_gradients_patch(setup.mt, x, p, num_steps=4).numpy()
    with small_backbones():
        want = np.asarray(jig(setup.mj, setup.jparams, {}, jnp.asarray(x), p, num_steps=4))
    assert got.shape == want.shape == (S, S) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.max())


def test_mips_matches_jax(setup):
    from pipnet_tpu.data import EvalDataset as JEval, EvalTransform as JTransform, Loader as JL
    from pipnet_tpu_torch.data import EvalDataset, EvalTransform, Loader
    tl = Loader(EvalDataset(setup.tfolder, EvalTransform(S)), 4, shuffle=False,
                drop_last=False, prefetch=0)
    jl = JL(JEval(setup.jfolder, JTransform(S)), 4, shuffle=False, drop_last=False, prefetch=0)
    got = tinterp.build_patch_index(setup.mt, tl, max_images=7, batch_size=3)
    with small_backbones():
        want = jinterp.build_patch_index(setup.mj, setup.jparams, {}, jl, max_images=7,
                                         batch_size=3)
    assert len(got) == len(want) > 0 and got.latent_hw == want.latent_hw
    for k in ("image_idx", "h_idx", "w_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    np.testing.assert_allclose(got.features, want.features, rtol=0, atol=TOL)
    q = setup.params["head"]["add_on_kernel"].T[:5]
    for cosine in (False, True):
        a = tinterp.mips_query(got, q, k=4, cosine=cosine, device="cpu")
        b = jinterp.mips_query(want, q, k=4, cosine=cosine)
        assert [[h[:3] for h in r] for r in a] == [[h[:3] for h in r] for r in b]
        np.testing.assert_allclose([[h[3] for h in r] for r in a],
                                   [[h[3] for h in r] for r in b], rtol=0, atol=TOL)


def test_new_entry_points_default_to_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinterp.mips_query(tinterp.PatchIndex(np.zeros((4, 2), np.float32), *(
            np.zeros(4, np.int32),) * 3, (2, 2)), np.zeros((1, 2)), k=1)
    from pipnet_tpu_torch.main import build_arg_parser
    assert build_arg_parser().parse_args([]).device == "cuda"


# -- the entry points --------------------------------------------------------

@pytest.fixture(scope="module")
def interp_run_dir(setup, tmp_path_factory):
    """A run directory on the fixture holding both packages' checkpoints of
    the same weights (the port's ``.pt`` pair and the JAX package's orbax
    directory)."""
    from pipnet_tpu.train.checkpoint import save_checkpoint as jax_save
    from pipnet_tpu.train.optimizer import adam_init
    from pipnet_tpu.train.step import TrainState as JaxState
    from pipnet_tpu_torch.config import RunConfig, TrainConfig
    from pipnet_tpu_torch.runtime.log import RunLog
    from pipnet_tpu_torch.train import init_train_state, save_checkpoint
    from pipnet_tpu_torch.tree import build_tree_from_config
    run = tmp_path_factory.mktemp("interp_run")
    cfg = RunConfig(model=setup.tcfg, train=TrainConfig(batch_size=4, batch_size_pretrain=4),
                    dataset=f"folder:{setup.train_dir}:{setup.test_dir}", log_dir=str(run))
    log = RunLog(str(run))
    log.save_config(cfg)
    log.save_classes(setup.tt.class_names)
    log.save_tree(build_tree_from_config(setup.phy, None))
    ckpt = os.path.join(str(run), "checkpoints")
    save_checkpoint(ckpt, "net_trained_last", setup.mt, init_train_state(setup.mt), epoch=1,
                    phase="train")
    jax_save(ckpt, "net_trained_last",
             JaxState(params=setup.jparams, batch_stats={}, opt=adam_init(setup.jparams),
                      rng=jax.random.PRNGKey(0)), epoch=1, phase="train")
    return str(run)


def run_both_evaluates(run_dir, argv, outputs):
    """Both packages' ``evaluate.run`` on ``run_dir`` with ``argv``: (port
    report, JAX report); the files in ``outputs`` (names in the run
    directory) each run writes are moved to ``<name>.jax`` / ``<name>.port``."""
    from pipnet_tpu.evaluate import run as jax_run
    from pipnet_tpu_torch.evaluate import run as port_run
    reports = []
    for tag, run in (("jax", jax_run), ("port", port_run)):
        extra = ["--device", "cpu"] if tag == "port" else []
        with small_backbones():
            assert run(["--run_dir", run_dir, "--skip_per_node", *argv, *extra]) == 0
        path = os.path.join(run_dir, "eval_report.json")
        with open(path) as f:
            reports.append(json.load(f))
        os.remove(path)
        for name in outputs:
            src = os.path.join(run_dir, name)
            dst = f"{src}.{tag}"
            shutil.rmtree(dst, ignore_errors=True)
            os.rename(src, dst)
    return reports[1], reports[0]


def compare_interp_sections(got, want, run_dir):
    """The report sections the interp flags add, port against JAX."""
    assert set(got) == set(want)
    for key in ("threshold_prune", "threshold_prune_leaf_parents_ab"):
        if key in want:
            g, w = dict(got[key]), dict(want[key])
            assert g.pop("prototype_report") == w.pop("prototype_report")
            assert g == w, key
            with open(os.path.join(run_dir, "prototype_report.txt.port")) as fa, \
                    open(os.path.join(run_dir, "prototype_report.txt.jax")) as fb:
                assert fa.read() == fb.read()
    if "part_purity" in want:
        assert got["part_purity"] == want["part_purity"]
    if "topk_patch_csv" in want:
        assert got["topk_patch_csv"] == want["topk_patch_csv"]
        with open(os.path.join(run_dir, "topk_patches.csv.port")) as fa, \
                open(os.path.join(run_dir, "topk_patches.csv.jax")) as fb:
            assert fa.read() == fb.read()
    if "node_galleries" in want:
        g, w = dict(got["node_galleries"]), dict(want["node_galleries"])
        g.pop("seconds"), w.pop("seconds")
        assert g == w and w["files"] > 0
        compare_gallery_dirs(os.path.join(run_dir, "node_galleries.port"),
                             os.path.join(run_dir, "node_galleries.jax"))
    for k in ("top1", "top5", "n"):
        assert got[k] == want[k]


def test_evaluate_run_interp_flags_match_jax(setup, interp_run_dir, tmp_path):
    files = write_part_files(setup.tfolder, str(tmp_path))
    node = setup.tt.node_names[setup.tt.num_nodes - 1]
    argv = ["--threshold_prune", "0.1,0.3", "--part_purity_csv", "--parts_loc", files[0],
            "--parts_name", files[1], "--images_id", files[2], "--galleries_nodes",
            f"{setup.tt.node_names[0]},{node}"]
    got, want = run_both_evaluates(interp_run_dir, argv,
                                   ["prototype_report.txt", "topk_patches.csv",
                                    "node_galleries"])
    assert {"threshold_prune", "part_purity", "topk_patch_csv", "node_galleries"} <= set(want)
    assert want["threshold_prune"]["sweep"][-1]["pruned_columns"] > 0
    compare_interp_sections(got, want, interp_run_dir)


def test_evaluate_restores_cls_weight_after_the_sweep(setup, interp_run_dir, monkeypatch):
    """``head.cls_weight`` after the sweep is the tensor it was, bit for bit;
    each threshold evaluates its own pruned weights."""
    from pipnet_tpu_torch.evaluate import run
    from pipnet_tpu_torch.train.trainer import Trainer
    seen, evaluate = [], Trainer.evaluate

    def recorded(self, loader, **kw):
        seen.append((self, self.model.head.cls_weight.detach().clone()))
        return evaluate(self, loader, **kw)
    monkeypatch.setattr(Trainer, "evaluate", recorded)
    with small_backbones():
        assert run(["--run_dir", interp_run_dir, "--skip_per_node", "--device", "cpu",
                    "--threshold_prune", "0.2,2.0"]) == 0
    trainer, before = seen[0]
    assert len(seen) == 3
    assert torch.equal(trainer.model.head.cls_weight.detach(), before)
    assert not torch.equal(seen[2][1], before)             # 2.0 prunes columns
    os.remove(os.path.join(interp_run_dir, "eval_report.json"))


def test_final_viz_writes_the_jax_galleries(tmp_path, monkeypatch):
    """``run_pipnet --final_viz y`` on a fixture of at most 60 classes (the
    CLI tests' ``synthetic:8:6`` at 32^2) draws the galleries of the JAX
    package's ``main.py``: the same paths and pixels on the same weights
    (``fit`` replaced by loading seeded weights)."""
    from pipnet_tpu.data import EvalDataset as JEval, EvalTransform as JTransform, Loader as JL
    from pipnet_tpu.data import scan_image_folder as jscan
    from pipnet_tpu.interp.hierarchy_viz import make_heatmap_forward as jfwd
    from pipnet_tpu.models import build_pipnet as jbuild
    from pipnet_tpu.run_io import load_run_config as jax_load_config
    from pipnet_tpu.tree import Node as JNode
    from pipnet_tpu_torch.main import run_pipnet
    from pipnet_tpu_torch.models import params_from_jax, random_jax_params
    from pipnet_tpu_torch.runtime.log import RunLog
    from pipnet_tpu_torch.train.trainer import Trainer
    from test_torch_cli import small_run_argv
    stash = {}

    def fit(self, **kw):
        stash["params"] = random_jax_params(self.cfg.model, self.tree, seed=4,
                                           depths=SMALL_DEPTHS, dims=SMALL_DIMS)
        stash["paths"] = [p for p, _ in self.loaders.project.dataset.folder.samples]
        stash["dir"] = self.loaders.project.dataset.folder.root
        stash["cfg"], stash["classes"] = self.cfg, self.tree.class_names
        self.model.load_state_dict(params_from_jax(stash["params"]))
        return {}
    monkeypatch.setattr(Trainer, "fit", fit)
    run = tmp_path / "run"
    with small_backbones():
        assert run_pipnet(small_run_argv(run, "--final_viz", "y")) == 0
    RunLog(str(tmp_path / "cfg")).save_config(stash["cfg"])
    cfg = jax_load_config(str(tmp_path / "cfg"))
    with open(run / "metadata" / "tree.json") as f:
        root = JNode.from_dict(json.load(f))
    classes = stash["classes"]
    assert len(classes) <= 60
    size = cfg.model.image_size
    jl = JL(JEval(jscan(stash["dir"]), JTransform(size)), 1, shuffle=False, drop_last=False,
            prefetch=0)
    params = to_jax(stash["params"])
    want_dir = tmp_path / "jax"
    with small_backbones():
        mj, tj = jbuild(root, dataclasses.replace(cfg.model, use_pallas_head=False),
                        weighted=cfg.train.loss.weighted_ce, class_names=classes)
        proj = jinterp.run_projection(mj, tj, params, {}, jl, image_size=size)
        assert proj.paths == stash["paths"]
        w_eff = np.asarray(mj.apply({"params": params},
                                    method=lambda m: m.head.effective_cls_weight()))
        jinterp.save_topk_gallery(proj, jinterp.topk_per_prototype(proj, k=10), str(want_dir))
        jinterp.save_hierarchy_galleries(
            proj, tj, w_eff, stash["params"]["head"]["proto_presence"],
            str(want_dir / "hierarchy"), k=10,
            heatmap_forward=jfwd(mj, tj, params, {}, proj))
    files = compare_gallery_dirs(str(run / "visualization_results"), str(want_dir))
    assert any(f.startswith("hierarchy/") for f in files)
    assert any(f.startswith("prototype_") for f in files)


def test_serve_explain_writes_the_evidence_folder(setup, interp_run_dir, tmp_path, capsys):
    from pipnet_tpu_torch.serve import Predictor, run
    path = setup.tfolder.samples[3][0]
    out = tmp_path / "ev"
    with small_backbones():
        assert run(["--run_dir", interp_run_dir, "--images", path, "--device", "cpu",
                    "--explain", str(out)]) == 0
        pred = Predictor(interp_run_dir, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    stem = os.path.splitext(os.path.basename(path))[0]
    assert line["explanation_dir"] == str(out / f"000_{stem}")
    want = pred.explain(path, str(tmp_path / "again"))
    assert _files(out / f"000_{stem}") == _files(tmp_path / "again")
    assert len(want["classes"]) == 3 and any(c["evidence"] for c in want["classes"])
    assert line["class"] == want["classes"][0]["name"]
