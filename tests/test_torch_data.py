"""The port's host data path against the JAX package's, on the CPU: the
synthetic fixture, ImageFolder scanning, the PIL augment ops and spaces, the
two-view and eval transforms, the native normalizer, the loaders (epoch
order, weighted sampling, leave-out, host sharding, workers), the stratified
split, ``build_loaders``' bundle, ``NodeFilteredLoader``, the device cache
(on the CPU) and ``run_io.load_run``'s dataset resolution.

Bars: exact equality for file bytes, indices, orders, splits and uint8
images; the normalized float arrays within 1e-6 (the native normalizer
multiplies by reciprocals, so it is within 1e-6 of the numpy expression,
the JAX package's own bar for its normalizer; the two packages' libraries
are built with different flags); the device cache's eval batch within 2e-6
of the host ``EvalTransform``.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import pipnet_tpu.data.augment as jaug
import pipnet_tpu.data.loader as jload
import pipnet_tpu_torch.data.augment as taug
import pipnet_tpu_torch.data.loader as tload
from torch_port_util import SMALL_DEPTHS, SMALL_DIMS, small_backbones

NORM_TOL = 1e-6
FIXTURE = "synthetic:8:2"


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """``FIXTURE`` resolved by each package into a temp dir of its own:
    (port's (train, test, project, kwargs), JAX's, port's tmp, JAX's tmp)."""
    import tempfile
    from pipnet_tpu.datasets import resolve_dataset as jax_resolve
    from pipnet_tpu_torch.datasets import resolve_dataset
    out = []
    for resolve in (resolve_dataset, jax_resolve):
        tmp = tmp_path_factory.mktemp("fixture")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tempfile, "tempdir", str(tmp))
            out.append((resolve(FIXTURE), tmp))
    (port, ptmp), (ref, jtmp) = out
    return port, ref, ptmp, jtmp


def _img(seed=0, h=48, w=56):
    r = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, w)[None, :, None]
    return np.clip(0.5 * ramp + 0.5 * r.integers(0, 256, (h, w, 3)), 0, 255).astype(np.uint8)


# --- the fixture and the registry -------------------------------------------

def test_fixture_files_are_identical(fixtures):
    (tr, te, proj, kw), (jtr, jte, jproj, jkw), ptmp, jtmp = fixtures
    assert proj is None and jproj is None
    assert os.path.relpath(tr, ptmp) == os.path.relpath(jtr, jtmp)
    assert os.path.basename(os.path.dirname(tr)) == "pipnet_tpu_synth_v2_8_2_1"
    assert os.path.relpath(kw["phylo_path"], ptmp) == os.path.relpath(jkw["phylo_path"], jtmp)
    root, jroot = os.path.dirname(tr), os.path.dirname(jtr)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jroot)
                    for d, _, fs in os.walk(jroot) for f in fs)
    assert files == jfiles and len(files) == 8 * (2 + 2) + 1
    for f in files:
        with open(os.path.join(root, f), "rb") as a, open(os.path.join(jroot, f), "rb") as b:
            assert a.read() == b.read(), f
    assert not [n for n in os.listdir(ptmp) if n.endswith(".tmp")]


def test_resolve_dataset_matches_jax(monkeypatch, tmp_path):
    from pipnet_tpu.datasets import resolve_dataset as jax_resolve
    from pipnet_tpu_torch.datasets import resolve_dataset
    for name in ("folder:/a/train:/a/test", "folder:/a/train::/a/proj",
                 "folder:/a/train:/a/test:/a/proj"):
        assert resolve_dataset(name) == jax_resolve(name)
    monkeypatch.delenv("PIPNET_DATA_ROOT", raising=False)
    with pytest.raises(FileNotFoundError, match="PIPNET_DATA_ROOT"):
        resolve_dataset("CUB-190")
    monkeypatch.setenv("PIPNET_DATA_ROOT", str(tmp_path))
    for name in ("CUB-190", "CARS", "grayscale"):
        assert resolve_dataset(name) == jax_resolve(name)


def test_scan_image_folder_matches_jax(fixtures):
    from pipnet_tpu.data.folder import scan_image_folder as jax_scan
    from pipnet_tpu_torch.data.folder import scan_image_folder
    (tr, *_), *_ = fixtures
    a, b = scan_image_folder(tr), jax_scan(tr)
    assert (a.classes, a.class_to_idx, a.samples) == (b.classes, b.class_to_idx, b.samples)
    np.testing.assert_array_equal(a.targets, b.targets)
    keep = a.classes[::3]
    assert scan_image_folder(tr, keep).samples == jax_scan(tr, keep).samples
    img, t = a.load(3)
    assert img.mode == "RGB" and t == a.samples[3][1]


# --- PIL ops, spaces and transforms -----------------------------------------

def test_augment_spaces_match_jax():
    for space in ("_space_no_color", "_space_no_shape", "_space_no_shape_with_color"):
        a, b = getattr(taug, space)(), getattr(jaug, space)()
        assert list(a) == list(b)
        for name in a:
            assert a[name][0].__name__ == b[name][0].__name__
            np.testing.assert_array_equal(a[name][1], b[name][1])
            assert a[name][2] == b[name][2]
    assert taug.NUM_BINS == jaug.NUM_BINS == 31


PIL_OPS = [("shear_x", 0.3), ("shear_x", -0.45), ("shear_y", 0.2), ("translate_x", 7.4),
           ("translate_y", -12.0), ("rotate", 33.0), ("rotate", -60.0), ("brightness", 0.4),
           ("brightness", -0.3), ("color", -0.2), ("color", 0.9), ("contrast", 0.35),
           ("sharpness", -0.5), ("posterize", 4.0), ("posterize", 7.0), ("solarize", 128.0),
           ("autocontrast", 0.0), ("equalize", 0.0), ("identity", 0.0)]


@pytest.mark.parametrize("name,mag", PIL_OPS)
def test_pil_op_matches_jax(name, mag):
    img = Image.fromarray(_img(1))
    got = np.asarray(getattr(taug, name)(img, mag))
    np.testing.assert_array_equal(got, np.asarray(getattr(jaug, name)(img, mag)))


@pytest.mark.parametrize("seed", range(4))
def test_trivial_augment_and_crops_match_jax(seed):
    img = Image.fromarray(_img(seed))
    for make in ("trivial_augment_no_color", "trivial_augment_no_shape",
                 "trivial_augment_no_shape_with_color"):
        got = getattr(taug, make)()(img, np.random.default_rng(seed))
        want = getattr(jaug, make)()(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for fn in ("random_resized_crop", "random_crop"):
        np.testing.assert_array_equal(
            np.asarray(getattr(taug, fn)(img, 40, np.random.default_rng(seed))),
            np.asarray(getattr(jaug, fn)(img, 40, np.random.default_rng(seed))))
    np.testing.assert_array_equal(np.asarray(taug.resize(img, 33)),
                                  np.asarray(jaug.resize(img, 33)))


@pytest.mark.parametrize("kw", [{}, {"pretrain": True}, {"cars": True},
                                {"disable_transform2": True}, {"grayscale": True}])
def test_two_view_transform_matches_jax(kw):
    img = Image.fromarray(_img(2, 64, 64))
    t, j = taug.TwoViewTransform(40, **kw), jaug.TwoViewTransform(40, **kw)
    assert (t.resize_to, t.crop_to) == (j.resize_to, j.crop_to)
    assert t.supports_device_photometric == j.supports_device_photometric
    assert t.supports_device_geometric == j.supports_device_geometric
    for seed in range(3):
        a, b = t(img, np.random.default_rng(seed)), j(img, np.random.default_rng(seed))
        for va, vb in zip(a, b):
            assert va.dtype == np.float32 and va.shape == vb.shape
            np.testing.assert_allclose(va, vb, atol=NORM_TOL, rtol=0)
        np.testing.assert_array_equal(t.geometric_view(img, np.random.default_rng(seed)),
                                      j.geometric_view(img, np.random.default_rng(seed)))
    np.testing.assert_array_equal(t.base_view(img), j.base_view(img))


@pytest.mark.parametrize("grayscale", [False, True])
def test_eval_transform_matches_jax(grayscale):
    img = Image.fromarray(_img(3))
    t, j = taug.EvalTransform(40, grayscale), jaug.EvalTransform(40, grayscale)
    np.testing.assert_allclose(t(img), j(img), atol=NORM_TOL, rtol=0)
    np.testing.assert_array_equal(t.base_view(img), j.base_view(img))


# --- the native normalizer ---------------------------------------------------

def test_native_normalizer_every_level():
    """Every uint8 level of every channel, against numpy and the JAX
    package's native normalizer."""
    from pipnet_tpu.native import normalize_u8 as jax_normalize
    from pipnet_tpu_torch import native
    img = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 3, axis=2)
    got = native.normalize_u8(img)
    want = (img.astype(np.float32) / 255.0 - native.IMAGENET_MEAN) / native.IMAGENET_STD
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_normalize(img), atol=NORM_TOL, rtol=0)
    out = np.empty_like(got)
    assert native.normalize_u8(img, out) is out


def test_native_resize_crop_normalize_matches_jax():
    from pipnet_tpu.native import resize_crop_normalize as jax_rcn
    from pipnet_tpu_torch import native
    img = _img(4, 37, 51)
    # the JAX package's library is built with -march=native, which lets g++
    # fuse the four-tap bilinear sum into multiply-adds: each of its
    # roundings moves the result by up to an ulp of 255 (1.5e-5) before the
    # scale by 1 / (255 std), so the two agree within 4e-6
    for args in ((64, (3, 5), (40, 44), False), (64, (0, 0), (64, 64), True),
                 (30, (2, 1), (20, 24), True)):
        np.testing.assert_allclose(native.resize_crop_normalize(img, *args),
                                   jax_rcn(img, *args), atol=4e-6, rtol=0)


def test_native_normalizer_checks_its_input():
    from pipnet_tpu_torch import native
    with pytest.raises(ValueError, match="uint8"):
        native.normalize_u8(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="out"):
        native.normalize_u8(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4, 3), np.float64))


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No fallback: no g++, or a source g++ refuses, raises (with the
    compiler's output)."""
    from pipnet_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "bad.cc"
    bad.write_text("extern \"C\" void normalize_u8( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g.. failed for bad.cc:\n.*error"):
        native.build()
    assert not list(tmp_path.glob("*.so"))


# --- loaders -----------------------------------------------------------------

class _Fake:
    """A dataset the samplers can index without images."""

    def __init__(self, targets):
        self.folder = types.SimpleNamespace(targets=np.asarray(targets))

    def __len__(self):
        return len(self.folder.targets)


@pytest.mark.parametrize("n", [0, 5, 12, 13, 63, 64, 65, 76, 77, 100])
def test_reference_drop_last(n):
    for bs in (1, 4, 7, 64):
        assert tload.reference_drop_last(n, bs) == jload.reference_drop_last(n, bs)


LOADERS = [dict(), dict(shuffle=False), dict(weighted=True), dict(keep_labels=[0, 2, 3]),
           dict(keep_indices=list(range(5, 41))), dict(num_hosts=2, host_id=0),
           dict(num_hosts=3, host_id=2, weighted=True), dict(drop_last=False),
           dict(drop_last=True, seed=7), dict(keep_indices=[1, 4, 9, 30], keep_labels=[1])]


@pytest.mark.parametrize("kw", LOADERS)
def test_loader_index_batches_match_jax(kw):
    targets = np.random.default_rng(5).integers(0, 5, 53)
    for bs in (4, 7):
        a = tload.Loader(_Fake(targets), bs, **kw)
        b = jload.Loader(_Fake(targets), bs, **kw)
        assert (len(a), a.drop_last) == (len(b), b.drop_last)
        np.testing.assert_array_equal(a.indices, b.indices)
        for epoch in (0, 3):
            got, want = list(a.epoch_index_batches(epoch)), list(b.epoch_index_batches(epoch))
            assert len(got) == len(want) == len(a)
            for (r1, t1), (r2, t2) in zip(got, want):
                np.testing.assert_array_equal(r1, r2)
                np.testing.assert_array_equal(t1, t2)


@pytest.mark.parametrize("test_size,seed", [(0.2, 1), (0.5, 3), (0.34, 9)])
def test_stratified_split_matches_jax(test_size, seed):
    targets = np.random.default_rng(6).integers(0, 6, 71)
    for a, b in zip(tload.stratified_split(targets, test_size, seed),
                    jload.stratified_split(targets, test_size, seed)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="validation_size"):
        tload.stratified_split(targets, 0.0, seed)


def test_parallel_batches_forward_worker_exceptions():
    def make(bi):
        if bi == 3:
            raise KeyError("bad image")
        return bi

    gen = tload._parallel_batches(make, 6, workers=4, ahead=4)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="bad image"):
        next(gen)
    assert list(tload._parallel_batches(lambda b: b * b, 9, workers=3, ahead=2)) == \
        [b * b for b in range(9)]


@pytest.fixture(scope="module")
def bundles(fixtures):
    """``build_loaders`` of both packages on the port's fixture, as
    ``main.py`` builds them (device geometric, one class left out)."""
    (tr, te, *_), *_ = fixtures
    classes = sorted(os.listdir(tr))
    kw = dict(image_size=40, batch_size=4, batch_size_pretrain=6, seed=2,
              leave_out_classes=[classes[5]], device_photometric=True,
              device_geometric=True, num_workers=2)
    return tload.build_loaders(tr, te, **kw), jload.build_loaders(tr, te, **kw), classes


def _same_loader(a, b):
    assert (len(a), a.batch_size, a.drop_last, a.shuffle, a.weighted) == \
        (len(b), b.batch_size, b.drop_last, b.shuffle, b.weighted)
    np.testing.assert_array_equal(a.indices, b.indices)
    for (r1, t1), (r2, t2) in zip(a.epoch_index_batches(1), b.epoch_index_batches(1)):
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(t1, t2)


LOADER_NAMES = ["train", "train_pretraining", "train_normal", "train_normal_augment",
                "project", "test", "test_project"]


@pytest.mark.parametrize("name", LOADER_NAMES)
def test_build_loaders_matches_jax(bundles, name):
    port, ref, classes = bundles
    assert port.classes == ref.classes == classes
    a, b = getattr(port, name), getattr(ref, name)
    _same_loader(a, b)
    for attr in ("device_photometric", "device_geometric"):
        assert getattr(a.dataset, attr, None) == getattr(b.dataset, attr, None)


def test_loader_batches_match_jax_with_any_worker_count(bundles):
    """Images: the eval loader's batches against the JAX loader's, and the
    same with one worker, three, or none (per-batch seeding)."""
    port, ref, _ = bundles
    want = list(ref.train_normal.epoch(0))
    for workers, prefetch in ((1, 2), (3, 2), (1, 0)):
        loader = port.train_normal
        loader.num_workers, loader.prefetch = workers, prefetch
        got = list(loader.epoch(0))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.xs2 is None and g.xs1.dtype == np.float32
            np.testing.assert_allclose(g.xs1, w.xs1, atol=NORM_TOL, rtol=0)
            np.testing.assert_array_equal(g.ys, w.ys)


@pytest.mark.parametrize("mode", ["host", "device_photometric", "device_geometric"])
def test_two_view_dataset_modes_match_jax(bundles, mode):
    port, ref, _ = bundles
    folder, tv = port.train.dataset.folder, port.train.dataset.transform
    jfolder, jtv = ref.train.dataset.folder, ref.train.dataset.transform
    flags = dict(device_photometric=mode != "host", device_geometric=mode == "device_geometric")
    a, b = tload.TwoViewDataset(folder, tv, **flags), jload.TwoViewDataset(jfolder, jtv, **flags)
    for i in (0, 7):
        ga, gb = a.get(i, np.random.default_rng(i)), b.get(i, np.random.default_rng(i))
        assert ga[2] == gb[2]
        if mode == "host":
            for va, vb in zip(ga[:2], gb[:2]):
                np.testing.assert_allclose(va, vb, atol=NORM_TOL, rtol=0)
        else:
            assert ga[1] is None and ga[0].dtype == np.uint8
            np.testing.assert_array_equal(ga[0], gb[0])
    if mode == "device_geometric":        # the base is decoded once and cached
        assert a.get(0, None)[0] is a.get(0, None)[0]


def test_node_filtered_loader_matches_jax(fixtures, bundles):
    from pipnet_tpu.data.node_loader import NodeFilteredLoader as JaxNFL
    from pipnet_tpu.tree import build_tree_from_config as jax_tree
    from pipnet_tpu.tree import compile_tree as jax_compile
    from pipnet_tpu_torch.data import NodeFilteredLoader
    from pipnet_tpu_torch.tree import build_tree_from_config, compile_tree
    from torch_port_util import budget
    (_, _, _, kw), *_ = fixtures
    port, ref, classes = bundles
    tt = compile_tree(budget(build_tree_from_config(kw["phylo_path"], None)),
                      class_names=classes)
    tj = jax_compile(budget(jax_tree(kw["phylo_path"], None)), class_names=classes)
    for node in (0, 2):
        a, b = NodeFilteredLoader(port.test, tt, node), JaxNFL(ref.test, tj, node)
        assert a.kept_classes == b.kept_classes
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        for (ba, ya, sa), (bb, yb, sb) in zip(got, want):
            np.testing.assert_array_equal(ya, yb)
            np.testing.assert_array_equal(sa, sb)
            np.testing.assert_allclose(ba.xs1, bb.xs1, atol=NORM_TOL, rtol=0)


# --- the device cache (on the CPU) -------------------------------------------

def test_device_cache_bases_equal_the_streamed_batches(bundles):
    from pipnet_tpu_torch.data import build_device_cache, estimate_bytes
    port, _, _ = bundles
    loader = port.train
    cache = build_device_cache(loader, device="cpu")
    s = loader.dataset.transform.resize_to
    assert cache.kind == "u8base" and cache.array.dtype == torch.uint8
    assert cache.nbytes == estimate_bytes(loader.dataset) == len(loader.dataset) * s * s * 3
    streamed = list(loader.epoch(4))
    batches = list(loader.epoch_index_batches(4))
    assert len(streamed) == len(batches) == len(loader)
    for b, (rows, ys) in zip(streamed, batches):
        got = cache.fetch(rows)
        assert got.dtype == torch.uint8 and got.shape == b.xs1.shape
        np.testing.assert_array_equal(got.numpy(), b.xs1)
        np.testing.assert_array_equal(ys, b.ys)
        assert torch.equal(cache.gather(torch.from_numpy(rows).long()), got)
    cache.delete()
    assert cache.array is None


def test_device_cache_eval_batch_matches_host_transform(bundles):
    import jax
    from pipnet_tpu.data.device_cache import build_device_cache as jax_cache
    from pipnet_tpu.data.device_cache import estimate_bytes as jax_estimate
    from pipnet_tpu_torch.data import build_device_cache, estimate_bytes
    port, ref, _ = bundles
    cache = build_device_cache(port.test, device="cpu")
    assert cache.kind == "eval" and estimate_bytes(port.test.dataset) == \
        jax_estimate(ref.test.dataset)
    assert estimate_bytes(port.train_normal_augment.dataset) is None
    assert build_device_cache(port.train_normal_augment, device="cpu") is None
    rows = np.asarray([3, 0, 9, 4])
    got = cache.fetch(rows).numpy()
    host = np.stack([port.test.dataset.get(int(i))[0] for i in rows])
    np.testing.assert_allclose(got, host, atol=2e-6, rtol=0)
    want = np.asarray(jax.device_get(jax_cache(ref.test).fetch(rows)))
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=0)


def test_device_cache_needs_a_card_unless_asked_for_the_cpu(bundles):
    from pipnet_tpu_torch.data import DeviceDataCache
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDataCache(np.zeros((2, 4, 4, 3), np.uint8), "u8base")
    with pytest.raises(ValueError, match="kind"):
        DeviceDataCache(np.zeros((2, 4, 4, 3), np.uint8), "f32", device="cpu")


# --- run_io: names and tree from the dataset ---------------------------------

@pytest.mark.parametrize("source", ["dataset", "phylo_config", "phylo_config_yaml"])
def test_load_run_resolves_classes_and_tree(fixtures, tmp_path, monkeypatch, source):
    """A run directory without tree.json rebuilds the tree as the JAX
    package's load_run does: without classes.json, the classes from its
    dataset's class folders and the tree from the dataset's bundled
    phylogeny; with them, from the config's ``phylo_config`` (a Newick file,
    or a YAML file naming one), which must exist."""
    import dataclasses
    import tempfile
    from pipnet_tpu_torch.config import HeadConfig, ModelConfig, RunConfig
    from pipnet_tpu_torch.models import build_pipnet, params_from_jax, random_jax_params
    from pipnet_tpu_torch.run_io import load_run
    from pipnet_tpu_torch.tree import build_tree_from_config
    (tr, _, _, kw), _, ptmp, _ = fixtures
    monkeypatch.setattr(tempfile, "tempdir", str(ptmp))
    classes = sorted(os.listdir(tr))
    newick = tmp_path / "phylo.phy"
    newick.write_text(open(kw["phylo_path"]).read())
    phylo = {"dataset": None, "phylo_config": str(newick),
             "phylo_config_yaml": str(tmp_path / "phylo.yaml")}[source]
    if source == "phylo_config_yaml":
        monkeypatch.setenv("FIXTURE_PHY", str(newick))
        (tmp_path / "phylo.yaml").write_text(
            "phylogeny_path: $FIXTURE_PHY\nphyloDistances_string: None\n")
    cfg = RunConfig(dataset=FIXTURE, phylo_config=phylo, model=ModelConfig(
        backbone="convnext_tiny_26", image_size=48, num_protos_per_child=10,
        head=HeadConfig(protopool=False)))
    run = tmp_path / "run"
    (run / "metadata").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    (run / "metadata" / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    if phylo is not None:
        (run / "metadata" / "classes.json").write_text(json.dumps(classes))
    with small_backbones():
        _, tree = build_pipnet(build_tree_from_config(kw["phylo_path"], None), cfg.model,
                               class_names=classes, device="cpu")
        params = random_jax_params(cfg.model, tree, seed=3, depths=SMALL_DEPTHS,
                                   dims=SMALL_DIMS)
        torch.save(params_from_jax(params), run / "checkpoints" / "net_trained_last.pt")
        bundle = load_run(str(run), device="cpu")
        assert bundle.classes == classes
        assert bundle.tree.node_names == tree.node_names
        np.testing.assert_array_equal(bundle.tree.node_num_protos, tree.node_num_protos)
        if phylo is not None:
            os.rename(phylo, phylo + ".moved")
            with pytest.raises(RuntimeError, match="does not exist on this host"):
                load_run(str(run), device="cpu")
