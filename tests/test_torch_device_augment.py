"""The port's device augmentation (``ops/device_augment``,
``ops/device_geometric``) against the JAX package's functions on the same
inputs, made with numpy from a seed, on the CPU.

The two packages' random streams differ, so the stochastic ops are fed the
JAX package's own draws (``sample_photometric``, ``sample_geometric``,
``sample_rrc_box``, with the keys split as the JAX functions split them) and
the port's apply functions are held to the JAX functions' outputs.  Bars:
posterize and solarize exact; the blend ops (brightness, color, contrast,
sharpness), autocontrast and equalize within one grey level (the JAX
package's bar against PIL; they come out exact here); the nearest warp
exact on boundary-free draws (and equal to PIL's); RRC and flip within one
grey level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from pipnet_tpu.data import augment as jhost
from pipnet_tpu.ops import device_augment as ja
from pipnet_tpu.ops import device_geometric as jg
from pipnet_tpu_torch.data import augment as thost
from pipnet_tpu_torch.ops import device_augment as ta
from pipnet_tpu_torch.ops import device_geometric as tg
from pipnet_tpu_torch.train import augment_views, sample_augment
from torch_port_util import jax_geometric_draws, jax_view_draws

GREY = 1.0


def _lattice_batch(seed, B=4, H=40, W=48):
    """Smooth ramps mixed with noise (histograms not degenerate), on the
    uint8 lattice as float32."""
    r = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, W, dtype=np.float32)[None, :, None]
    noise = r.integers(0, 256, (B, H, W, 3)).astype(np.float32)
    return np.floor(np.clip(0.6 * ramp + 0.4 * noise, 0, 255)).astype(np.float32)


def _cmp(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol, (err, (np.abs(got - want) > tol).mean())


# --- the spaces -------------------------------------------------------------

@pytest.mark.parametrize("cars", [False, True])
def test_space_tables_match_jax(cars):
    jn, jb, js = ja._space_tables(cars)
    tn, tb, ts = ta._space_tables(cars)
    assert tn == jn
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)


def test_geometric_tables_match_jax():
    assert tg.GEO_NAMES == jg.GEO_NAMES and tg._GEO_MAX == jg._GEO_MAX
    np.testing.assert_array_equal(tg._geo_bins(), jg._geo_bins())


# --- photometric ops --------------------------------------------------------

OPS = [("brightness", 1.3, GREY), ("brightness", 0.55, GREY), ("color", 0.8, GREY),
       ("color", 2.0, GREY), ("contrast", 0.5, GREY), ("contrast", 1.45, GREY),
       ("sharpness", 0.6, GREY), ("sharpness", 1.5, GREY), ("posterize", 4, 0.0),
       ("posterize", 7, 0.0), ("solarize", 64.0, 0.0), ("solarize", 255.0, 0.0),
       ("autocontrast", None, GREY), ("equalize_batch", None, GREY)]


@pytest.mark.parametrize("name,arg,tol", OPS)
def test_photometric_op_matches_jax(name, arg, tol):
    x = _lattice_batch(1)
    x[2] = x[2] * 0.5 + 40.0      # a narrow range for autocontrast to stretch
    x[2] = np.floor(x[2])
    args = () if arg is None else (arg,)
    want = np.asarray(getattr(ja, name)(jnp.asarray(x), *args))
    got = getattr(ta, name)(torch.from_numpy(x), *args)
    _cmp(got, want, tol)


@pytest.mark.parametrize("levels", [1, 2, 256])
def test_equalize_few_and_many_levels(levels):
    """Equalize on images with 1, 2 and 256 distinct levels per channel,
    against the JAX function and PIL's ImageOps.equalize."""
    r = np.random.default_rng(levels)
    vals = np.sort(r.choice(256, size=levels, replace=False))
    img = vals[r.integers(0, levels, (32, 24, 3))].astype(np.uint8)
    if levels == 256:
        img.reshape(-1, 3)[:256] = np.arange(256, dtype=np.uint8)[:, None]
    x = np.stack([img, img[::-1]]).astype(np.float32)
    got = ta.equalize_batch(torch.from_numpy(x)).numpy()
    _cmp(got, np.asarray(ja.equalize_batch(jnp.asarray(x))), GREY)
    _cmp(got[0], np.asarray(ImageOps.equalize(Image.fromarray(img)), np.float32), GREY)


@pytest.mark.parametrize("cars", [False, True])
def test_photometric_batch_on_jax_draws(cars):
    """Each op on the images that drew it equals the JAX function's
    every-op-then-select (a batch large enough that every op is drawn)."""
    x = _lattice_batch(2, B=48, H=20, W=24)
    op, mag = ja.sample_photometric(jax.random.PRNGKey(3), 48, cars)
    assert len(np.unique(np.asarray(op))) == len(ja._space_tables(cars)[0])
    want = np.asarray(ja._apply_all_select(jnp.asarray(x), op, mag, cars))
    got = ta.photometric_batch(torch.from_numpy(x), torch.tensor(np.asarray(op)).long(),
                               torch.tensor(np.asarray(mag)), cars)
    _cmp(got, want, GREY)


def test_random_crop_and_normalize_match_jax():
    x = _lattice_batch(3, B=5, H=36, W=36)
    key = jax.random.PRNGKey(4)
    want = np.asarray(ja.random_crop_batch(jnp.asarray(x), key, 30))
    ry, rx = jax.random.split(key)
    y, x0 = (torch.tensor(np.asarray(jax.random.randint(k, (5,), 0, 7))).long()
             for k in (ry, rx))
    got = ta.random_crop_batch(torch.from_numpy(x), y, x0, 30)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ta.normalize(got).numpy(),
                                  np.asarray(ja.normalize(jnp.asarray(want))))


@pytest.mark.parametrize("cars", [False, True])
def test_two_view_transform2_on_jax_draws(cars):
    B, S, out = 12, 36, 32
    x = _lattice_batch(5, B=B, H=S, W=S).astype(np.uint8)
    key = jax.random.PRNGKey(6)
    want = ja.two_view_transform2(jnp.asarray(x), key, out, cars=cars)
    got = ta.two_view_transform2(torch.from_numpy(x), out, jax_view_draws(key, B, S, out, cars),
                                 cars=cars)
    # one grey level in normalized units is 1 / (255 std) of its channel
    level = 1.0 / (255.0 * np.asarray(thost.IMAGENET_STD, np.float32))
    for g, w in zip(got, want):
        assert g.shape == (B, out, out, 3) and g.dtype == torch.float32
        assert (np.abs(g.numpy() - np.asarray(w)) <= level * GREY + 1e-6).all()


# --- geometric ops ----------------------------------------------------------

# the JAX package's exact-against-PIL draws (tests/test_device_geometric.py)
WARPS = [("Identity", 0.0), ("ShearX", 0.3), ("ShearX", -0.5), ("ShearY", 0.25),
         ("ShearY", -0.4), ("TranslateX", 7.0), ("TranslateX", -16.0),
         ("TranslateY", 12.0), ("TranslateY", -3.0), ("Rotate", 30.0), ("Rotate", -60.0),
         ("Rotate", 7.5)]


@pytest.mark.parametrize("name,mag", WARPS)
def test_nearest_warp_matches_jax_and_pil(name, mag):
    img = np.random.default_rng(7).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    i = jg.GEO_NAMES.index(name)
    jm = jg.ta_affine_coeffs(jnp.asarray([i]), jnp.asarray([mag], jnp.float32), 64)
    tm = tg.ta_affine_coeffs(torch.tensor([i]), torch.tensor([mag]), 64)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-4)
    got = tg.nearest_affine_warp(torch.from_numpy(img)[None], tm)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.nearest_affine_warp(jnp.asarray(img)[None],
                                                                         jm)[0]))
    pil = np.asarray(jhost._space_no_color()[name][0](Image.fromarray(img), mag))
    np.testing.assert_array_equal(got, pil)
    host = np.asarray(thost._space_no_color()[name][0](Image.fromarray(img), mag))
    np.testing.assert_array_equal(host, pil)


def test_rrc_box_from_jax_uniforms():
    """The box from the JAX function's own uniforms (split as it splits its
    key) equals its box: first valid try, centre-crop fallback."""
    B, S = 256, 232
    key = jax.random.PRNGKey(8)
    want = jg.sample_rrc_box(key, B, S)
    r_area, r_ar, r_x, r_y = jax.random.split(key, 4)
    u = [jax.random.uniform(r_area, (B, 10), minval=0.95, maxval=1.0),
         jax.random.uniform(r_ar, (B, 10), minval=np.log(3 / 4), maxval=np.log(4 / 3)),
         jax.random.uniform(r_x, (B,)), jax.random.uniform(r_y, (B,))]
    got = tg.rrc_box(*(torch.tensor(np.asarray(v)) for v in u), S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # no try valid (a scale over the whole image): the centre crop
    x, y, cw, ch = tg.rrc_box(torch.full((2, 10), 1.5), torch.zeros(2, 10), torch.rand(2),
                              torch.rand(2), 40)
    assert cw.tolist() == [40, 40] and ch.tolist() == [40, 40] and x.tolist() == [0, 0]


def test_triangle_weights_match_jax():
    start, length = np.asarray([0, 3, 10, 5]), np.asarray([64, 57, 44, 59])
    for out in (56, 70):
        want = np.asarray(jg._pil_triangle_weights(jnp.asarray(start), jnp.asarray(length),
                                                   64, out))
        got = tg._pil_triangle_weights(torch.from_numpy(start), torch.from_numpy(length),
                                       64, out).numpy()
        # the JAX weights are f32 from centres up to 64 (an ulp there is 7.6e-6)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("box,flip", [((0, 0, 64, 64), False), ((3, 5, 57, 57), False),
                                      ((0, 0, 48, 64), True), ((10, 2, 44, 48), True)])
def test_rrc_flip_resize_matches_pil(box, flip):
    """Within one grey level of PIL's resize(BILINEAR, box) of the (flipped)
    image, in f32 as the JAX package's own test, and in bf16 (the step's)."""
    img = np.random.default_rng(9).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    x0, y0, cw, ch = box
    pil = Image.fromarray(img)
    if flip:
        pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
    want = np.asarray(pil.resize((56, 56), Image.BILINEAR, box=(x0, y0, x0 + cw, y0 + ch)))
    for dtype, tol in ((torch.float32, GREY), (torch.bfloat16, 2 * GREY)):
        got = tg.rrc_flip_resize(torch.from_numpy(img)[None],
                                 [torch.tensor([v]) for v in box], torch.tensor([flip]),
                                 56, dtype)[0]
        _cmp(got, want, tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform1_batch_on_jax_draws(seed):
    """The whole transform1 (warp, flip, RRC in bf16) on the JAX function's
    draws: within one grey level of it (it comes out exact here)."""
    B, S, out = 8, 72, 68
    x = np.random.default_rng(seed).integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(10 + seed)
    want = np.asarray(jg.transform1_batch(jnp.asarray(x), key, out))
    got = tg.transform1_batch(torch.from_numpy(x), jax_geometric_draws(key, B, S), out)
    assert got.dtype == torch.float32 and got.shape == (B, out, out, 3)
    np.testing.assert_array_equal(got.numpy(), np.floor(got.numpy()))
    _cmp(got, want, GREY)


# --- the port's own samplers ------------------------------------------------

def test_samplers_draw_from_the_spaces():
    g = torch.Generator().manual_seed(0)
    op, mag = tg.sample_geometric(4096, g)
    assert set(op.unique().tolist()) == set(range(len(tg.GEO_NAMES)))
    for i, n in enumerate(tg.GEO_NAMES):
        sel = mag[op == i].numpy()
        allowed = np.concatenate([tg._geo_bins()[i], -tg._geo_bins()[i]])
        assert (np.abs(sel[:, None] - allowed[None]).min(1) < 1e-6).all(), n
        if n in tg._GEO_MAX:
            assert (sel > 0).any() and (sel < 0).any()
    for cars in (False, True):
        names, bins, signed = ta._space_tables(cars)
        op, mag = ta.sample_photometric(4096, g, cars)
        assert set(op.unique().tolist()) == set(range(len(names)))
        for i in range(len(names)):
            allowed = np.concatenate([bins[i], -bins[i]] if signed[i] else [bins[i]])
            sel = mag[op == i].numpy()
            assert (np.abs(sel[:, None] - allowed[None]).min(1) < 1e-6).all(), names[i]
    x, y, cw, ch = tg.sample_rrc_box(512, 232, g)
    assert ((x >= 0) & (y >= 0) & (x + cw <= 232) & (y + ch <= 232)).all()
    area = (cw * ch).double() / 232 ** 2
    assert ((area > 0.9) & (area < 1.05)).all()


def test_step_augmentation_routes():
    """The uint8 size picks the route (base: transform1 then transform2;
    geometric view: transform2 only); the same seed gives the same views,
    the two views of a batch differ, and a batch smaller than the image
    size is refused."""
    S = 32
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (4, S + 8, S + 8, 3),
                                                             dtype=np.uint8))
    views = []
    for _ in range(2):
        d = sample_augment(4, S + 8, S, torch.Generator().manual_seed(5))
        assert d.geometric is not None
        views.append(augment_views(x, S, d))
    for a, b in zip(*views):
        assert a.shape == (4, S, S, 3) and torch.equal(a, b)
    assert (views[0][0] != views[0][1]).float().mean() > 0.1
    d = sample_augment(4, S + 4, S, torch.Generator().manual_seed(5))
    assert d.geometric is None
    v1, _ = augment_views(x[:, :S + 4, :S + 4], S, d)
    assert v1.shape == (4, S, S, 3)
    with pytest.raises(ValueError, match="smaller"):
        sample_augment(4, S - 1, S, torch.Generator())
