"""The uniformity kernels' wrapper (``ops/uniform_pairs.py``) on the CPU:
CPU rows take the plain versions and launch nothing; K5's tile plan,
with the kernel's masks applied tile by tile in float64, gives the plain
pair sum (whole and a rank's share) at ragged row counts; K5b's chunks
fill the SMs within their scratch limit.  The kernels themselves are
checked on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import pipnet_tpu_torch.losses.catalog as TC
import pipnet_tpu_torch.ops.uniform_pairs as UP


def _rows(n, D=16, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, D))
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_rows_take_the_plain_version_and_launch_nothing(dtype):
    """``uniform_loss`` on CPU rows, forward and backward, through the
    plain blocked version: the same loss and gradient as the plain
    functions called directly, and both launch counters stay 0."""
    UP.uniform_pairs.launches = UP.uniform_pairs_backward.launches = 0
    x0 = _rows(130, seed=1).to(dtype)
    x = x0.clone().requires_grad_(True)
    v = TC.uniform_loss(x, block=48)
    v.backward()
    assert UP.uniform_pairs.launches == 0 and UP.uniform_pairs_backward.launches == 0
    pairs = 130 * 129 / 2
    total = UP.pair_sum_reference(x0, 2.0, 48)
    assert float(v.detach()) == pytest.approx(float(torch.log(total / pairs + 1e-10)), rel=1e-6)
    # d log(S / pairs + 1e-10) / dS, then the plain backward's g dS/dx
    want = UP.pair_sum_backward_reference(x0, 1.0 / (total + 1e-10 * pairs), 2.0, 48)
    assert x.grad.dtype == dtype
    # the two g differ by f32 rounding; a bf16 gradient may round one ulp apart
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(x.grad.float(), want.float(), rtol=rel, atol=1e-6)
    assert torch.equal(UP.uniform_pairs(x0, 2.0, 48), total)


def _emulated_sum(x, at=0, rows=None, t=2.0):
    """K5's arithmetic in float64 on the CPU: over the plan's tiles, the
    tile of the Gram (zeros past n, as TMA fills), d2 from it and the row
    norms, and the kernel's masks (rows inside the range, columns inside
    n, j > i for the whole sum, j != i for a share, weighted 1/2)."""
    n = x.shape[0]
    whole = rows is None
    row_end = n if whole else at + rows
    xp = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype)])
    sq = (xp ** 2).sum(1)
    total = 0.0
    for r0, c0 in UP.pair_tiles(n, at, rows):
        i = torch.arange(at + r0, at + r0 + UP.TILE)[:, None]
        j = torch.arange(c0, c0 + UP.GRAM_COLS)[None, :]
        ic, jc = i.clamp(max=n), j.clamp(max=n)          # row n of xp is zeros
        s = xp[ic[:, 0]] @ xp[jc[0]].T
        d2 = (-2.0 * s + sq[ic]) + sq[jc]
        keep = (i < row_end) & (j < n) & ((j > i) if whole else (j != i))
        total += float(torch.where(keep, torch.exp(-t * d2.clamp(min=0.0)), 0.0).sum())
    return total if whole else 0.5 * total


@pytest.mark.parametrize("n", [1, 127, 128, 255, 256, 300, 1000])
def test_tile_plan_with_the_kernel_masks_gives_the_pair_sum(n):
    """The tiles that hold a pair i < j, with j > i kept inside, sum each
    pair once: the plain float64 pair sum, at row counts below, at and
    past one tile of rows or of columns, and ragged."""
    x = _rows(n, seed=n)
    want = float(UP.pair_sum_reference(x, 2.0, 64))
    assert _emulated_sum(x) == pytest.approx(want, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("n,at,rows", [(300, 0, 150), (300, 150, 150), (1000, 333, 400),
                                       (1000, 900, 100)])
def test_share_tiles_with_the_kernel_masks_give_a_rank_share(n, at, rows):
    """A rank's rows (off the tile boundary, the last ending at n): every
    tile of the range against all columns, j != i, half the sum: the plain
    share in float64."""
    x = _rows(n, seed=at)
    want = float(UP.row_pairs_reference(x[at:at + rows], x, at, 2.0, 64, False)[0])
    assert _emulated_sum(x, at, rows) == pytest.approx(want, rel=1e-12)


def test_tile_plan_order_and_groups():
    """The whole sum's plan holds each tile of 128 rows x 256 columns that
    has a pair i < j once (row tile I, column tile J with J >= I // 2),
    ordered by groups of 2048 x 2048 (column group, then row group),
    columns then rows in a group; a share's plan holds every tile, column
    by column, rows fastest."""
    n = 40 * UP.TILE + 5
    cols = UP.GRAM_COLS
    tiles = UP.pair_tiles(n)
    i, j = tiles[:, 0] // UP.TILE, tiles[:, 1] // cols
    assert tiles.dtype == np.int32 and len(set(zip(i, j))) == len(i)
    assert (j >= i // 2).all()
    assert len(tiles) == sum(-(-n // cols) - a // 2 for a in range(41))
    key = list(zip(j // (UP.GROUP // cols), i // (UP.GROUP // UP.TILE), j, i))
    assert key == sorted(key)
    share = UP.pair_tiles(n, at=1000, rows=3000)
    i, j = share[:, 0] // UP.TILE, share[:, 1] // cols
    assert len(share) == 24 * -(-n // cols) and list(zip(j, i)) == sorted(zip(j, i))


@pytest.mark.parametrize("D,sms,want", [(768, 132, 2816), (2048, 132, 1024), (384, 132, 4096),
                                        (128, 132, 4096), (768, 4, 128), (72, 132, 4096)])
def test_chunk_rows_fill_the_sms_within_the_scratch(D, sms, want):
    """K5b's chunk: row tiles x ceil(D / 128) output tiles as close to one
    per SM as MAX_CHUNK_ROWS allows (D = 768 on 132 SMs: 22 x 6 = 132)."""
    rows = UP.chunk_rows(D, sms)
    assert rows == want and rows % UP.TILE == 0 and rows <= UP.MAX_CHUNK_ROWS
    assert rows // UP.TILE * -(-D // UP.TILE) <= max(sms, -(-D // UP.TILE))


def test_plain_versions_give_the_whole_sum_and_a_share_through_row_pairs():
    """On CPU rows ``uniform_pairs`` and ``uniform_pairs_backward`` are the
    plain whole sum and its gradient; ``row_pairs`` gives a rank's share
    and the whole sum's gradient for its rows, and the shares of a
    partition add up to the whole sum."""
    x = _rows(200, seed=9)
    g = torch.tensor(0.5, dtype=torch.float64)
    whole = UP.uniform_pairs(x, 2.0, 64)
    assert torch.equal(whole, UP.pair_sum_reference(x, 2.0, 64))
    dx = UP.uniform_pairs_backward(x, g, 2.0, 64)
    assert torch.equal(dx, UP.pair_sum_backward_reference(x, g, 2.0, 64))
    share, dxr = UP.row_pairs(x[50:120], x, 50, 2.0, 64, True)
    torch.testing.assert_close(dxr * g, dx[50:120], rtol=1e-12, atol=1e-12)
    assert float(share) == pytest.approx(
        float(UP.row_pairs_reference(x[50:120], x, 50, 2.0, 64, False)[0]), rel=1e-14)
    parts = [UP.row_pairs(x[a:b], x, a, 2.0, 64, False)[0] for a, b in ((0, 50), (50, 120),
                                                                        (120, 200))]
    assert float(sum(parts)) == pytest.approx(float(whole), rel=1e-12)


@pytest.mark.parametrize("dtype,D,error", [
    (torch.float64, 16, TypeError), (torch.float16, 16, TypeError),
    (torch.float32, 18, ValueError), (torch.bfloat16, 12, ValueError)])
def test_kernel_entry_refuses_rows_it_cannot_take(dtype, D, error):
    """The kernels take f32 rows of 16-byte multiples (D a multiple of 4)
    and bf16 ones (D a multiple of 8) and nothing else: CUDA rows of
    another dtype or width raise before any launch instead of falling back
    to the plain version; the check needs no card."""
    x = _rows(10, D).to(dtype)
    with pytest.raises(error):
        UP._checked(x, 0, 10)
    assert UP._checked(_rows(10, 16).to(torch.float32), 2, 8).shape == (10, 16)
    with pytest.raises(ValueError, match="outside"):
        UP._checked(_rows(10, 16).to(torch.float32), 4, 8)
