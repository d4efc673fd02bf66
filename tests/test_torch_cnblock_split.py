"""K4 in bf16 is three launches (``ops/cnblock.py``): depthwise + LayerNorm
(``cnblock_dwln``), then one product kernel twice (``cnblock_up``,
``cnblock_down``) tiled by ``gemm_plan``.  On the CPU: the three plain
pieces compose to the plain version of the whole branch bit for bit, the
wrapper still matches the JAX package's Pallas kernel in interpret mode,
and the product plan covers every shape the model gives it.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_cnblock import _inputs, _jax_fused


def _branch_before_split(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                         layer_scale, *, fast_gelu):
    """The plain version of the branch as one function, in the Pallas
    kernel's rounding order (z, h1 and the output each cast once)."""
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7_taps_f32
    dt = x.dtype
    f = lambda t: t.float()  # noqa: E731
    h = dwconv7x7_taps_f32(x, dw_kernel) + f(dw_bias)
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    z = ((h - mu) * torch.rsqrt(var + 1e-6) * f(ln_scale) + f(ln_bias)).to(dt)
    gelu = lambda t: F.gelu(t, approximate="tanh" if fast_gelu else "none")  # noqa: E731
    h1 = gelu(f(z) @ f(w1) + f(b1)).to(dt)
    return ((f(h1) @ f(w2) + f(b2)) * f(layer_scale)).to(dt)


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pieces_compose_to_the_plain_branch_bit_for_bit(dtype, fast_gelu):
    from pipnet_tpu_torch.ops import cnblock as cb
    args = [torch.from_numpy(a).to(dtype) for a in _inputs(2, 9, 11, 40, seed=11)]
    x, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = args
    z = cb.cnblock_dwln_reference(x, dwk, dwb, lns, lnb)
    h1 = cb.cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu)
    out = cb.cnblock_down_reference(h1, w2, b2, ls)
    assert z.dtype == h1.dtype == out.dtype == dtype
    assert z.shape == x.shape and h1.shape == (*x.shape[:-1], 4 * 40) and out.shape == x.shape
    assert torch.equal(out, cb.cnblock_branch_reference(*args, fast_gelu=fast_gelu))
    assert torch.equal(out, _branch_before_split(*args, fast_gelu=fast_gelu))


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_cpu_parts_are_their_plain_pieces_and_launch_nothing(fast_gelu):
    """On CPU tensors each launch's wrapper is its plain piece, and the
    branch is their composition, in bf16 and in f32 (both dtypes run the
    three launches on the card); no kernel launch is counted."""
    from pipnet_tpu_torch.ops import cnblock as cb
    for dtype in (torch.bfloat16, torch.float32):
        args = [torch.from_numpy(a).to(dtype) for a in _inputs(1, 6, 7, 16, seed=12)]
        x, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = args
        before = cb.cnblock_branch.launches
        z = cb.cnblock_dwln(x, dwk, dwb, lns, lnb)
        h1 = cb.cnblock_up(z, w1, b1, fast_gelu=fast_gelu)
        out = cb.cnblock_down(h1, w2, b2, ls)
        assert z.dtype == h1.dtype == out.dtype == dtype
        assert torch.equal(z, cb.cnblock_dwln_reference(x, dwk, dwb, lns, lnb))
        assert torch.equal(h1, cb.cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu))
        assert torch.equal(out, cb.cnblock_branch(*args, fast_gelu=fast_gelu))
        assert cb.cnblock_branch.launches == before


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("shape", [(2, 9, 11, 40), (1, 5, 6, 96)])
def test_cpu_branch_matches_jax_kernel_at_the_split_shapes(shape, fast_gelu):
    """The shapes of the product launches' edges (C = 40: one depth stage of
    64, N = 160; C = 96: a depth of 1.5 stages, a 96-column output): the CPU
    wrapper against ``make_fused_cnblock(interpret=True)``, f32 within 1e-5
    and bf16 within 2^-8 of the output's scale (the bars of
    ``test_torch_cnblock.py``)."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch
    args = _inputs(*shape, seed=sum(shape))
    fused = _jax_fused(fast_gelu)
    want = np.asarray(fused(*map(jnp.asarray, args)))
    got = cnblock_branch(*map(torch.from_numpy, args), fast_gelu=fast_gelu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    want16 = np.asarray(fused(*[jnp.asarray(a, jnp.bfloat16) for a in args]).astype(jnp.float32))
    got16 = cnblock_branch(*[torch.from_numpy(a).bfloat16() for a in args], fast_gelu=fast_gelu)
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - want16).max() <= 2.0 ** -8 * np.abs(want16).max()


@pytest.mark.parametrize("N,bn", [(96, 128), (160, 128), (192, 128), (384, 128), (768, 256),
                                  (1536, 256), (3072, 256)])
@pytest.mark.parametrize("M", [128, 198, 5408, 86528, 401408])
def test_gemm_plan_covers_the_output(M, N, bn):
    """256-column tiles where 256 divides N, else 128; the grid covers every
    row and column with no tile wholly outside, and the depth steps of 64
    cover K (ConvNeXt-tiny's C and 4C, and the test width 40)."""
    from pipnet_tpu_torch.ops.cnblock import GEMM_DEPTH, GEMM_ROWS, gemm_plan
    for K in (40, 96, 192, 384, 768, 3072):
        plan = gemm_plan(M, N, K)
        assert plan.bn == bn
        assert (plan.grid_m - 1) * GEMM_ROWS < M <= plan.grid_m * GEMM_ROWS
        assert (plan.grid_n - 1) * plan.bn < N <= plan.grid_n * plan.bn
        assert (plan.k_steps - 1) * GEMM_DEPTH < K <= plan.k_steps * GEMM_DEPTH


def test_gemm_plan_at_the_stage_shapes():
    """The plans of stage 0 (56x56x96) and stage 3 (26x26x768) at B=128:
    up (N = 4C) and down (N = C)."""
    from pipnet_tpu_torch.ops.cnblock import gemm_plan
    assert tuple(gemm_plan(128 * 56 * 56, 384, 96)) == (128, 3136, 3, 2)
    assert tuple(gemm_plan(128 * 56 * 56, 96, 384)) == (128, 3136, 1, 6)
    assert tuple(gemm_plan(128 * 26 * 26, 3072, 768)) == (256, 676, 12, 12)
    assert tuple(gemm_plan(128 * 26 * 26, 768, 3072)) == (256, 676, 3, 48)
    assert tuple(gemm_plan(8 * 26 * 26, 768, 3072)) == (256, 43, 3, 48)


# the stage maps of ConvNeXt-tiny-26 at 224^2: (H, W, C)
STAGE_MAPS = [(56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768)]


def _covered_once(starts, tile, extent):
    """Every index of [0, extent) lies in exactly one [s, s + tile) of
    ``starts``, and no tile lies wholly outside."""
    count = np.zeros(extent, np.int32)
    for s in starts:
        assert 0 <= s < extent
        count[s:s + tile] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("product", ["up", "down"])
@pytest.mark.parametrize("batch", [8, 128])
@pytest.mark.parametrize("stage", range(4))
def test_gemm_plan_f32_covers_every_output_once(stage, batch, product):
    """The f32 product's plan at every stage map at the serving and the
    training batch: block b computes the 128 x 128 tile (b // grid_n, b %
    grid_n) (``csrc/cnblock.cu::cnblock_gemm_f32``), so column tiles are
    the fastest grid index; the tiles cover every output element exactly
    once, the 32-deep stages cover the depth, and the grid fits a launch."""
    from pipnet_tpu_torch.ops.cnblock import (F32_GEMM_COLS, F32_GEMM_DEPTH, F32_GEMM_ROWS,
                                              gemm_plan_f32)
    H, W, C = STAGE_MAPS[stage]
    M = batch * H * W
    N, K = (4 * C, C) if product == "up" else (C, 4 * C)
    plan = gemm_plan_f32(M, N, K)
    assert plan.bn == F32_GEMM_COLS == 128 and F32_GEMM_ROWS == 128
    blocks = np.arange(plan.grid_m * plan.grid_n)
    rows, cols = blocks // plan.grid_n * F32_GEMM_ROWS, blocks % plan.grid_n * plan.bn
    assert (cols[:plan.grid_n] == np.arange(plan.grid_n) * plan.bn).all()
    assert (rows[:plan.grid_n] == 0).all()
    # the tiles are the grid's product: rows and columns each covered once
    assert _covered_once(rows[::plan.grid_n], F32_GEMM_ROWS, M)
    assert _covered_once(cols[:plan.grid_n], plan.bn, N)
    assert len(set(zip(rows.tolist(), cols.tolist()))) == len(blocks)
    assert (plan.k_steps - 1) * F32_GEMM_DEPTH < K <= plan.k_steps * F32_GEMM_DEPTH
    assert len(blocks) < 2 ** 31 and K % 4 == 0 and N % 4 == 0


@pytest.mark.parametrize("M,N,K", [(198, 160, 40), (198, 40, 160), (35, 3072, 768),
                                   (1, 96, 384), (129, 128, 32)])
def test_gemm_plan_f32_at_ragged_shapes(M, N, K):
    """The ragged shapes of the card tests (C = 40 over 2 x 9 x 11 pixels,
    one partial tile of the widest stage, a single row, one row past a
    tile): the plan still covers the output once with no empty tile."""
    from pipnet_tpu_torch.ops.cnblock import gemm_plan_f32
    plan = gemm_plan_f32(M, N, K)
    assert (plan.grid_m - 1) * 128 < M <= plan.grid_m * 128
    assert (plan.grid_n - 1) * 128 < N <= plan.grid_n * 128
    assert (plan.k_steps - 1) * 32 < K <= plan.k_steps * 32
