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
    branch is their composition; no kernel launch is counted."""
    from pipnet_tpu_torch.ops import cnblock as cb
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(1, 6, 7, 16, seed=12)]
    x, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = args
    before = cb.cnblock_branch.launches
    z = cb.cnblock_dwln(x, dwk, dwb, lns, lnb)
    h1 = cb.cnblock_up(z, w1, b1, fast_gelu=fast_gelu)
    out = cb.cnblock_down(h1, w2, b2, ls)
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
