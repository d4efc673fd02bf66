"""K3 (the depthwise 7x7 conv) in the port: its plain version and its VJP
(``DwConv7x7``: K3 on the flipped kernel for dx, the 49-tap reduction for
dw) against the JAX package's ``make_dwconv7x7`` (Pallas kernel in
interpret mode), at the bars of ``tests/test_pallas_dwconv.py``.  The CUDA
kernel runs only on the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _inputs(shape, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(dtype),
            r.standard_normal((7, 7, shape[-1])).astype(dtype))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 9, 9, 4), (2, 5, 11, 12)])
def test_forward_matches_jax_kernel(shape):
    from pipnet_tpu.ops.pallas_dwconv import make_dwconv7x7
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    x, k = _inputs(shape, seed=sum(shape))
    want = np.asarray(make_dwconv7x7(interpret=True)(jnp.asarray(x), jnp.asarray(k)))
    got = dwconv7x7(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_forward_matches_jax_kernel():
    """bf16 input and kernel: both sum the 49 exact bf16 products in f32 and
    round once to bf16, so they differ by at most one bf16 ulp of the output
    (2^-7 relative) where the f32 sums straddle a rounding boundary."""
    from pipnet_tpu.ops.pallas_dwconv import make_dwconv7x7
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    x, k = _inputs((2, 10, 13, 16), seed=4)
    want = np.asarray(make_dwconv7x7(interpret=True)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)).astype(jnp.float32))
    got = dwconv7x7(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), err.max()


@pytest.mark.parametrize("needs", ["both", "x_only", "kernel_only"])
def test_gradients_match_jax_vjp(needs):
    """dL/dx and dL/dkernel of sum(out^2) through ``DwConv7x7`` against
    ``make_dwconv7x7``'s custom VJP: dx within 1e-4, dw within 1e-3
    absolute (a sum over 288 pixels) and 1e-4 relative."""
    from pipnet_tpu.ops.pallas_dwconv import make_dwconv7x7
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    x, k = _inputs((2, 12, 12, 8), seed=5)
    dw = make_dwconv7x7(interpret=True)
    gx_j, gk_j = jax.grad(lambda a, b: jnp.sum(dw(a, b) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_(needs != "kernel_only")
    kt = torch.from_numpy(k).requires_grad_(needs != "x_only")
    (dwconv7x7(xt, kt) ** 2).sum().backward()
    if needs != "kernel_only":
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    else:
        assert xt.grad is None
    if needs != "x_only":
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), rtol=1e-4, atol=1e-3)
    else:
        assert kt.grad is None


def test_weight_grad_is_the_tap_reduction():
    """``dwconv7x7_weight_grad`` against the JAX package's ``_dw_weight_grad``
    on the same input and cotangent (f32, summation order only)."""
    from pipnet_tpu.ops.pallas_dwconv import _dw_weight_grad
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7_weight_grad
    x, _ = _inputs((3, 7, 9, 5), seed=6)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(_dw_weight_grad(jnp.asarray(x), jnp.asarray(g)))
    got = dwconv7x7_weight_grad(torch.from_numpy(x), torch.from_numpy(g))
    assert tuple(got.shape) == (7, 7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_wrapper_on_cpu_counts_no_launch_and_refuses_other_devices():
    from pipnet_tpu_torch.ops.dwconv import dwconv7x7
    x, k = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 3), seed=8))
    before = dwconv7x7.launches
    dwconv7x7(x, k)
    assert dwconv7x7.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        dwconv7x7(x.to("meta"), k.to("meta"))
