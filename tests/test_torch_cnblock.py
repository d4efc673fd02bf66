"""K4 (the fused ConvNeXt block branch) in the port: its plain version
against the JAX package's Pallas kernel (``make_fused_cnblock`` in
interpret mode), its VJP (``FusedCNBlock``: recompute of the unfused
composition) against the JAX custom VJP for all ten inputs, the unfused
composition against ``cnblock_branch_xla``, and the port's fused
``CNBlock`` against the JAX ``CNBlock(use_pallas=True)``.  The CUDA kernel
runs only on the card (``tests/test_torch_cuda.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import to_jax

NAMES = ("x", "dw_kernel", "dw_bias", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2",
         "layer_scale")


def _inputs(B=2, H=7, W=5, C=16, seed=0):
    """Block input and branch parameters in the JAX layout, at the scales of
    ``random_jax_params`` (layer scales in [0.05, 0.2])."""
    r = np.random.default_rng(seed)
    n = lambda shape, std: (r.standard_normal(shape) * std).astype(np.float32)  # noqa: E731
    return [n((B, H, W, C), 1.0), n((7, 7, C), 49 ** -0.5), n((C,), 0.02),
            1.0 + n((C,), 0.05), n((C,), 0.02), n((C, 4 * C), C ** -0.5),
            n((4 * C,), 0.02), n((4 * C, C), (4 * C) ** -0.5), n((C,), 0.02),
            r.uniform(0.05, 0.2, C).astype(np.float32)]


def _jax_fused(fast_gelu):
    from pipnet_tpu.ops.pallas_convnext import make_fused_cnblock
    return make_fused_cnblock(fast_gelu=fast_gelu, interpret=True)


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("shape", [(2, 7, 5, 16), (1, 6, 6, 8)])
def test_plain_version_matches_jax_kernel_f32(fast_gelu, shape):
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch
    args = _inputs(*shape, seed=sum(shape))
    want = np.asarray(_jax_fused(fast_gelu)(*map(jnp.asarray, args)))
    got = cnblock_branch(*map(torch.from_numpy, args), fast_gelu=fast_gelu)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_plain_version_matches_jax_kernel_bf16(fast_gelu):
    """bf16: the plain version rounds where the Pallas kernel rounds (z, h1
    and the output, each once from f32), so the two differ only where f32
    values that differ by summation order straddle a bf16 rounding boundary
    (measured: 0 with tanh GELU, 6.1e-5 with erf, on a 0.47 scale).  Bar:
    2^-8 of the output's scale, at most one bf16 ulp of the largest
    output; the unfused composition, which rounds after every op, misses it
    (measured 2.9e-3)."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch, cnblock_branch_unfused
    args = _inputs(2, 9, 7, 32, seed=3)
    want = np.asarray(_jax_fused(fast_gelu)(
        *[jnp.asarray(a, jnp.bfloat16) for a in args]).astype(jnp.float32))
    targs = [torch.from_numpy(a).bfloat16() for a in args]
    got = cnblock_branch(*targs, fast_gelu=fast_gelu)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -8 * scale, (err, scale)
    unfused = cnblock_branch_unfused(*targs, fast_gelu=fast_gelu).float().numpy()
    assert np.abs(unfused - want).max() > 2.0 ** -8 * scale   # the rounding order matters


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_unfused_composition_matches_jax_xla(fast_gelu):
    from pipnet_tpu.ops.pallas_convnext import cnblock_branch_xla
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch_unfused
    args = _inputs(seed=4)
    want = np.asarray(cnblock_branch_xla(*map(jnp.asarray, args), fast_gelu=fast_gelu))
    got = cnblock_branch_unfused(*map(torch.from_numpy, args), fast_gelu=fast_gelu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_gradients_of_all_inputs_match_jax_vjp(fast_gelu):
    """A random linear loss through ``cnblock_branch`` (``FusedCNBlock``)
    and through the JAX custom VJP: the gradients of all ten inputs within
    1e-4 (f32)."""
    from pipnet_tpu_torch.ops.cnblock import cnblock_branch
    args = _inputs(seed=5)
    r = np.random.default_rng(6).standard_normal(args[0].shape).astype(np.float32)
    fused = _jax_fused(fast_gelu)
    want = jax.grad(lambda *a: jnp.sum(fused(*a) * r), argnums=tuple(range(10)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (cnblock_branch(*ts, fast_gelu=fast_gelu) * torch.from_numpy(r)).sum().backward()
    for name, t, w in zip(NAMES, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_backward_returns_only_the_gradients_asked_for():
    """Frozen parameters get no gradient; without any input that needs one
    the wrapper records nothing (the frozen stages of a train step)."""
    from pipnet_tpu_torch.ops.cnblock import FusedCNBlock, cnblock_branch
    ts = [torch.from_numpy(a) for a in _inputs(seed=7)]
    ts[0].requires_grad_()
    ts[5].requires_grad_()
    out = cnblock_branch(*ts, fast_gelu=True)
    assert type(out.grad_fn).__name__ == FusedCNBlock.__name__ + "Backward"
    out.sum().backward()
    assert ts[0].grad is not None and ts[5].grad is not None
    assert all(t.grad is None for i, t in enumerate(ts) if i not in (0, 5))
    plain = [t.detach() for t in ts]
    assert cnblock_branch(*plain, fast_gelu=True).grad_fn is None


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_fused_cnblock_matches_jax_cnblock(fast_gelu):
    """The port's ``CNBlock(fused=True)`` (f32, plain version of K4 on the
    CPU) against the JAX ``CNBlock(use_pallas=True)`` with its kernel in
    interpret mode, on the same parameters: the block output (residual
    included) to 1e-5, and the input gradient of a linear loss to 1e-4."""
    import pipnet_tpu.ops.pallas_convnext as pc
    from pipnet_tpu.models.convnext import CNBlock as JaxCNBlock
    from pipnet_tpu_torch.models.convert import params_from_jax
    from pipnet_tpu_torch.models.convnext import CNBlock
    C = 24
    _, dwk, dwb, lns, lnb, w1, b1, w2, b2, ls = _inputs(C=C, seed=8)
    params = {"dwconv_kernel": dwk[:, :, None, :], "dwconv_bias": dwb, "norm_scale": lns,
              "norm_bias": lnb, "mlp_in_kernel": w1, "mlp_in_bias": b1,
              "mlp_out_kernel": w2, "mlp_out_bias": b2, "layer_scale": ls}
    x = np.random.default_rng(9).standard_normal((2, 6, 7, C)).astype(np.float32)
    r = np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)
    jb = JaxCNBlock(C, fast_gelu=fast_gelu, use_pallas=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc, "make_fused_cnblock",
                   functools.partial(pc.make_fused_cnblock, interpret=True))
        apply = lambda xx: jb.apply({"params": to_jax(params)}, xx)  # noqa: E731
        want = np.asarray(apply(jnp.asarray(x)))
        want_gx = np.asarray(jax.grad(lambda xx: jnp.sum(apply(xx) * r))(jnp.asarray(x)))
    state = {k[len("backbone.stage0_block0."):]: v for k, v in params_from_jax(
        {"backbone": {"stem_conv": {"kernel": np.zeros((4, 4, 3, C)), "bias": np.zeros(C)},
                      "stem_norm": {"scale": np.ones(C), "bias": np.zeros(C)},
                      "stage0_block0": params},
         "head": {n: np.zeros(1) for n in ("add_on_kernel", "cls_weight", "proto_presence",
                                           "multiplier")}}).items()
        if k.startswith("backbone.stage0_block0.")}
    tb = CNBlock(C, fast_gelu=fast_gelu, fused=True)
    tb.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_()
    got = tb(xt, torch.float32)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, atol=1e-4, rtol=0)
