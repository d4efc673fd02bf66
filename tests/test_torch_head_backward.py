"""K1's backward in the port (``FusedHead``: K1b and the projection
products) against the JAX package's ``make_fused_head`` custom VJP, whose
forward is the Pallas kernel (interpret mode here).  On the CPU the port
runs K1b's plain version ``head_backward_reference``; the CUDA kernel is
held to it on the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import MULTI_NEWICK, compiled_pair

TREES = {
    "tiny": lambda newick: compiled_pair(newick, 10, 0),
    "multi_bucket": lambda newick: compiled_pair(MULTI_NEWICK, 2, 3),
}


def _inputs(tree, B=2, H=5, W=5, D=32, seed=0, scale=0.3):
    r = np.random.default_rng(seed)
    f = r.standard_normal((B, H, W, D)).astype(np.float32)
    k = (scale * r.standard_normal((D, tree.num_protos_padded))).astype(np.float32)
    cot_pf = r.standard_normal((B, H, W, tree.num_protos_padded)).astype(np.float32)
    cot_pooled = r.standard_normal((B, tree.num_protos_padded)).astype(np.float32)
    return f, k, cot_pf, cot_pooled


def _jax_grads(tree, f, k, cot_pf, cot_pooled, tau, dtype=jnp.float32):
    from pipnet_tpu.ops.pallas_head import make_fused_head
    fused = make_fused_head(tree, tau=tau, interpret=True)

    def loss(f, k):
        pf, pooled = fused(f, k)
        return jnp.sum(pf.astype(jnp.float32) * cot_pf) + jnp.sum(pooled * cot_pooled)

    g = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f, dtype), jnp.asarray(k, dtype))
    return [np.asarray(a, np.float32) for a in g]


def _port_grads(tree, f, k, cot_pf, cot_pooled, tau, dtype=torch.float32):
    from pipnet_tpu_torch.ops.fused_head import fused_head
    ft = torch.from_numpy(f).to(dtype).requires_grad_()
    kt = torch.from_numpy(k).to(dtype).requires_grad_()
    pf, pooled = fused_head(ft, kt, tree, tau=tau)
    loss = ((pf.float() * torch.from_numpy(cot_pf)).sum()
            + (pooled * torch.from_numpy(cot_pooled)).sum())
    loss.backward()
    return ft.grad.float().numpy(), kt.grad.float().numpy()


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_f32_grads_match_jax_make_fused_head(tiny_newick, name, tau):
    """dL/dfeatures and dL/dkernel for random cotangents of pf and pooled,
    f32: within the gradient bar 1e-4 (they differ by summation order)."""
    tj, tt = TREES[name](tiny_newick)
    args = _inputs(tt, seed=1)
    for got, want, what in zip(_port_grads(tt, *args, tau), _jax_grads(tj, *args, tau),
                               ("features", "kernel")):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=what)
        assert np.abs(want).max() > 1.0           # the comparison is not of zeros


def test_bf16_grads_match_jax_by_gradient_mass(tiny_newick):
    """bf16 inputs: near-max softmax values collapse to bf16 ties, and the
    port's adjoint runs in f32 where the JAX one rounds to bf16 at each
    step, so elementwise differences are expected; the criterion of
    tests/test_interp.py:295-303 holds the gradient mass (relative L2 < 0.2,
    L1 mass within 5%)."""
    tj, tt = TREES["multi_bucket"](tiny_newick)
    args = _inputs(tt, seed=2)
    got = _port_grads(tt, *args, 0.5, torch.bfloat16)
    want = _jax_grads(tj, *args, 0.5, jnp.bfloat16)
    for a, b in zip(got, want):
        rel_l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-6)
        assert rel_l2 < 0.2, rel_l2
        assert abs(float(np.abs(a).sum() / np.abs(b).sum()) - 1.0) < 0.05


@pytest.mark.parametrize("with_g_pf", [True, False])
def test_reference_adjoint_equals_autograd_of_plain_forward(tiny_newick, with_g_pf):
    """``head_backward_reference`` is the exact adjoint of
    ``fused_head_reference`` (f32), with and without a pf cotangent."""
    from pipnet_tpu_torch.ops.fused_head import fused_head_reference, head_backward_reference
    _, tt = TREES["multi_bucket"](tiny_newick)
    f, k, cot_pf, cot_pooled = _inputs(tt, seed=3)
    z = (torch.from_numpy(f) @ torch.from_numpy(k)).requires_grad_()
    pf, pooled = fused_head_reference(z, torch.eye(z.shape[-1]), tt, tau=0.5)
    g_pf = torch.from_numpy(cot_pf) if with_g_pf else None
    loss = (pooled * torch.from_numpy(cot_pooled)).sum()
    if with_g_pf:
        loss = loss + (pf * g_pf).sum()
    loss.backward()
    dz = head_backward_reference(pf.detach(), g_pf, torch.from_numpy(cot_pooled), tt, tau=0.5)
    torch.testing.assert_close(dz, z.grad, atol=1e-5, rtol=1e-5)


def test_tied_spatial_maxima_split_the_pooled_cotangent(tiny_newick):
    """Two patches with equal features tie for a column's spatial max: each
    gets half of that column's pooled cotangent, as in the JAX VJP."""
    from pipnet_tpu_torch.ops.fused_head import fused_head_reference, head_backward
    tj, tt = TREES["tiny"](tiny_newick)
    f, k, _, cot_pooled = _inputs(tt, B=1, H=3, W=3, seed=4)
    f[0] = 0.0
    f[0, 0, 0] = f[0, 1, 1] = np.random.default_rng(5).standard_normal(f.shape[-1])
    pf, _ = fused_head_reference(torch.from_numpy(f), torch.from_numpy(k), tt)
    col_max = pf.amax(dim=(1, 2))
    tied = (pf[0, 0, 0] == col_max[0]) & (pf[0, 1, 1] == col_max[0]) & \
        torch.from_numpy(tt.proto_valid)
    assert tied.sum() > 0 and (pf[0, 2, 2] < col_max[0])[tied].all()
    one_hot = torch.zeros(1, tt.num_protos_padded)
    c = int(torch.nonzero(tied)[0])
    one_hot[0, c] = 1.0
    dz_one = head_backward(pf, None, one_hot, tt)
    dz_half = head_backward(pf[:, :1, :1].contiguous(), None, one_hot, tt)
    # a tie of two routes half the cotangent to each patch
    torch.testing.assert_close(dz_one[0, 0, 0], dz_one[0, 1, 1])
    torch.testing.assert_close(2 * dz_one[0, 0, 0], dz_half[0, 0, 0])
    zero = torch.zeros(1, tt.num_protos_padded, dtype=torch.float32)
    zeros = np.zeros((1, 3, 3, tt.num_protos_padded), np.float32)
    got = _port_grads(tt, f, k, zeros, cot_pooled, 1.0)
    want = _jax_grads(tj, f, k, zeros, cot_pooled, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert (head_backward(pf, None, zero, tt) == 0).all()
