"""K2 (the no-pf fused head) in the port: its plain version against the JAX
package's Pallas kernel (interpret mode), its VJP (``FusedHeadNoPF``: one
K1 recompute, K1b, the projection products) against ``make_fused_head_nopf``,
and the per-node-max softmax the Pallas kernel lacks.  The CUDA kernel runs
only on the card (``tests/test_torch_cuda.py``)."""

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
EPS = 1e-12


def _inputs(tree, B=3, H=5, W=5, D=32, seed=0, scale=0.3):
    r = np.random.default_rng(seed)
    f = r.standard_normal((2 * B, H, W, D)).astype(np.float32)
    k = (scale * r.standard_normal((D, tree.num_protos_padded))).astype(np.float32)
    return f, k


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_forward_matches_jax_kernel(tiny_newick, name, tau):
    from pipnet_tpu.ops.pallas_head import fused_head_nopf_forward
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tj, tt = TREES[name](tiny_newick)
    f, k = _inputs(tt, seed=1, scale=1.0)
    pooled, logsum = fused_head_nopf(torch.from_numpy(f), torch.from_numpy(k), tt,
                                     tau=tau, eps=EPS)
    pooled_j, logsum_j = fused_head_nopf_forward(jnp.asarray(f), jnp.asarray(k), tj,
                                                 tau=tau, eps=EPS, interpret=True)
    assert pooled.shape == (6, tt.num_protos_padded) and logsum.shape == (3, tt.num_nodes)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=2e-6, rtol=0)
    np.testing.assert_allclose(logsum.numpy(), np.asarray(logsum_j), rtol=1e-5, atol=1e-4)
    assert (pooled.numpy()[:, ~tt.proto_valid] == 0).all()


@pytest.mark.parametrize("name", sorted(TREES))
def test_vjp_matches_jax(tiny_newick, name):
    """The loss through (pooled, logsum) and its gradients for features and
    kernel against ``make_fused_head_nopf``'s custom VJP (f32): the value to
    1e-5 relative, gradients within 1e-5."""
    from pipnet_tpu.losses import make_tree_consts as jax_consts
    from pipnet_tpu.losses.catalog import align_pf_from_logsum as jax_apf
    from pipnet_tpu.ops.pallas_head import make_fused_head_nopf
    from pipnet_tpu_torch.losses import make_tree_consts
    from pipnet_tpu_torch.losses.catalog import align_pf_from_logsum
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tj, tt = TREES[name](tiny_newick)
    f, k = _inputs(tt, seed=2)
    r = np.random.default_rng(3)
    ys = r.integers(0, tt.num_classes, 3)
    cot = r.standard_normal((6, tt.num_protos_padded)).astype(np.float32)
    fused = make_fused_head_nopf(tj, tau=0.5, eps=EPS, interpret=True)
    tcj = jax_consts(tj)

    def loss_j(f, k):
        pooled, logsum = fused(f, k)
        return jax_apf(tcj, logsum, jnp.asarray(ys), hw=25)[0] + jnp.sum(pooled * cot)

    vj, gj = jax.value_and_grad(loss_j, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(k))
    ft = torch.from_numpy(f).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    pooled, logsum = fused_head_nopf(ft, kt, tt, tau=0.5, eps=EPS)
    vt = (align_pf_from_logsum(make_tree_consts(tt), logsum, torch.from_numpy(ys), 25)[0]
          + (pooled * torch.from_numpy(cot)).sum())
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gj[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gj[1]), atol=1e-5, rtol=0)


def test_node_far_below_another_keeps_its_softmax_and_logsum(tiny_newick):
    """Nodes whose logits sit ~100 below another node's in the same tile:
    the Pallas kernel's tile-row-max shift underflows them; the port shifts
    by the per-node max, as ``segment_softmax`` (and the JAX K2 backward's
    recompute) define it, so pooled and logsum follow the per-node softmax."""
    from pipnet_tpu.ops import segment_softmax
    from pipnet_tpu.ops.segment import _node_onehot
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf
    tj, tt = TREES["tiny"](tiny_newick)
    r = np.random.default_rng(4)
    f = np.concatenate([np.ones((4, 4, 4, 1), np.float32),
                        r.standard_normal((4, 4, 4, 7)).astype(np.float32)], -1)
    k = r.standard_normal((8, tt.num_protos_padded)).astype(np.float32)
    k[0] = np.where(tt.proto_node % 2 == 0, 50.0, -50.0)
    pooled, logsum = fused_head_nopf(torch.from_numpy(f), torch.from_numpy(k), tt, eps=EPS)
    pf = segment_softmax(jnp.asarray(f) @ jnp.asarray(k), tj)
    ip = jnp.einsum("bhwp,pn->bhwn", pf[:2] * pf[2:], jnp.asarray(_node_onehot(tj)))
    np.testing.assert_allclose(logsum.numpy(), np.asarray(jnp.log(ip + EPS).sum((1, 2))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pf.max(axis=(1, 2))), atol=2e-6)
    low = tt.proto_valid & (tt.proto_node % 2 == 1)
    assert (pooled.numpy()[:, low] > 0.01).any()      # the low nodes are alive
    assert np.isfinite(logsum.numpy()).all() and (logsum.numpy() > -50.0 * 16).all()


def test_cpu_wrapper_runs_plain_version(tiny_newick):
    from pipnet_tpu_torch.ops.fused_head_nopf import (fused_head_nopf,
                                                      fused_head_nopf_reference)
    _, tt = TREES["tiny"](tiny_newick)
    f, k = _inputs(tt, seed=5)
    before = fused_head_nopf.launches
    got = fused_head_nopf(torch.from_numpy(f), torch.from_numpy(k), tt)
    want = fused_head_nopf_reference(torch.from_numpy(f), torch.from_numpy(k), tt)
    assert fused_head_nopf.launches == before == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="two stacked views"):
        fused_head_nopf(torch.from_numpy(f[:5]), torch.from_numpy(k), tt)
