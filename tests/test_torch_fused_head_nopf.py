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

from pipnet_tpu_torch.ops.fused_head_nopf import F32_PAIR_ROWS, nopf_scratch_shapes
from torch_port_util import (MIXED_NEWICK, MULTI_NEWICK, budget, compiled_pair, flagship_roots,
                             flat_tree_port, port_tree)

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



# ---------------------------------------------------------------------------
# The f32 kernel's grid, scratch and launches (csrc/fused_head_nopf.cu::
# fused_head_nopf_f32): one block per (column group, row tile of
# F32_PAIR_ROWS pair rows), view 1's rows over the same rows of view 2
# ---------------------------------------------------------------------------

# (pairs, patch rows an image): the flagship train step, ResNet-50's 28x28
# at 4 pairs, 99 rows (a tile holding the end of one image and the start of
# the next), 25 and 1 (a tile holding many images), one row tile exactly,
# one pair smaller than a tile
ROW_TILE_CASES = [(64, 676), (4, 784), (3, 99), (3, 25), (5, 1), (2, 64), (1, 9)]


def _tile_runs(pairs, hw):
    """(row tile, image, first pair row, end pair row) of each run of a row
    tile's pair rows in one image, as the kernel walks them."""
    rows_total = pairs * hw
    for rt in range(-(-rows_total // F32_PAIR_ROWS)):
        r0 = rt * F32_PAIR_ROWS
        end = min(r0 + F32_PAIR_ROWS, rows_total)
        for img in range(r0 // hw, (end - 1) // hw + 1):
            yield rt, img, max(img * hw, r0), min((img + 1) * hw, end)


@pytest.mark.parametrize("pairs,hw", ROW_TILE_CASES)
def test_f32_row_tiles_cover_each_view_row_once_and_index_runs_apart(pairs, hw):
    """Each row tile reads its pair rows from view 1 (rows b * hw + r) and
    view 2 (rows (pairs + b) * hw + r): together the tiles read every
    view-image row once.  A run of a tile in one image keeps its partial
    sums at row tile + image of ``partial``: no two runs share a row, every
    row lies inside the scratch, and the tiles of an image are the
    consecutive ones from image * hw // F32_PAIR_ROWS, as many as the
    kernel counts before it adds them."""
    rows_total = pairs * hw
    seen = np.zeros(2 * rows_total, np.int32)
    partial_rows = nopf_scratch_shapes(pairs, hw, 7, 1, 0, torch.float32)["partial"][0]
    index, tiles_of = set(), {}
    for rt, img, a, e in _tile_runs(pairs, hw):
        assert rt * F32_PAIR_ROWS <= a < e <= (rt + 1) * F32_PAIR_ROWS
        seen[a:e] += 1
        seen[rows_total + a:rows_total + e] += 1
        assert rt + img not in index and rt + img < partial_rows
        index.add(rt + img)
        tiles_of.setdefault(img, []).append(rt)
    assert (seen == 1).all()
    assert sorted(tiles_of) == list(range(pairs))
    for img, tiles in tiles_of.items():
        first = img * hw // F32_PAIR_ROWS
        count = (img * hw + hw - 1) // F32_PAIR_ROWS - first + 1
        assert tiles == list(range(first, first + count))


@pytest.mark.parametrize("pairs,hw", [(3, 25), (2, 99), (1, 9), (3, 64)])
def test_f32_run_partials_add_up_to_the_plain_logsum(pairs, hw):
    """The per-node log terms summed per (row tile, image) run in row
    order, then each image's runs in row-tile order, as the kernel adds
    them, give the plain version's logsum."""
    from pipnet_tpu_torch.ops.fused_head_nopf import fused_head_nopf_reference
    from pipnet_tpu_torch.ops.segment import segment_softmax, segment_sum_to_nodes
    tree = port_tree(MULTI_NEWICK, 2, 3)
    f, k = (torch.from_numpy(a) for a in _inputs(tree, B=pairs, H=hw, W=1, D=16, seed=hw))
    p = segment_softmax(f @ k, tree).reshape(2, pairs * hw, -1)
    logs = torch.log(segment_sum_to_nodes(p[0] * p[1], tree) + EPS)   # (pair rows, N)
    partial = {rt + img: logs[a:e].sum(0) for rt, img, a, e in _tile_runs(pairs, hw)}
    got = torch.zeros(pairs, tree.num_nodes)
    for rt, img, _, _ in _tile_runs(pairs, hw):       # tiles in order within an image
        got[img] += partial[rt + img]
    _, want = fused_head_nopf_reference(f, k, tree, eps=EPS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _port_tree(name):
    from pipnet_tpu_torch.tree import compile_tree
    if name == "flagship":
        _, root, classes = flagship_roots()
        return compile_tree(budget(root, 10), class_names=classes, protopool=False)
    if name.startswith("flat"):
        return flat_tree_port(200, int(name[4:]))
    return port_tree(*{"mixed": (MIXED_NEWICK,), "multi_bucket": (MULTI_NEWICK, 2, 3)}[name])


# (tree, K2 launches a call in either dtype): one over whole nodes; three
# over the parts of a wide node (statistics, normalising pass, log sums)
LAUNCH_CASES = [("flagship", 1), ("multi_bucket", 1), ("flat768", 3), ("flat2000", 3),
                ("mixed", 4)]


@pytest.mark.parametrize("tree_name,launches", LAUNCH_CASES)
def test_f32_scratch_and_launches_follow_the_plan(tree_name, launches):
    """A K2 call's scratch for the f32 plan (``head_plan``): the parts of a
    wide node take their statistics, inner products and (f32 only) each
    (row tile, part)'s 128 x 128 z tile; whole-node groups take (f32 only)
    the run partials and a count per (group, image).  bf16 keeps its
    statistics and inner products only.  Both dtypes launch the same count
    a call, which ``fused_head_nopf.launches`` adds."""
    from pipnet_tpu_torch.ops.fused_head import head_plan, plan_launches
    tree = _port_tree(tree_name)
    pairs, hw, N = 64, 676, tree.num_nodes
    tiles = -(-pairs * hw // F32_PAIR_ROWS)
    for dtype in (torch.float32, torch.bfloat16):
        whole, wide = head_plan(tree, dtype, torch.device("cpu"))
        gw, gp = (0 if t is None else t.shape[0] for t in (whole, wide))
        shapes = nopf_scratch_shapes(pairs, hw, N, gw, gp, dtype)
        f32 = dtype == torch.float32
        assert shapes == {
            "stats": (2 * pairs * hw, gp, 2) if gp else None,
            "ip": (pairs * hw, gp) if gp else None,
            "z": (tiles, gp, 128, 128) if f32 and gp else None,
            "partial": (tiles + pairs - 1, N) if f32 and gw else None,
            "count": (gw, pairs) if f32 and gw else None}
        assert plan_launches(whole, wide, 3) == launches
        if f32 and tree_name == "flat768":   # the z scratch at flat's 64 pairs: 266 MB
            assert shapes["z"] == (676, 6, 128, 128)
            assert round(np.prod(shapes["z"]) * 4 / 1e6) == 266
