"""The port's optimizer pieces against the JAX package's: parameter group
labels, masked AdamW with per-parameter counts, global and per-group
clipping, both schedules, and the phase machine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipnet_tpu.train.optimizer as J
import pipnet_tpu_torch.train.optimizer as T
from torch_port_util import flagship_configs


def test_label_params_match_jax_under_the_name_map():
    """Every parameter of the full-depth flagship PIPNet gets the JAX
    package's group label under ``params_from_jax``'s name map, and every
    group occurs."""
    from pipnet_tpu_torch.models import params_from_jax, random_jax_params
    from pipnet_tpu_torch.tree import compile_tree
    from torch_port_util import budget, flagship_roots
    _, root, classes = flagship_roots()
    _, tcfg = flagship_configs()
    tree = compile_tree(budget(root, 10), class_names=classes, protopool=False)
    shapes = random_jax_params(tcfg.model, tree, seed=0)
    jax_labels = params_from_jax(J.label_params(shapes, tcfg.model.backbone),
                                 leaf=lambda v, fn: v)
    port_labels = T.label_params(jax_labels, tcfg.model.backbone)
    assert port_labels == jax_labels
    assert set(port_labels.values()) == set(J.GROUP_TO_OPT)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": r.standard_normal(5).astype(np.float32),
            "c": r.standard_normal((2, 2)).astype(np.float32)}


def test_masked_adamw_two_steps_matches_jax():
    """Two steps with weight decay; 'c' is masked in the first step, so it
    keeps its value, moments and count there and takes its first step when
    the others take their second; 'b' has no gradient in the port (None)
    where the JAX leaf is zero.  The JAX package forms the bias corrections
    1 - b^t in f32 (1 - 0.999 in f32 is 1.3e-5 off) where the port uses
    doubles, so parameters agree to 1e-5 of the largest step (lr 5e-2)."""
    params = _tree(0)
    lrs = {"a": 1e-2, "b": 1e-3, "c": 5e-2}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = J.adam_init(pj)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    st = T.adam_init(pt)
    for step, masks in enumerate(({"a": True, "b": True, "c": False},
                                  {"a": True, "b": True, "c": True})):
        grads = _tree(step + 1)
        grads["b"] = np.zeros_like(grads["b"])
        pj, sj = J.adam_update(pj, {k: jnp.asarray(v) for k, v in grads.items()}, sj,
                               {k: jnp.asarray(v) for k, v in lrs.items()},
                               {k: jnp.asarray(v) for k, v in masks.items()},
                               weight_decay=0.1)
        T.adam_update(pt, {k: None if k == "b" else torch.tensor(v) for k, v in grads.items()},
                      st, lrs, masks, weight_decay=0.1)
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=5e-7)
            np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(sj.mu[k]), rtol=1e-6)
            np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-6)
            assert st.count[k] == int(sj.count[k])
    assert st.count == {"a": 2, "b": 2, "c": 1}
    assert not np.allclose(pt["c"].numpy(), params["c"])


@pytest.mark.parametrize("per_group", [False, True])
def test_clipping_matches_jax(per_group):
    """Clipped gradients and the pre-clip global norm; a missing gradient
    (None) counts as zeros and stays None."""
    grads = _tree(3)
    grads["a"] *= 10.0
    labels = {"a": "backbone", "b": "add_on", "c": "add_on"}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jg["b"] = jnp.zeros_like(jg["b"])
    cj, nj = J.clip_gradients(jg, labels, 2.0, per_group=per_group)
    tg = {k: torch.tensor(v) for k, v in grads.items()}
    tg["b"] = None
    ct, nt = T.clip_gradients(tg, labels, 2.0, per_group=per_group)
    assert ct["b"] is None
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    for k in ("a", "c"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=1e-6)


@pytest.mark.parametrize("t", [0.0, 3.0, 50.0, 99.5, 100.0, 140.0])
def test_schedules_match_jax(t):
    """Python floats in the port, f32 in the JAX package: equal to f32
    rounding (1e-6 of the 1e-3 base rate)."""
    assert T.cosine_annealing(1e-3, 5e-6, t, 100.0) == pytest.approx(
        float(J.cosine_annealing(1e-3, 5e-6, t, 100.0)), abs=1e-9)
    frac = t / 7.0
    assert T.cosine_warm_restarts(1e-3, 1e-3 * 0.01, frac, 5.0) == pytest.approx(
        float(J.cosine_warm_restarts(1e-3, 1e-3 * 0.01, frac, 5.0)), abs=1e-9)


def test_phases_and_trainable_groups_match_jax():
    """Every epoch of the flagship schedule, pretrain and not: the same
    phase, and the same trainable groups in it; masks and learning rates
    agree for every group."""
    jcfg, tcfg = flagship_configs()
    labels = {g: g for g in J.GROUP_TO_OPT}
    for pretrain in (True, False):
        for epoch in range(0, tcfg.train.epochs + 2):
            pj = J.phase_for_epoch(epoch, jcfg.train, pretrain=pretrain)
            pt = T.phase_for_epoch(epoch, tcfg.train, pretrain=pretrain)
            assert pt.__dict__ == pj.__dict__
            for g in J.GROUP_TO_OPT:
                assert T.group_trainable(g, pt) == J.group_trainable(g, pj), (epoch, g)
            mt, lt = T.masks_and_lrs(labels, pt, tcfg.train.optim, lambda b: 0.5 * b,
                                     lambda b: 0.25 * b, lambda b: 0.125 * b)
            mj, lj = J.masks_and_lrs(labels, pj, jcfg.train.optim, lambda b: 0.5 * b,
                                     lambda b: 0.25 * b, backbone_factor=lambda b: 0.125 * b)
            assert mt == {g: bool(m) for g, m in mj.items()}
            assert lt == pytest.approx({g: float(v) for g, v in lj.items()})
    names = {T.phase_for_epoch(e, tcfg.train, pretrain=False).name for e in range(42)}
    assert names == {"finetune_classifier", "finetune", "train", "mask_only"}
