"""One train step of the port on a (2, 2) mesh of four gloo ranks against
the JAX package's step on ``dp_mp_mesh(2, 2)`` of the host devices
(``tests/conftest.py`` forces eight; its XLA head, as the JAX Trainer runs
on a model axis), from the same parameters (``params_from_jax``), batch and
presence sample: the setup and bars of ``tests/test_torch_mesh_jax.py``, on
the multi-bucket tree whose last node the model boundary cuts.

The JAX step on that mesh doubles the gradient of every trained depthwise
kernel (``feature_group_count`` convolutions, stages 2 and 3 in this
phase): its first moments of those kernels are twice its data mesh's
(``tests/test_torch_mesh_jax.py``, which the port's steps equal), and its
gradient norm counts them twice.  The port does not carry that fault: the
test holds the JAX step to the port's with those gradients doubled, and
everything else at the data mesh's bars."""

from test_torch_mesh_jax import check_against_jax

# the trained depthwise kernels of the narrow ConvNeXt (stages 0 and 1 are
# frozen at epoch 20)
DOUBLED = ("backbone.stage2_block0.dwconv.weight", "backbone.stage2_block1.dwconv.weight",
           "backbone.stage3_block0.dwconv.weight")


def test_model_axis_step_matches_the_jax_dp_mp_mesh_step(tmp_path):
    check_against_jax(tmp_path, world=4, n_model=2, doubled=DOUBLED)
