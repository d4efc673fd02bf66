"""PyTorch / CUDA port of pipnet_tpu for NVIDIA Hopper (H100).

The JAX package ``pipnet_tpu`` is the reference; this package imports
nothing of it and nothing of JAX.  It serves the flagship HComP-Net
(``serve.Predictor`` over ``models.pipnet.PIPNet``, whose prototype head
runs the hand-written CUDA kernel ``ops/csrc/fused_head.cu``, K1) and trains
it (``train.step.make_train_step``, with K1's adjoint
``ops/csrc/head_backward.cu`` and the no-pf head ``ops/csrc/fused_head_nopf.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
