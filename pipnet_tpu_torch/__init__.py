"""PyTorch / CUDA port of pipnet_tpu for NVIDIA Hopper (H100).

The JAX package ``pipnet_tpu`` is the reference; this package imports
nothing of it and nothing of JAX.  The first slice serves the flagship
HComP-Net: ``serve.Predictor`` over ``models.pipnet.PIPNet``, whose prototype
head runs the hand-written CUDA kernel ``ops/csrc/fused_head.cu`` (K1).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
