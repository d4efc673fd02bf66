"""decode_ms.serve (ms): the joint leaf decode of one batch's logits, alone, by CUDA events over five calls.
Layer: the joint decode (`models/pipnet.py::joint_leaf_log_distribution`)."""

from ..tracing import cuda_time_ms

MOVES = "serve_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["decode"])
