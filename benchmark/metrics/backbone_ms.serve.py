"""backbone_ms.serve (ms): the backbone forward of one batch of 64, alone, by CUDA events over five calls.
Layer: the backbone (`models/convnext.py`)."""

from ..tracing import cuda_time_ms

MOVES = "serve_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["backbone"])
