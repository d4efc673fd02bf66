"""head_ms.train (ms): the forward and backward of the features of one batch, alone, by CUDA events over five calls.
Layer: the head (`models/heads.py`, `ops/fused_head.py`: K1 and K1b).  Alone: the part runs outside the step, so the parts need
not add up to the step."""

from ..tracing import cuda_time_ms

MOVES = "train_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["head"])
