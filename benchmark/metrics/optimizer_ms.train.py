"""optimizer_ms.train (ms): clipping and the AdamW update of every leaf, alone, by CUDA events over five calls.
Layer: the optimiser (`train/optimizer.py`).  Alone: the part runs outside the step, so the parts need
not add up to the step."""

from ..tracing import cuda_time_ms

MOVES = "train_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["optimizer"])
