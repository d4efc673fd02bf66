"""losses_ms.train (ms): `compute_total_loss` forward and backward on one batch's outputs, alone, by CUDA events over five calls.
Layer: the losses (`losses/catalog.py`, `losses/aggregate.py`).  Alone: the part runs outside the step, so the parts need
not add up to the step."""

from ..tracing import cuda_time_ms

MOVES = "train_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["losses"])
