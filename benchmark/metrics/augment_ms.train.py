"""augment_ms.train (ms): a fetch from the cache, the draws and both views of one batch, alone, by CUDA events over five calls.
Layer: the device data path (`data/device_cache.py`, `train/step.py::augment_views`, `ops/device_geometric.py`, `ops/device_augment.py`).  Alone: the part runs outside the step, so the parts need
not add up to the step."""

from ..tracing import cuda_time_ms

MOVES = "train_images_per_s"


def read(ctx):
    return cuda_time_ms(ctx.parts()["augment"])
