"""augment_busy_ms.train (ms): device time a step, in the traced window,
of the operations that the program's ``fetch``, ``to_device`` and
``augment`` spans caused (``benchmark/spans.py``): the batch's rows
copied and gathered from the cache, the labels sent, the draws and both
views.  The in-step counterpart of ``augment_ms.train``.  Layer: the
device data path (`data/device_cache.py`, `train/step.py::augment_views`,
`ops/device_geometric.py`, `ops/device_augment.py`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("fetch", "to_device", "augment"))
