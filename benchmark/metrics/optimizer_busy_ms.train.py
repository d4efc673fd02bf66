"""optimizer_busy_ms.train (ms): device time a step, in the traced window,
of the operations put down to the program's ``clip`` and ``adamw`` spans
(``benchmark/spans.py``): clipping and the AdamW update.  The in-step
counterpart of ``optimizer_ms.train``.  Layer: the optimiser
(`train/optimizer.py`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("clip", "adamw"))
