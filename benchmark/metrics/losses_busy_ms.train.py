"""losses_busy_ms.train (ms): device time a step, in the traced window, of
the operations put down to the program's ``losses`` span
(``benchmark/spans.py``): the loss catalog's forward and its backward.
The in-step counterpart of ``losses_ms.train``.  Layer: the losses
(`losses/catalog.py`, `losses/aggregate.py`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("losses",))
