"""head_busy_ms.train (ms): device time a step, in the traced window, of
the operations put down to the program's ``head`` span inside a ``step``
(``benchmark/spans.py``): the head's forward (K1) and its backward (K1b).
The in-step counterpart of ``head_ms.train``.  Layer: the head
(`models/heads.py`, `ops/fused_head.py`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("head",), under="step")
