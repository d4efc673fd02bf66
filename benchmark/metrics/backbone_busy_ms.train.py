"""backbone_busy_ms.train (ms): device time a step, in the traced window,
of the operations put down to the program's ``backbone`` span inside a
``step`` (``benchmark/spans.py``): the backbone's forward and, through
the backward nodes' links to it, its backward.  The in-step counterpart
of ``backbone_ms.train``.  Layer: the backbone (`models/convnext.py`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("backbone",), under="step")
