"""backbone_busy_ms.serve (ms): device time a batch, in the traced window,
of the operations put down to the program's ``backbone`` span inside a
``serve`` span (``benchmark/spans.py``): the backbone's forward as
``Predictor.forward`` runs it.  The in-batch counterpart of
``backbone_ms.serve``.  Layer: the backbone (`models/convnext.py`)."""

from .. import spans

MOVES = "serve_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("backbone",), under="serve")
