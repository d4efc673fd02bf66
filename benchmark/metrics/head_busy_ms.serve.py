"""head_busy_ms.serve (ms): device time a batch, in the traced window, of
the operations put down to the program's ``head`` span inside a
``serve`` span (``benchmark/spans.py``): K1 and the classifier as
``Predictor.forward`` runs them.  Layer: the head (`models/heads.py`,
`ops/fused_head.py`)."""

from .. import spans

MOVES = "serve_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("head",), under="serve")
