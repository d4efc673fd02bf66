"""decode_busy_ms.serve (ms): device time a batch, in the traced window,
of the operations put down to the program's ``decode`` span
(``benchmark/spans.py``): the joint leaf decode in
``Predictor.forward``.  The in-batch counterpart of ``decode_ms.serve``.
Layer: the joint decode (`models/pipnet.py::joint_leaf_log_distribution`)."""

from .. import spans

MOVES = "serve_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("decode",))
