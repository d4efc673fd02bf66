"""idle_in_forward_share.serve (%): the share of the traced window's idle
time (the window less the union of the device's operations) that falls
inside the program's ``serve`` spans, on the trace's clock
(``benchmark/spans.py``): the card waiting while the host runs
``Predictor.forward``, against waiting while the caller sends, copies
and reads answers.  Of ``idle_share.serve``'s idle time.  Layer: the
served forward (`serve.py::Predictor.forward`)."""

from .. import spans

MOVES = "serve_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.idle_share_in("serve")
