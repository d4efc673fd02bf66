"""idle_in_step_share.train (%): the share of the traced window's idle
time (the window less the union of the device's operations) that falls
inside the program's ``step`` spans, on the trace's clock
(``benchmark/spans.py``): the card waiting while the host runs the step's
own code, against waiting while the caller runs between steps.  Of
``idle_share.train``'s idle time.  Layer: the step
(`train/step.py::make_train_step`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.idle_share_in("step")
