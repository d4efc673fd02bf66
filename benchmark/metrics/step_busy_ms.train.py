"""step_busy_ms.train (ms): device time a step, in the traced window, of
every operation put down to the program's ``step`` span or a span inside
it (``benchmark/spans.py``): the whole train step on the device, without
the batch's fetch and the labels' copy, which the caller issues.  Layer:
the step (`train/step.py::make_train_step`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.busy_ms(("step",))
