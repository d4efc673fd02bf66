"""host_wait_ms.train (ms): the host's time a step, in the traced window,
inside the program's ``augment.wait`` span (``benchmark/spans.py``): the
step's one wait for the augmentation's op counts, the time behind
``host_waits.train``.  Layer: the step (`train/step.py::sample_augment`)."""

from .. import spans

MOVES = "train_images_per_s"


def read(ctx):
    found = spans.of(ctx)
    return None if found is None else found.host_ms("augment.wait")
