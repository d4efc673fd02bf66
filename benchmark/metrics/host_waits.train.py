"""host_waits.train (count/step): the host's waits for the card a step in
the traced window (cudaStreamSynchronize, cudaEventSynchronize,
cudaDeviceSynchronize, aten::_local_scalar_dense).  Layer: the step
(``train/step.py::make_train_step``).  A wait drains the queue the host
had run ahead with, so fewer waits let the card stay busy."""

from ..tracing import HOST_WAITS

MOVES = "train_images_per_s"


def read(ctx):
    steps = ctx.window["steps"]
    if not steps or not ctx.trace.host:
        return None
    return sum(ctx.trace.host_calls(HOST_WAITS).values()) / steps
