"""idle_share.train (%): the share of the traced window in which no
operation ran on the device, 1 - (union of the kernels' intervals) /
window.  Layer: the device."""

MOVES = "train_images_per_s"


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return 100.0 * ctx.trace.idle_share()
