"""k5_roofline.train (%): K5 and K5b's share of their roofline
(`ops/csrc/uniform_pairs.cu`, the uniformity loss's pair sum and its
gradient).  The device time of the kernels whose name holds
`uniform_pairs` over the traced window, per step, against the least time
the card could take for the cell's uniformity products
(`flops.uniformity_flops`: the forward's pairs i < j and the backward's
m x over both views' patch rows, on the bf16 peak).  None where no such
kernel ran (a cell without the uniformity loss, or a program without the
kernels).  Layer: the kernels."""

from .. import flops

MOVES = "train_images_per_s"


def is_k5(name: str) -> bool:
    return "uniform_pairs" in name


def read(ctx):
    seconds, launches = ctx.trace.device_seconds(is_k5)
    steps = ctx.window["steps"]
    if not launches or not steps:
        return None
    s = ctx.cell.shapes()
    rows = s["images"] // 2 * s["side"] ** 2
    least = flops.bound_s(0.0, bf16_ops=flops.uniformity_flops(rows, s["dim"]))
    return 100.0 * least / (seconds / steps)
