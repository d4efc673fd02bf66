"""k1b_roofline.train (%): K1b's share of its roofline
(`ops/csrc/head_backward.cu`).  Its device time by kernel name over the
traced window, per step (one call, however many launches its plan takes),
against the least time the card could take for the cell's shapes
(`flops.k1b_cost`: pf, its cotangent and dz once each, the pooled
cotangent in f32; five f32 operations an element on the SIMT peak).
Layer: the kernels."""

from .. import flops

MOVES = "train_images_per_s"


def is_k1b(name: str) -> bool:
    return "head_backward" in name


def read(ctx):
    seconds, launches = ctx.trace.device_seconds(is_k1b)
    calls = ctx.window["steps"]
    if not launches or not calls:
        return None
    s = ctx.cell.shapes()
    rows = s["images"] * s["side"] ** 2
    nbytes, ops = flops.k1b_cost(rows, s["prototypes"], s["images"])
    return 100.0 * flops.bound_s(nbytes, f32_ops=ops) / (seconds / calls)
