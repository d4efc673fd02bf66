"""mfu.serve (%): the whole batch's share of the card's bf16 peak (989
TFLOP/s): the model's forward operations for the batch
(`flops.model_flops`), times the batches of the traced window, over the
window.  Layer: the device."""

from .. import flops

MOVES = "serve_images_per_s"


def read(ctx):
    s, cell = ctx.cell.shapes(), ctx.cell
    per_batch = flops.model_flops(cell.config["published"], s["prototypes"], s["children"],
                                  s["images"], training=False)
    return 100.0 * per_batch * ctx.window["steps"] / ctx.window["window_s"] / flops.PEAK_BF16
