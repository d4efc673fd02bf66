"""mfu.train (%): the whole step's share of the card's bf16 peak (989
TFLOP/s): the model's forward and backward operations for the cell's
shapes (`flops.model_flops`, with the uniformity loss's pair products
where the cell trains it, `flops.uniformity_flops`), times the steps of
the traced window, over the window.  Layer: the device."""

from .. import flops

MOVES = "train_images_per_s"


def read(ctx):
    s, cell = ctx.cell.shapes(), ctx.cell
    per_step = flops.model_flops(cell.config["published"], s["prototypes"], s["children"],
                                 s["images"], training=True)
    if cell.cfg.train.loss.uni:
        per_step += flops.uniformity_flops(s["images"] // 2 * s["side"] ** 2, s["dim"])
    return 100.0 * per_step * ctx.window["steps"] / ctx.window["window_s"] / flops.PEAK_BF16
