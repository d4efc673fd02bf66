"""k1_roofline.train (%): K1's share of its roofline (`ops/csrc/fused_head.cu`).
Its device time by kernel name over the traced window, per call (one call
a step, however many launches its plan takes), against the least time
the card could take for the cell's shapes (`flops.k1_cost`: F, K and pf
read or written once, pooled in f32, the product over the real
prototypes; bf16 products on the tensor-core peak, f32 on the SIMT peak).
Layer: the kernels."""

from .. import flops

MOVES = "train_images_per_s"


def is_k1(name: str) -> bool:
    return "fused_head_bf16" in name or "fused_head_f32" in name


def read(ctx):
    seconds, launches = ctx.trace.device_seconds(is_k1)
    calls = ctx.window["steps"]
    if not launches or not calls:
        return None
    s = ctx.cell.shapes()
    rows = s["images"] * s["side"] ** 2
    nbytes, ops = flops.k1_cost(rows, s["dim"], s["prototypes"], s["images"])
    bf16 = s["dtype"] == "bfloat16"
    least = flops.bound_s(nbytes, bf16_ops=ops if bf16 else 0.0, f32_ops=0.0 if bf16 else ops)
    return 100.0 * least / (seconds / calls)
