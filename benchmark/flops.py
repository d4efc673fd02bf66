"""Operations and bytes counted from shapes: the yardstick of the roofline
and MFU metrics.

The model's count is written out layer by layer for ConvNeXt-tiny with
PIP-Net's stride surgery (a downsampling conv whose input has more than
100 channels keeps stride 1), plus the prototype head; a multiply-add is
two operations.  The backward counts what a train step must compute: the
weight gradient of every layer that trains, and the input gradient of
every layer after the first one that trains (nothing before it needs one).
LayerNorm, GELU, softmax and the losses' element-wise work are left out,
so the count is a floor of the work.

The published peaks of one H100 SXM (dense) are NVIDIA's data sheet's, as
``chip_smoke.py::bound`` uses them: 989 TFLOP/s bf16, 67 TFLOP/s f32 off
the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32_SIMT = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, bf16_ops / PEAK_BF16 + f32_ops / PEAK_F32_SIMT)


@dataclass(frozen=True)
class Layer:
    name: str
    macs: int            # multiply-adds of the forward, per image
    group: str           # the optimizer group (models/convnext.py's partition)


def convnext_layers(image_size: int, depths: Sequence[int], dims: Sequence[int],
                    stride_threshold: int = 100) -> List[Layer]:
    """Each layer of the backbone with its forward multiply-adds for one
    image: stem 4x4/4, per stage a 2x2 downsampling (stride 2, or 1 after
    the surgery) and blocks of a 7x7 depthwise conv and the 4x MLP."""
    groups = {0: "frozen", 1: "frozen", 2: "backbone", 3: "freeze"}
    h = image_size // 4
    out = [Layer("stem_conv", h * h * 4 * 4 * 3 * dims[0], "frozen")]
    for s, (depth, c) in enumerate(zip(depths, dims)):
        if s > 0:
            cin = dims[s - 1]
            stride = 1 if cin > stride_threshold else 2
            h = (h - 2) // stride + 1
            out.append(Layer(f"down{s}_conv", h * h * 2 * 2 * cin * c, groups[s]))
        for b in range(depth):
            group = "train" if (s == len(depths) - 1 and b == depth - 1) else groups[s]
            out.append(Layer(f"stage{s}_block{b}", h * h * (49 * c + 8 * c * c), group))
    return out


def latent_side(image_size: int, depths: Sequence[int], dims: Sequence[int],
                stride_threshold: int = 100) -> int:
    h = image_size // 4
    for s in range(1, len(depths)):
        h = (h - 2) // (1 if dims[s - 1] > stride_threshold else 2) + 1
    return h


def model_flops(published, prototypes: int, children: int, images: int,
                training: bool, frozen: Tuple[str, ...] = ("frozen",)) -> float:
    """Operations of a forward (and, with ``training``, the backward) of
    ``images`` images: the backbone, the add-on product z = F K over the
    real prototypes and the classifier."""
    layers = convnext_layers(published["image_size"], published["depths"], published["dims"])
    side = latent_side(published["image_size"], published["depths"], published["dims"])
    head = side * side * published["dims"][-1] * prototypes + prototypes * children
    fwd = sum(l.macs for l in layers) + head
    if not training:
        return 2.0 * images * fwd
    trains = [l.group not in frozen for l in layers]
    first = trains.index(True) if any(trains) else len(layers)
    bwd = sum(l.macs for l, t in zip(layers, trains) if t)            # weight gradients
    bwd += sum(l.macs for l in layers[first + 1:])                     # input gradients
    bwd += 2 * head                                                    # dF, dK (and classifier)
    return 2.0 * images * (fwd + bwd)


def uniformity_flops(rows: int, dim: int, views: int = 2) -> float:
    """The uniformity loss's pair products for ``rows`` patch rows of
    ``dim`` per view: the forward's Gram over pairs i < j and the
    backward's m x, not its recomputation of the Gram."""
    return views * 2.0 * dim * (rows * (rows - 1) / 2.0 + rows * rows)


def k1_cost(rows: int, dim: int, prototypes: int, images: int) -> Tuple[float, float]:
    """K1 (bf16) for ``rows`` patch rows of ``images`` images: (bytes,
    operations).  F, K and pf in bf16 read or written once, pooled in f32;
    the product over the real prototypes."""
    nbytes = 2.0 * (rows * dim + dim * prototypes + rows * prototypes) + 4.0 * images * prototypes
    return nbytes, 2.0 * rows * dim * prototypes


def k1b_cost(rows: int, prototypes: int, images: int) -> Tuple[float, float]:
    """K1b (bf16 in, f32 arithmetic): pf and its cotangent read, dz written,
    each in bf16, the pooled cotangent in f32; five operations an element
    (``chip_smoke.py::check_head_backward``'s count)."""
    nbytes = 2.0 * 3 * rows * prototypes + 4.0 * images * prototypes
    return nbytes, 5.0 * rows * prototypes
