"""The control's precision: the reference with every product in float8 or
int8, the steps below the bfloat16 that the configurations state, as an
fp8 or int8 training recipe runs them.

Each operand of ``F.conv2d``, ``F.linear``, the ``@`` operator and
``torch.einsum`` (the backbone's convolutions and dense layers, the head's
F K and classifier, the losses' products) is rounded to e4m3 with one
scale a tensor (its largest magnitude mapped to 448, e4m3's largest finite
value), and the gradient that reaches the product's output in the
backward is rounded to e5m2 the same way (largest 57344), so both the
forward and the backward products take float8 operands.  In int8 every
operand and output gradient is rounded to 255 levels symmetric about 0,
one scale a tensor (its largest magnitude mapped to 127).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _rounded(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / largest
    return ((x.detach().float() / scale).to(dtype).float() * scale).to(x.dtype)


def _int8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 127.0
    return (torch.round(x.detach().float() / scale).clamp(-127, 127) * scale).to(x.dtype)


LOWER = {"float8": (lambda x: _rounded(x, torch.float8_e4m3fn, E4M3_MAX),
                    lambda g: _rounded(g, torch.float8_e5m2, E5M2_MAX)),
         "int8": (_int8, _int8)}


def _round_operand(x: torch.Tensor, rnd) -> torch.Tensor:
    """``x`` rounded by ``rnd``, in ``x``'s dtype, with the identity as its
    gradient."""
    if x is None or not x.is_floating_point():
        return x
    with torch.no_grad():
        q = rnd(x)
    return x + (q - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient."""

    @staticmethod
    def forward(ctx, y, rnd):
        ctx.rnd = rnd
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def _round_grad(y: torch.Tensor, rnd) -> torch.Tensor:
    return _RoundGrad.apply(y, rnd) if y.requires_grad else y


def _lowered(product, operand, grad):
    def run(a, b, *args, **kw):
        return _round_grad(product(_round_operand(a, operand), _round_operand(b, operand),
                                   *args, **kw), grad)
    return run


@contextlib.contextmanager
def lower_products(precision: str = "float8"):
    """Within the block, ``F.conv2d``, ``F.linear``, ``@`` and two-operand
    ``torch.einsum`` take operands rounded to ``precision`` ("float8":
    e4m3, "int8"; biases stay as they are) and hand rounded gradients
    (e5m2, int8) to their backward."""
    operand, grad = LOWER[precision]
    saved = F.conv2d, F.linear, torch.Tensor.__matmul__, torch.einsum
    einsum = torch.einsum

    def einsum_lowered(eq, *ops):
        if len(ops) != 2:
            return einsum(eq, *ops)
        return _lowered(lambda a, b: einsum(eq, a, b), operand, grad)(*ops)

    F.conv2d, F.linear = _lowered(saved[0], operand, grad), _lowered(saved[1], operand, grad)
    torch.Tensor.__matmul__ = _lowered(saved[2], operand, grad)
    torch.einsum = einsum_lowered
    try:
        yield
    finally:
        F.conv2d, F.linear, torch.Tensor.__matmul__, torch.einsum = saved
