"""Matrix products at a stated precision, for the reference and its
controls: the product's operands are rounded to the precision, then
multiplied exactly and summed in float32 (TF32 is turned off for the f32
product itself).  The roundings are emulated, so a control reads the same
on the card and on the CPU.

* ``float32``: the configuration's precision for the f32 models;
* ``tf32``: the f32 models' control (TF32's 10-bit mantissa, round to
  nearest even);
* ``bfloat16``: the served vanilla model's precision (the fused MLP's bf16
  operands, f32 sums);
* ``fp8``: its control (float8 e4m3, each operand scaled by its largest
  magnitude over 448, the format's largest finite value).
"""

import torch

Tensor = torch.Tensor

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
FP8_MAX = 448.0


def round_tf32(x: Tensor) -> Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def round_fp8(x: Tensor) -> Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {
    "float32": lambda x: x,
    "tf32": round_tf32,
    "bfloat16": lambda x: x.to(torch.bfloat16).to(torch.float32),
    "fp8": round_fp8,
}


class _RoundedMatmul(torch.autograd.Function):
    """``round(a) @ round(b)``, and its two backward products with their
    operands rounded the same way (a training step at that precision)."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return torch.matmul(rnd(a), rnd(b))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        g = rnd(grad.contiguous())
        return torch.matmul(g, rnd(b).t()), torch.matmul(rnd(a).t(), g), None


def matmul_at(precision: str):
    """``matmul(a [N, K], b [K, M])`` with both operands rounded to
    ``precision``, in the forward and the backward."""
    if precision not in ROUNDING:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "float32":
        return torch.matmul
    rnd = ROUNDING[precision]
    return lambda a, b: _RoundedMatmul.apply(a.float(), b.float(), rnd)


def f32_products() -> None:
    """Turn TF32 off for matmuls and cuDNN (the f32 products stay f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
