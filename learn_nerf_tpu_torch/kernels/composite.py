"""The occupancy renderer's transmittance scan, termination weights and
blend, forward and backward: the CUDA kernels, their plain version and the
autograd function.

The JAX package's ``termination_weights`` + ``composite`` +
``composite_alpha`` (``learn_nerf_tpu/ops/volume.py:41-93``, called at
``learn_nerf_tpu/occ_render.py:217-221``) and their VJP, which it leaves to
XLA: ``render_composite(densities [N, K], dt [N, 1], rgbs [N, K, 3],
background [3], mask [N]) -> (outputs [N, 3], weights [N, K+1],
alphas [N, 1])``, where every sample of a ray stands for the same bin width
``dt``, the background is the last weight column (rows sum to 1), and a
masked ray returns the background and alpha 0
(``csrc/composite.cu``: ``composite_forward_kernel`` and
``composite_backward_kernel``, one warp per ray, K <= 64).

The backward takes cotangents for all three outputs (an unused output's is
zero), so what reads ``weights`` downstream keeps its gradient.  With
``G_t = dL/dw_t + dL/dout . rgb_t`` (``. background - dL/dalpha`` for the
last column), ``dL/d(density_t dt) = G_t (T_t - w_t) - sum_{j>t} G_j w_j``:
a reverse suffix sum.

:func:`render_composite` runs the plain version for CPU tensors (the ops of
:mod:`..ops.volume` under plain autograd) and the kernels for CUDA tensors,
with no fallback between the two.
"""

from typing import Optional, Tuple

import torch

from ..ops.volume import composite, composite_alpha, termination_weights
from . import build

Tensor = torch.Tensor

# Forward launches and plain calls; the backward kernel's launches.
counter = build.LaunchCounter()
backward_counter = build.LaunchCounter()

# Samples per ray the kernels take: two per lane of a warp (csrc
# kCompositeMaxSamples).
MAX_SAMPLES = 64


def render_composite_reference(
    densities: Tensor, dt: Tensor, rgbs: Tensor, background: Tensor, mask: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version, differentiable by autograd."""
    weights = termination_weights(densities, dt.expand(densities.shape))
    return composite(weights, rgbs, background, mask), weights, composite_alpha(weights, mask)


def _check(densities: Tensor, dt: Tensor, rgbs: Tensor, background: Tensor, mask: Tensor) -> None:
    n, k = densities.shape if densities.dim() == 2 else (-1, -1)
    device = densities.device
    if device.type != "cuda":
        raise ValueError(f"want tensors on a CUDA device; got {device}")
    if not 1 <= k <= MAX_SAMPLES:
        raise ValueError(
            f"the composite kernels take 1 to {MAX_SAMPLES} samples per ray (one warp per ray, "
            f"two samples per lane); got densities {tuple(densities.shape)}"
        )
    wanted = (
        ("densities", densities, (n, k), torch.float32),
        ("dt", dt, (n, 1), torch.float32),
        ("rgbs", rgbs, (n, k, 3), torch.float32),
        ("background", background, (3,), torch.float32),
        ("mask", mask, (n,), torch.bool),
    )
    for name, value, shape, dtype in wanted:
        if (value.dtype != dtype or tuple(value.shape) != shape or value.device != device
                or not value.is_contiguous()):
            raise ValueError(
                f"want {name} contiguous {dtype} {shape} on {device}; got {value.dtype} "
                f"{tuple(value.shape)} on {value.device}"
            )
    if n * (k + 1) >= 2**31:
        raise ValueError(f"{n} rays x {k} samples exceed the kernels' 32-bit ray count")


def composite_forward_cuda(
    densities: Tensor, dt: Tensor, rgbs: Tensor, background: Tensor, mask: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the forward kernel on the current stream (contiguous f32
    inputs on the card, a bool mask)."""
    _check(densities, dt, rgbs, background, mask)
    n, k = densities.shape
    device = densities.device
    build.require_hopper(device)
    outputs = torch.empty((n, 3), dtype=torch.float32, device=device)
    weights = torch.empty((n, k + 1), dtype=torch.float32, device=device)
    alphas = torch.empty((n, 1), dtype=torch.float32, device=device)
    if n == 0:
        return outputs, weights, alphas
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_forward(
            densities.data_ptr(), dt.data_ptr(), rgbs.data_ptr(), background.data_ptr(),
            mask.data_ptr(), n, k, outputs.data_ptr(), weights.data_ptr(), alphas.data_ptr(),
            build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_forward")
    counter.launches += 1
    return outputs, weights, alphas


def composite_backward_cuda(
    densities: Tensor,
    dt: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    grad_outputs: Optional[Tensor],
    grad_weights: Optional[Tensor],
    grad_alphas: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch the backward kernel on the current stream; a ``None``
    cotangent is zero.

    :return: gradients of ``(densities, dt, rgbs, background)``.
    """
    _check(densities, dt, rgbs, background, mask)
    n, k = densities.shape
    device = densities.device
    cotangents = []
    for name, value, shape in (("outputs", grad_outputs, (n, 3)),
                               ("weights", grad_weights, (n, k + 1)),
                               ("alphas", grad_alphas, (n, 1))):
        if value is not None:
            value = value.float().contiguous()
            if tuple(value.shape) != shape or value.device != device:
                raise ValueError(f"want the cotangent of {name} {shape} on {device}; got "
                                 f"{tuple(value.shape)} on {value.device}")
        cotangents.append(value)
    build.require_hopper(device)
    grad_densities = torch.empty_like(densities)
    grad_dt = torch.empty_like(dt)
    grad_rgbs = torch.empty_like(rgbs)
    grad_background = torch.zeros_like(background)
    if n == 0:
        return grad_densities, grad_dt, grad_rgbs, grad_background
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_backward(
            densities.data_ptr(), dt.data_ptr(), rgbs.data_ptr(), background.data_ptr(),
            mask.data_ptr(), *(None if c is None else c.data_ptr() for c in cotangents), n, k,
            grad_densities.data_ptr(), grad_dt.data_ptr(), grad_rgbs.data_ptr(),
            grad_background.data_ptr(), build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_backward")
    backward_counter.launches += 1
    return grad_densities, grad_dt, grad_rgbs, grad_background


class RenderComposite(torch.autograd.Function):
    """Forward and backward kernels as one differentiable function of
    ``(densities, dt, rgbs, background)``."""

    @staticmethod
    def forward(ctx, densities, dt, rgbs, background, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(densities, dt, rgbs, background, mask)
        return _forward_launcher(densities, dt, rgbs, background, mask)

    @staticmethod
    def backward(ctx, grad_outputs, grad_weights, grad_alphas):
        grads = _backward_launcher(*ctx.saved_tensors, grad_outputs, grad_weights, grad_alphas)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


# The launches behind RenderComposite; a CPU test swaps in plain versions to
# hold the autograd wiring where there is no card.
_forward_launcher = composite_forward_cuda
_backward_launcher = composite_backward_cuda


def render_composite(
    densities: Tensor, dt: Tensor, rgbs: Tensor, background: Tensor, mask: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Scan, weights and blend of one batch of rays.

    :param densities: ``[N, K]`` non-negative densities (0 in padding slots).
    :param dt: ``[N, 1]`` bin width of every sample of the ray.
    :param rgbs: ``[N, K, 3]`` per-sample colours.
    :param background: ``[3]`` background colour.
    :param mask: ``[N]`` bool; a masked-out ray returns the background.
    :return: ``(outputs [N, 3], weights [N, K+1], alphas [N, 1])``.
    """
    if densities.device.type == "cpu":
        counter.plain_calls += 1
        return render_composite_reference(densities, dt, rgbs, background, mask)
    return RenderComposite.apply(
        densities.float().contiguous(), dt.float().contiguous(), rgbs.float().contiguous(),
        background.float().contiguous(), mask.contiguous(),
    )
