"""Both renderers' transmittance scan, termination weights and blends,
forward and backward: the CUDA kernels, their plain version and the
autograd function.

The JAX package's ``termination_weights`` + ``composite`` +
``composite_alpha`` + the ``coords`` blend + ``average_aux``
(``learn_nerf_tpu/ops/volume.py:41-124``, called at
``learn_nerf_tpu/render.py:73-79`` and ``learn_nerf_tpu/occ_render.py:217-222``)
and their VJP, which it leaves to XLA: ``render_composite(densities [N, K],
deltas [N, 1] or [N, K], rgbs [N, K, 3], background [3], mask [N],
extras [N, K, C] or None) -> (outputs [N, 3], weights [N, K+1],
alphas [N, 1], extras_out [N, C] or None)``.  ``deltas`` is one bin width
per ray (the occupancy path) or one per sample (the hierarchy's
``bin_deltas``); the background is the last weight column (rows sum to 1); a
masked ray returns the background, alpha 0 and zero extras.  ``extras``
carries the sample points (``coords`` is ``extras_out[:, :3]``) and any
per-sample aux losses after them (each aux mean is its column's mean over
rays: ``average_aux``'s masked mean).

``csrc/composite.cu``: ``composite_forward_kernel`` and
``composite_backward_kernel``, one warp per ray, any K (registers up to 64
samples, a chunk loop beyond), C <= 8.  The backward takes cotangents for
all four outputs (an unused output's is zero), so what reads ``weights``
downstream keeps its gradient.  With ``G_t = dL/dw_t + dL/dout . rgb_t +
dL/dextras_out . extra_t`` (``dL/dout . background - dL/dalpha`` for the
last column), ``dL/d(density_t delta_t) = G_t (T_t - w_t) - sum_{j>t} G_j
w_j``: a reverse suffix sum.  The background's gradient is summed by the
last block in a fixed order: no memset, the same bits every run.

:func:`render_composite` runs the plain version for CPU tensors (the ops of
:mod:`..ops.volume` under plain autograd) and the kernels for CUDA tensors,
with no fallback between the two.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.volume import composite, composite_alpha, termination_weights
from . import build

Tensor = torch.Tensor
Outputs = Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]

# Forward launches and plain calls; the backward kernel's launches.
counter = build.LaunchCounter()
backward_counter = build.LaunchCounter()

# Rays per block (csrc kCompositeWarps: one warp per ray), and the extras'
# widest row (kCompositeMaxExtras).  Any number of samples per ray.
RAYS_PER_BLOCK = 8
MAX_EXTRAS = 8


def render_composite_reference(
    densities: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor] = None,
) -> Outputs:
    """Plain PyTorch version, differentiable by autograd."""
    weights = termination_weights(densities, deltas.expand(densities.shape))
    outputs = composite(weights, rgbs, background, mask)
    blended = None
    if extras is not None:
        blended = composite(weights, extras, background.new_zeros(extras.shape[-1]), mask)
    return outputs, weights, composite_alpha(weights, mask), blended


_NAMES = ("densities", "deltas", "rgbs", "background", "mask", "extras")
_DTYPES = (torch.float32,) * 4 + (torch.bool, torch.float32)


def _prepared(densities, deltas, rgbs, background, mask, extras):
    """The inputs as the kernels take them (contiguous; a view that is not
    is copied), after one check of type, shape and device (all on one).
    Also whether the widths are per sample."""
    if densities.dim() != 2 or densities.shape[1] < 1:
        raise ValueError(f"want densities [N, K] with K >= 1; got {tuple(densities.shape)}")
    n, k = densities.shape
    per_sample = k > 1 and deltas.dim() == 2 and deltas.shape[1] == k
    tensors = [densities, deltas, rgbs, background, mask]
    shapes = [(n, k), (n, k) if per_sample else (n, 1), (n, k, 3), (3,), (n,)]
    c = 0
    if extras is not None:
        c = extras.shape[-1]
        if not 1 <= c <= MAX_EXTRAS:
            raise ValueError(f"the composite kernels blend 1 to {MAX_EXTRAS} extras; got {tuple(extras.shape)}")
        tensors.append(extras)
        shapes.append((n, k, c))
    if n * (k + 1) >= 2**31 or n * k * max(c, 3) >= 2**31:
        raise ValueError(f"{n} rays x {k} samples exceed the kernels' 32-bit counts")
    index = densities.get_device()
    for i, (value, shape, dtype) in enumerate(zip(tensors, shapes, _DTYPES)):
        if value.dtype != dtype or value.shape != shape or value.get_device() != index:
            raise ValueError(
                f"want {_NAMES[i]} {dtype} {shape} on {densities.device}; got {value.dtype} "
                f"{tuple(value.shape)} on {value.device}"
            )
        if not value.is_contiguous():
            tensors[i] = value.contiguous()
    if extras is None:
        tensors.append(None)
    return (*tensors, per_sample)


def _require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"want tensors on a CUDA device; got {device}")
    build.require_hopper(device)


def _ptr(value: Optional[Tensor]):
    return None if value is None else value.data_ptr()


def composite_forward_cuda(
    densities: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor] = None,
) -> Outputs:
    """Launch the forward kernel on the current stream (f32 inputs on the
    card, a bool mask); ``extras_out`` is ``None`` without extras."""
    return _launch_forward(*_prepared(densities, deltas, rgbs, background, mask, extras))


def _launch_forward(densities, deltas, rgbs, background, mask, extras, per_sample) -> Outputs:
    """The forward launch on inputs that :func:`_prepared` passed."""
    n, k = densities.shape
    c = 0 if extras is None else extras.shape[-1]
    device = densities.device
    _require_card(device)
    outputs = torch.empty((n, 3), dtype=torch.float32, device=device)
    weights = torch.empty((n, k + 1), dtype=torch.float32, device=device)
    alphas = torch.empty((n, 1), dtype=torch.float32, device=device)
    blended = None if extras is None else torch.empty((n, c), dtype=torch.float32, device=device)
    if n == 0:
        return outputs, weights, alphas, blended
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_forward(
            densities.data_ptr(), deltas.data_ptr(), rgbs.data_ptr(), background.data_ptr(),
            mask.data_ptr(), _ptr(extras), n, k, c, per_sample,
            outputs.data_ptr(), weights.data_ptr(), alphas.data_ptr(), _ptr(blended),
            build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_forward")
    counter.launches += 1
    return outputs, weights, alphas, blended


# Per device, the backward's scratch: a ticket counter for its last-block
# sum (zeroed once, then reset by every launch) and one slot of 3 floats a
# block (never zeroed).  Launches that share them run in stream order.
_scratch: Dict[torch.device, Tuple[Tensor, Tensor]] = {}


def _background_scratch(device: torch.device, blocks: int) -> Tuple[Tensor, Tensor]:
    ticket, partials = _scratch.get(device, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < 3 * blocks:
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=device)
        _scratch[device] = (ticket, partials)
    return ticket, partials


def composite_backward_cuda(
    densities: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor],
    grad_outputs: Optional[Tensor],
    grad_weights: Optional[Tensor],
    grad_alphas: Optional[Tensor],
    grad_extras_out: Optional[Tensor] = None,
    wanted: Sequence[bool] = (True, True, True, True),
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor], Optional[Tensor], Optional[Tensor]]:
    """Launch the backward kernel on the current stream; a ``None``
    cotangent is zero.  ``wanted`` says which of the gradients of
    ``(deltas, rgbs, background, extras)`` to write (the densities' always
    is).

    :return: gradients of ``(densities, deltas, rgbs, background, extras)``,
        ``None`` where not wanted.
    """
    inputs = _prepared(densities, deltas, rgbs, background, mask, extras)
    return _launch_backward(*inputs, grad_outputs, grad_weights, grad_alphas, grad_extras_out, wanted)


def _launch_backward(densities, deltas, rgbs, background, mask, extras, per_sample, grad_outputs,
                     grad_weights, grad_alphas, grad_extras_out, wanted):
    """The backward launch on inputs that :func:`_prepared` passed; checks
    the cotangents."""
    n, k = densities.shape
    c = 0 if extras is None else extras.shape[-1]
    device, index = densities.device, densities.get_device()
    cotangents = [grad_outputs, grad_weights, grad_alphas, grad_extras_out]
    for i, shape in enumerate(((n, 3), (n, k + 1), (n, 1), (n, c))):
        value = cotangents[i]
        if value is None:
            continue
        if value.dtype != torch.float32 or value.shape != shape or value.get_device() != index:
            name = ("outputs", "weights", "alphas", "extras_out")[i]
            raise ValueError(f"want the cotangent of {name} f32 {shape} on {device}; got "
                             f"{value.dtype} {tuple(value.shape)} on {value.device}")
        if not value.is_contiguous():
            cotangents[i] = value.contiguous()
    want_deltas, want_rgbs, want_background, want_extras = wanted
    _require_card(device)
    grad_densities = torch.empty_like(densities)
    grad_deltas = torch.empty_like(deltas) if want_deltas else None
    grad_rgbs = torch.empty_like(rgbs) if want_rgbs else None
    grad_extras = None
    if extras is not None and cotangents[3] is None:
        # Extras without a cotangent move nothing (the train step's points):
        # the kernel does not read them, and their gradient is zero.
        grad_extras = torch.zeros_like(extras) if want_extras else None
        extras, c = None, 0
    elif want_extras and extras is not None:
        grad_extras = torch.empty_like(extras)
    grad_background = ticket = partials = None
    if want_background:
        # Written by the kernel's last block: nothing is zeroed on the card.
        grad_background = torch.empty_like(background) if n else torch.zeros_like(background)
        ticket, partials = _background_scratch(device, -(-n // RAYS_PER_BLOCK))
    if n == 0:
        return grad_densities, grad_deltas, grad_rgbs, grad_background, grad_extras
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_backward(
            densities.data_ptr(), deltas.data_ptr(), rgbs.data_ptr(), background.data_ptr(),
            mask.data_ptr(), _ptr(extras), *map(_ptr, cotangents), n, k, c,
            per_sample, grad_densities.data_ptr(), _ptr(grad_deltas),
            _ptr(grad_rgbs), _ptr(grad_extras), _ptr(partials), _ptr(ticket), _ptr(grad_background),
            build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_backward")
    backward_counter.launches += 1
    return grad_densities, grad_deltas, grad_rgbs, grad_background, grad_extras


class RenderComposite(torch.autograd.Function):
    """Forward and backward kernels as one differentiable function of
    ``(densities, deltas, rgbs, background, extras)``; three outputs
    without extras, four with.  The inputs are checked once, in the
    forward."""

    @staticmethod
    def forward(ctx, densities, deltas, rgbs, background, mask, extras):
        ctx.set_materialize_grads(False)
        *inputs, ctx.per_sample = _prepared(densities, deltas, rgbs, background, mask, extras)
        ctx.save_for_backward(*inputs)
        outs = _forward_launcher(*inputs, ctx.per_sample)
        return outs if extras is not None else outs[:3]

    @staticmethod
    def backward(ctx, grad_outputs, grad_weights, grad_alphas, grad_extras_out=None):
        need = ctx.needs_input_grad
        grads = _backward_launcher(
            *ctx.saved_tensors, ctx.per_sample, grad_outputs, grad_weights, grad_alphas, grad_extras_out,
            (need[1], need[2], need[3], need[5]),
        )
        d_densities, d_deltas, d_rgbs, d_background, d_extras = grads
        return (d_densities if need[0] else None, d_deltas, d_rgbs, d_background, None, d_extras)


# The launches behind RenderComposite (on checked inputs); a CPU test swaps
# in plain versions to hold the autograd wiring where there is no card.
_forward_launcher = _launch_forward
_backward_launcher = _launch_backward


def render_composite(
    densities: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor] = None,
) -> Outputs:
    """Scan, weights and blends of one batch of rays.

    :param densities: ``[N, K]`` non-negative densities (0 in padding slots).
    :param deltas: ``[N, 1]`` bin width of every sample of the ray, or
        ``[N, K]`` one per sample.
    :param rgbs: ``[N, K, 3]`` per-sample colours.
    :param background: ``[3]`` background colour.
    :param mask: ``[N]`` bool; a masked-out ray returns the background.
    :param extras: optional ``[N, K, C]`` values blended with a zero
        background (C <= 8 on the card): the sample points, then aux losses.
    :return: ``(outputs [N, 3], weights [N, K+1], alphas [N, 1],
        extras_out [N, C] or None)``.
    """
    if densities.device.type == "cpu":
        counter.plain_calls += 1
        return render_composite_reference(densities, deltas, rgbs, background, mask, extras)
    outs = RenderComposite.apply(densities, deltas, rgbs, background, mask, extras)
    return outs if extras is not None else (*outs, None)
