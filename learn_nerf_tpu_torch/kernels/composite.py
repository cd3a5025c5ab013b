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

:func:`render_composite_pooled` computes the same in the pool layout of the
pooled passes (``learn_nerf_tpu/occ_render.py:613-654``: the segmented
exclusive scan, the weights and the ``segment_sum`` blends): ray r's
samples are the pool rows ``starts[r] .. starts[r+1] - 1`` (at most K <= 64,
in t order), the rest of the pool is its unused tail.  Its kernels
(``composite_pooled_forward_kernel``, ``composite_pooled_backward_kernel``)
give a warp a ray, or one warp a group of consecutive short rays whose rows
fit in 32 lanes, with segmented scans (no weights out; the backward writes
the pool's gradients and zeros on the tail itself); the group's size
follows the pool's rows a ray (:func:`pooled_rays_per_warp`).

:func:`render_composite` and :func:`render_composite_pooled` run the plain
version for CPU tensors (the ops of :mod:`..ops.volume` under plain
autograd) and the kernels for CUDA tensors, with no fallback between the
two.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.volume import composite, composite_alpha, termination_weights
from . import build

Tensor = torch.Tensor
Outputs = Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]

# Forward launches and plain calls; the backward kernel's launches; the
# same two for the pool layout.
counter = build.LaunchCounter()
backward_counter = build.LaunchCounter()
pooled_counter = build.LaunchCounter()
pooled_backward_counter = build.LaunchCounter()

# Rays per block (csrc kCompositeWarps: one warp per ray, and the warps of
# a pool-layout block), and the extras' widest row (kCompositeMaxExtras).
# Any number of samples per ray; at most MAX_POOLED_SAMPLES in the pool
# layout.
RAYS_PER_BLOCK = 8
MAX_EXTRAS = 8
MAX_POOLED_SAMPLES = 64
# The pool layout's kernels give one warp a group of R consecutive rays
# whose rows fit in a chunk of 32, and every other ray a warp of its own;
# R is one of POOLED_RAYS_PER_WARP: the most whose pool rows (rows / n a
# ray) fit in POOLED_ROWS_PER_WARP (R = 1: a warp a ray throughout).
POOLED_RAYS_PER_WARP = (1, 2, 4, 8, 16, 32)
POOLED_ROWS_PER_WARP = 24


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


def _checked(tensors, shapes, dtypes, names, device):
    """``tensors`` made contiguous (a view that is not is copied), after a
    check of each one's type, shape and device (all on ``device``)."""
    index = device.index if device.type == "cuda" else -1
    out = list(tensors)
    for i, (value, shape, dtype) in enumerate(zip(tensors, shapes, dtypes)):
        if value.dtype != dtype or value.shape != shape or value.get_device() != index:
            raise ValueError(
                f"want {names[i]} {dtype} {shape} on {device}; got {value.dtype} "
                f"{tuple(value.shape)} on {value.device}"
            )
        if not value.is_contiguous():
            out[i] = value.contiguous()
    return out


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
    tensors = _checked(tensors, shapes, _DTYPES, _NAMES, densities.device)
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


def _checked_cotangents(cotangents, shapes, names, device):
    """:func:`_checked` for the f32 cotangents that are not ``None``."""
    present = [i for i, value in enumerate(cotangents) if value is not None]
    checked = _checked([cotangents[i] for i in present], [shapes[i] for i in present],
                       [torch.float32] * len(present), [f"the cotangent of {names[i]}" for i in present], device)
    out = list(cotangents)
    for i, value in zip(present, checked):
        out[i] = value
    return out


def _launch_backward(densities, deltas, rgbs, background, mask, extras, per_sample, grad_outputs,
                     grad_weights, grad_alphas, grad_extras_out, wanted):
    """The backward launch on inputs that :func:`_prepared` passed; checks
    the cotangents."""
    n, k = densities.shape
    c = 0 if extras is None else extras.shape[-1]
    device = densities.device
    cotangents = _checked_cotangents([grad_outputs, grad_weights, grad_alphas, grad_extras_out],
                                     ((n, 3), (n, k + 1), (n, 1), (n, c)),
                                     ("outputs", "weights", "alphas", "extras_out"), device)
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


# -- the pool layout -------------------------------------------------------

PooledOutputs = Tuple[Tensor, Tensor, Optional[Tensor]]


def render_composite_pooled_reference(
    densities: Tensor,
    starts: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor],
    samples: int,
) -> PooledOutputs:
    """Plain PyTorch version, differentiable by autograd: the pool gathered
    back to ``[N, samples]`` slots and :func:`render_composite_reference`'s
    per-ray scan (never a global cumsum minus each ray's base, whose f32
    difference of tile-sized sums loses the trailing rays' transmittance)."""
    n, rows = starts.shape[0] - 1, densities.shape[0]
    slot = torch.arange(samples, device=densities.device)
    first = starts[:-1].to(torch.int64)[:, None]
    valid = slot[None, :] < (starts[1:].to(torch.int64)[:, None] - first)
    index = torch.clamp(first + slot[None, :], max=max(rows - 1, 0))

    def back(values: Tensor) -> Tensor:
        if rows == 0:
            return values.new_zeros((n, samples, *values.shape[1:]))
        gathered = values[index]
        keep = valid.reshape(n, samples, *([1] * (values.dim() - 1)))
        return torch.where(keep, gathered, 0.0)

    outputs, _, alphas, blended = render_composite_reference(
        back(densities), deltas, back(rgbs), background, mask, None if extras is None else back(extras))
    return outputs, alphas, blended


def _prepared_pooled(densities, starts, deltas, rgbs, background, mask, extras, samples):
    """The pool-layout inputs as the kernels take them (contiguous), after
    one check of type, shape and device."""
    if densities.dim() != 1 or starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError(f"want densities [B] and starts [N + 1]; got {tuple(densities.shape)} and "
                         f"{tuple(starts.shape)}")
    if not 1 <= samples <= MAX_POOLED_SAMPLES:
        raise ValueError(f"the pooled composite kernels take 1 to {MAX_POOLED_SAMPLES} samples a ray; "
                         f"got {samples}")
    rows, n = densities.shape[0], starts.shape[0] - 1
    tensors = [densities, starts, deltas, rgbs, background, mask]
    shapes = [(rows,), (n + 1,), (n, 1), (rows, 3), (3,), (n,)]
    dtypes = [torch.float32, torch.int32, torch.float32, torch.float32, torch.float32, torch.bool]
    names = ["densities", "starts", "deltas", "rgbs", "background", "mask"]
    c = 0
    if extras is not None:
        c = extras.shape[-1]
        if not 1 <= c <= MAX_EXTRAS:
            raise ValueError(f"the composite kernels blend 1 to {MAX_EXTRAS} extras; got {tuple(extras.shape)}")
        tensors.append(extras)
        shapes.append((rows, c))
        dtypes.append(torch.float32)
        names.append("extras")
    if rows * max(c, 3) >= 2**31 or n * max(c, 3) >= 2**31:
        raise ValueError(f"a pool of {rows} rows over {n} rays exceeds the kernels' 32-bit counts")
    tensors = _checked(tensors, shapes, dtypes, names, densities.device)
    if extras is None:
        tensors.append(None)
    return tensors


def pooled_rays_per_warp(n: int, rows: int) -> int:
    """The rays a warp of the pool-layout kernels takes for ``n`` rays over
    a pool of ``rows`` rows: the most of :data:`POOLED_RAYS_PER_WARP` whose
    rows fit in :data:`POOLED_ROWS_PER_WARP`."""
    rays = POOLED_RAYS_PER_WARP[0]
    for r in POOLED_RAYS_PER_WARP[1:]:
        if r * rows <= POOLED_ROWS_PER_WARP * n:
            rays = r
    return rays


def pooled_blocks(n: int) -> int:
    """Blocks of a pool-layout launch (csrc ``pooled_blocks``): a warp a
    ray, RAYS_PER_BLOCK warps a block, whatever the groups."""
    return -(-n // RAYS_PER_BLOCK)


def _rays_per_warp(n: int, rows: int) -> int:
    rays = pooled_rays_per_warp(n, rows)
    if rays not in POOLED_RAYS_PER_WARP:
        raise ValueError(f"the pooled composite kernels take {POOLED_RAYS_PER_WARP} rays a warp; got {rays}")
    return rays


def _launch_pooled_forward(densities, starts, deltas, rgbs, background, mask, extras, samples) -> PooledOutputs:
    """The pool layout's forward launch on inputs that
    :func:`_prepared_pooled` passed."""
    rows, n = densities.shape[0], starts.shape[0] - 1
    c = 0 if extras is None else extras.shape[-1]
    device = densities.device
    rays_per_warp = _rays_per_warp(n, rows)
    _require_card(device)
    outputs = torch.empty((n, 3), dtype=torch.float32, device=device)
    alphas = torch.empty((n, 1), dtype=torch.float32, device=device)
    blended = None if extras is None else torch.empty((n, c), dtype=torch.float32, device=device)
    if n == 0:
        return outputs, alphas, blended
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_pooled_forward(
            densities.data_ptr(), starts.data_ptr(), deltas.data_ptr(), rgbs.data_ptr(),
            background.data_ptr(), mask.data_ptr(), _ptr(extras), n, samples, c, rows, rays_per_warp,
            outputs.data_ptr(), alphas.data_ptr(), _ptr(blended), build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_pooled_forward")
    pooled_counter.launches += 1
    return outputs, alphas, blended


def _launch_pooled_backward(densities, starts, deltas, rgbs, background, mask, extras, samples, grad_outputs,
                            grad_alphas, grad_extras_out, wanted):
    """The pool layout's backward launch on inputs that
    :func:`_prepared_pooled` passed; checks the cotangents.  ``wanted``
    says which of the gradients of ``(rgbs, background, extras)`` to write
    (the densities' always is).

    :return: gradients of ``(densities, rgbs, background, extras)`` in pool
        order with zeros on the pool's tail, ``None`` where not wanted.
    """
    rows, n = densities.shape[0], starts.shape[0] - 1
    c = 0 if extras is None else extras.shape[-1]
    device = densities.device
    cotangents = _checked_cotangents([grad_outputs, grad_alphas, grad_extras_out], ((n, 3), (n, 1), (n, c)),
                                     ("outputs", "alphas", "extras_out"), device)
    want_rgbs, want_background, want_extras = wanted
    rays_per_warp = _rays_per_warp(n, rows)
    _require_card(device)
    if n == 0:  # no ray: the whole pool is tail
        return (torch.zeros_like(densities), torch.zeros_like(rgbs) if want_rgbs else None,
                torch.zeros_like(background) if want_background else None,
                torch.zeros_like(extras) if want_extras and extras is not None else None)
    grad_densities = torch.empty_like(densities)
    grad_rgbs = torch.empty_like(rgbs) if want_rgbs else None
    grad_extras = None
    if extras is not None and cotangents[2] is None:
        # Extras without a cotangent move nothing (the step's points).
        grad_extras = torch.zeros_like(extras) if want_extras else None
        extras, c = None, 0
    elif want_extras and extras is not None:
        grad_extras = torch.empty_like(extras)
    grad_background = ticket = partials = None
    if want_background:
        grad_background = torch.empty_like(background)
        ticket, partials = _background_scratch(device, pooled_blocks(n))
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_composite_pooled_backward(
            densities.data_ptr(), starts.data_ptr(), deltas.data_ptr(), rgbs.data_ptr(),
            background.data_ptr(), mask.data_ptr(), _ptr(extras), *map(_ptr, cotangents), n, samples, c,
            rows, rays_per_warp, grad_densities.data_ptr(), _ptr(grad_rgbs), _ptr(grad_extras), _ptr(partials), _ptr(ticket),
            _ptr(grad_background), build.current_stream(device),
        )
    build.check_launch(lib, err, "composite_pooled_backward")
    pooled_backward_counter.launches += 1
    return grad_densities, grad_rgbs, grad_background, grad_extras


def composite_pooled_forward_cuda(densities, starts, deltas, rgbs, background, mask, extras, samples) -> PooledOutputs:
    """Launch the pool layout's forward kernel on the current stream."""
    return _launch_pooled_forward(*_prepared_pooled(densities, starts, deltas, rgbs, background, mask, extras,
                                                    samples), samples)


def composite_pooled_backward_cuda(densities, starts, deltas, rgbs, background, mask, extras, samples,
                                   grad_outputs, grad_alphas, grad_extras_out=None,
                                   wanted: Sequence[bool] = (True, True, True)):
    """Launch the pool layout's backward kernel on the current stream; a
    ``None`` cotangent is zero.  Returns the gradients of ``(densities,
    rgbs, background, extras)``."""
    inputs = _prepared_pooled(densities, starts, deltas, rgbs, background, mask, extras, samples)
    return _launch_pooled_backward(*inputs, samples, grad_outputs, grad_alphas, grad_extras_out, wanted)


class RenderCompositePooled(torch.autograd.Function):
    """The pool layout's kernels as one differentiable function of
    ``(densities, rgbs, background, extras)``; two outputs without extras,
    three with.  The bin widths take no gradient (they come from the rays):
    widths that require one are refused."""

    @staticmethod
    def forward(ctx, densities, starts, deltas, rgbs, background, mask, extras, samples):
        if ctx.needs_input_grad[2]:
            raise ValueError("the pooled composite kernels give the bin widths no gradient")
        ctx.set_materialize_grads(False)
        inputs = _prepared_pooled(densities, starts, deltas, rgbs, background, mask, extras, samples)
        ctx.samples = samples
        ctx.save_for_backward(*inputs)
        outs = _pooled_forward_launcher(*inputs, samples)
        return outs if extras is not None else outs[:2]

    @staticmethod
    def backward(ctx, grad_outputs, grad_alphas, grad_extras_out=None):
        need = ctx.needs_input_grad
        d_densities, d_rgbs, d_background, d_extras = _pooled_backward_launcher(
            *ctx.saved_tensors, ctx.samples, grad_outputs, grad_alphas, grad_extras_out,
            (need[3], need[4], need[6]),
        )
        return (d_densities if need[0] else None, None, None, d_rgbs, d_background, None, d_extras, None)


# The launches behind RenderCompositePooled; a CPU test swaps in plain
# versions to hold its autograd wiring.
_pooled_forward_launcher = _launch_pooled_forward
_pooled_backward_launcher = _launch_pooled_backward


def render_composite_pooled(
    densities: Tensor,
    starts: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    extras: Optional[Tensor],
    samples: int,
) -> PooledOutputs:
    """Scan, weights and blends of one pool of samples.

    :param densities: ``[B]`` non-negative densities in pool order.
    :param starts: ``[N + 1]`` int32: ray r owns pool rows ``starts[r] ..
        starts[r+1] - 1`` (t order); rows from ``starts[N]`` on are unused.
    :param deltas: ``[N, 1]`` bin width of every sample of the ray.
    :param rgbs: ``[B, 3]`` per-sample colours.
    :param background: ``[3]`` background colour.
    :param mask: ``[N]`` bool; a masked-out ray returns the background,
        alpha 0 and zero extras.
    :param extras: optional ``[B, C]`` values blended with a zero
        background (C <= 8 on the card): the sample points, then aux losses.
    :param samples: K, the most samples a ray owns (<= 64 on the card).
    :return: ``(outputs [N, 3], alphas [N, 1], extras_out [N, C] or None)``.
    """
    if densities.device.type == "cpu":
        pooled_counter.plain_calls += 1
        return render_composite_pooled_reference(densities, starts, deltas, rgbs, background, mask, extras,
                                                 samples)
    outs = RenderCompositePooled.apply(densities, starts, deltas, rgbs, background, mask, extras, samples)
    return outs if extras is not None else (*outs, None)
