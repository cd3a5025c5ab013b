"""Fused vanilla-NeRF render chain: the CUDA kernel and its plain version.

Port of ``tools/pallas_recipe/fused_render.py`` (``fused_render_tiles``):
for whole rays of K samples, points -> sinusoidal encoding -> the MLP ->
density/rgb heads -> the termination-weight scan over K -> composite, in
one kernel (``csrc/fused_nerf.cu``, ``fused_render_kernel``), writing only
``[N, 4]`` (foreground rgb, background weight).  Inference only.

The MLP rounds as :mod:`.fused_mlp`; the scan is f32 throughout:
``sig_dt = density * delta``, ``acc = cumsum(sig_dt)``,
``w = exp(-(acc - sig_dt)) * (1 - exp(-sig_dt))``, ``bg = exp(-acc_K)``.

:func:`fused_render` runs the plain version for CPU tensors and the kernel
for CUDA tensors, with no fallback between the two.
"""

import torch

from . import build
from .fused_mlp import PackedMLP, check_kernel_operands, dims_args, fused_mlp_reference

Tensor = torch.Tensor

counter = build.LaunchCounter()

# Whole rays share a 64-row tile (csrc/nerf_mlp.cuh kRows).
MAX_SAMPLES = 64


def fused_render_reference(
    packed: PackedMLP, points: Tensor, dirs: Tensor, deltas: Tensor
) -> Tensor:
    """Plain PyTorch version of the kernel.

    :param points: ``[N, K, 3]`` sample positions (ray-major).
    :param dirs: ``[N, 3]`` ray directions.
    :param deltas: ``[N, K]`` bin widths, 0 in padding slots.
    :return: ``[N, 4]``: composited foreground rgb, background weight.
    """
    n, k, _ = points.shape
    flat_dirs = dirs[:, None, :].expand(n, k, 3).reshape(-1, 3)
    out = fused_mlp_reference(packed, points.reshape(-1, 3), flat_dirs).reshape(n, k, 4)
    sig_dt = out[..., 0] * deltas
    acc = torch.cumsum(sig_dt, dim=1)
    weights = torch.exp(-(acc - sig_dt)) * (1.0 - torch.exp(-sig_dt))
    fg = torch.einsum("nk,nkc->nc", weights, out[..., 1:])
    return torch.cat([fg, torch.exp(-acc[:, -1:])], dim=-1)


def fused_render_cuda(
    packed: PackedMLP, points: Tensor, dirs: Tensor, deltas: Tensor
) -> Tensor:
    """Launch the kernel on the current stream (shapes as the reference)."""
    check_kernel_operands(packed, points, dirs, deltas)
    n, k, _ = points.shape
    if points.shape != (n, k, 3) or dirs.shape != (n, 3) or deltas.shape != (n, k):
        raise ValueError(
            f"want points [N, K, 3], dirs [N, 3], deltas [N, K]; got "
            f"{tuple(points.shape)}, {tuple(dirs.shape)}, {tuple(deltas.shape)}"
        )
    if not 1 <= k <= MAX_SAMPLES:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_SAMPLES} samples per ray, got {k}")
    out = torch.empty((n, 4), dtype=torch.float32, device=points.device)
    lib = build.library()
    with torch.cuda.device(points.device):
        err = lib.nerf_fused_render(
            points.data_ptr(), dirs.data_ptr(), deltas.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), out.data_ptr(),
            n, k, *dims_args(packed), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "fused_render")
    counter.launches += 1
    return out


def fused_render(packed: PackedMLP, points: Tensor, dirs: Tensor, deltas: Tensor) -> Tensor:
    """Fused render of per-ray sample batches: ``[N, K, 3]`` points,
    ``[N, 3]`` dirs and ``[N, K]`` deltas (0 in padding slots) ->
    ``[N, 4]`` foreground rgb and background weight."""
    points = points.float().contiguous()
    dirs = dirs.float().contiguous()
    deltas = deltas.float().contiguous()
    if points.device.type == "cpu":
        counter.plain_calls += 1
        return fused_render_reference(packed, points, dirs, deltas)
    return fused_render_cuda(packed, points, dirs, deltas)
