"""The Instant-NGP MLP forward after the hash-grid encode, in one launch:
the CUDA kernel and its plain version.

``models.InstantNGPModel``'s f32 forward from the encoding on: ``enc [R,
E]`` through ``Linear(E, 64)``, ReLU and ``Linear(64, 16)``; the density
``exp`` of channel 0; the colour branch over ``[sinusoidal_features(d, 4),
out]`` through ``Linear(40, 64)``, ReLU, ``Linear(64, 64)``, ReLU and
``Linear(64, 3)`` with a ``tanh`` (``csrc/ngp_mlp.cu``, ``ngp_mlp_kernel``).
It replaces no TPU kernel: the JAX package leaves the 64-wide layers to XLA.
The kernel reads the ``nn.Linear`` weights and biases as they are, so there
is no packed copy to keep up to date.  Inference only: the result carries no
graph.

Numerics: f32 products and sums, ``expf``, ``tanhf``, ``sinf`` and ``cosf``;
the kernel differs from :func:`ngp_mlp_reference` only in the order of the
f32 sums.

:func:`ngp_mlp` runs the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback between the two.  The model takes this route
only where :func:`engages` says so (``InstantNGPModel.forward``).
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import sinusoidal_features
from . import build

Tensor = torch.Tensor

counter = build.LaunchCounter()

# The widths the kernel is compiled for (csrc/ngp_mlp.cu).
HIDDEN = 64
DENSITY_DIM = 16
D_FREQS = 4
ENCODING_WIDTHS = (12, 32)  # 6 levels of F = 2 (the CLIs' coarse model), 16 levels of F = 2
ALIGNMENT = 16  # bytes: the kernel reads the encoding and copies the weights 16 bytes at a time


def layer_shapes(enc_dim: int) -> List[Tuple[int, int]]:
    """``[out, in]`` of the five layers the kernel computes, in order: the
    density hidden layer and output, the two colour hidden layers, rgb."""
    color_in = 6 * D_FREQS + DENSITY_DIM
    return [(HIDDEN, enc_dim), (DENSITY_DIM, HIDDEN), (HIDDEN, color_in), (HIDDEN, HIDDEN), (3, HIDDEN)]


def takes_widths(layers: Sequence[nn.Linear], d_freqs: int) -> bool:
    """Whether the kernel is compiled for these layers (``dense_layers()``
    order) and direction frequencies."""
    if d_freqs != D_FREQS or len(layers) != 5 or any(layer.bias is None for layer in layers):
        return False
    enc_dim = layers[0].in_features
    return enc_dim in ENCODING_WIDTHS and [tuple(layer.weight.shape) for layer in layers] == layer_shapes(enc_dim)


def on_card(x: Tensor) -> bool:
    """Whether ``x`` lies where the kernel runs: on a CUDA device."""
    return x.device.type == "cuda"


def engages(layers: Sequence[nn.Linear], d_freqs: int, compute_dtype: str, x: Tensor, spatial_only: bool) -> bool:
    """The model's route: the kernel computes a forward on a CUDA tensor, in
    f32, not ``spatial_only``, with autograd not recording (a frame under
    ``torch.inference_mode``), at the kernel's widths.  Every other call
    (training, bf16, the spatial features, the CPU, other widths) runs the
    model's own layers."""
    return (on_card(x) and not spatial_only and compute_dtype == "float32" and not torch.is_grad_enabled()
            and takes_widths(layers, d_freqs))


def ngp_mlp_reference(layers: Sequence[nn.Linear], enc: Tensor, d: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: ``InstantNGPModel.forward``'s f32
    operations after the encoding, in its order.

    :param enc: ``[R, E]`` f32 encoding.
    :param d: ``[R, 3]`` f32 directions.
    :return: ``(density [R, 1], rgb [R, 3])``.
    """
    hidden, density_out, *color, rgb = layers
    out = F.linear(torch.relu(F.linear(enc, hidden.weight, hidden.bias)), density_out.weight, density_out.bias)
    density = torch.exp(out[..., 0:1])
    out = torch.cat([sinusoidal_features(d, D_FREQS), out], dim=-1)
    for layer in color:
        out = torch.relu(F.linear(out, layer.weight, layer.bias))
    return density, torch.tanh(F.linear(out, rgb.weight, rgb.bias))


def check_operands(layers: Sequence[nn.Linear], enc: Tensor, d: Tensor) -> None:
    """Raise unless the kernel takes these operands: f32 contiguous ``enc
    [R, E]`` and ``d [R, 3]``, layers at its widths with f32 contiguous
    parameters, all on one CUDA device, the encoding and the weights 16-byte
    aligned."""
    if not takes_widths(layers, D_FREQS):
        raise ValueError(
            f"the kernel takes layers {layer_shapes(0)[1:]} after a first layer of [64, E] for E in "
            f"{ENCODING_WIDTHS}; got {[tuple(layer.weight.shape) for layer in layers]}"
        )
    enc_dim = layers[0].in_features
    if enc.dim() != 2 or enc.shape[1] != enc_dim or d.dim() != 2 or d.shape != (enc.shape[0], 3):
        raise ValueError(f"want enc [R, {enc_dim}] and d [R, 3]; got {tuple(enc.shape)}, {tuple(d.shape)}")
    params = [t for layer in layers for t in (layer.weight, layer.bias)]
    for t in (enc, d, *params):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"every operand must be contiguous float32; got {t.dtype} {tuple(t.shape)}")
    if not on_card(enc):
        raise ValueError(f"want the encoding on a CUDA device; got {enc.device}")
    for t in (d, *params):
        if t.device != enc.device:
            raise ValueError(f"operand on {t.device}, the encoding on {enc.device}")
    if any(t.data_ptr() % ALIGNMENT for t in (enc, *(layer.weight for layer in layers))):
        raise ValueError(f"the encoding and the weights must start {ALIGNMENT}-byte aligned")
    build.require_hopper(enc.device)


def launch_ngp_mlp(layers: Sequence[nn.Linear], enc: Tensor, d: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the kernel on the current stream: ``[R, E]``, ``[R, 3]`` ->
    ``(density [R, 1], rgb [R, 3])``."""
    check_operands(layers, enc, d)
    rows, device = enc.shape[0], enc.device
    density = torch.empty((rows, 1), dtype=torch.float32, device=device)
    rgb = torch.empty((rows, 3), dtype=torch.float32, device=device)
    if rows == 0:
        return density, rgb
    params = [t.data_ptr() for layer in layers for t in (layer.weight, layer.bias)]
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_ngp_mlp(
            enc.data_ptr(), d.data_ptr(), rows, enc.shape[1], *params, density.data_ptr(), rgb.data_ptr(),
            build.current_stream(device),
        )
    build.check_launch(lib, err, "ngp_mlp")
    counter.launches += 1
    return density, rgb


# The launch behind every call on the card; a CPU test swaps in a fake to
# hold the model's route where there is no card.
_cuda_launcher = launch_ngp_mlp


def ngp_mlp(layers: Sequence[nn.Linear], enc: Tensor, d: Tensor) -> Tuple[Tensor, Tensor]:
    """The MLP forward on ``enc [..., E]`` and directions ``d [..., 3]``.

    :return: ``(density [..., 1], rgb [..., 3])`` in f32.
    """
    lead = enc.shape[:-1]
    enc2 = enc.reshape(-1, enc.shape[-1]).float()
    d2 = d.reshape(-1, 3).float()
    if on_card(enc2):
        density, rgb = _cuda_launcher(layers, enc2.contiguous(), d2.contiguous())
    else:
        counter.plain_calls += 1
        density, rgb = ngp_mlp_reference(layers, enc2, d2)
    return density.reshape(*lead, 1), rgb.reshape(*lead, 3)
