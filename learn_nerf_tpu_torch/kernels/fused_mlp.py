"""Fused vanilla-NeRF MLP forward: the CUDA kernel and its plain version.

Port of ``tools/pallas_recipe/fused_mlp.py`` (``fused_nerf_forward``,
``pack_vanilla_params``, ``sincos_projection``): sinusoidal encodings, the
input layers, the skip layer and mid layers, a softplus density head, and
the color branch with a tanh rgb head, in one kernel per 64-point tile
(``csrc/fused_nerf.cu``, ``fused_mlp_kernel``).  Inference only.

Numerics: every product takes bf16 operands and sums in f32; biases are f32;
the encodings are f32.  :func:`fused_mlp_reference` rounds at exactly those
points with f32 products, so on the CPU it computes what the kernel
computes up to the order of the f32 sums.  (The Pallas kernel forms the
cosines as ``sin(a + pi/2)``; both versions here take ``cos(a)``, as
``ops.encoding.sinusoidal_features`` does.)

:func:`fused_mlp` runs the plain version for CPU tensors and the kernel for
CUDA tensors, with no fallback between the two.
"""

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.encoding import sinusoidal_features
from . import build

Tensor = torch.Tensor

counter = build.LaunchCounter()

# Limits of the kernel's shared-memory tiles (csrc/nerf_mlp.cuh).
MAX_HIDDEN = 256
MAX_COLOR = 128
MAX_X_FEATURES = 64
MAX_D_FEATURES = 32


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


@dataclass(frozen=True)
class PackedMLP:
    """Kernel operands for one vanilla NeRF MLP.

    ``weights`` holds every product's matrix, row-major ``[K, N]`` bf16
    with K and N zero-padded to multiples of 16, back to back in the order
    of :meth:`matrix_shapes`; ``biases`` holds the f32 biases, each padded
    to its layer's N, in the order of :meth:`bias_sizes`.  The concat
    layers are split as in ``pack_vanilla_params``: ``[z, e] @ W == z @ W_z
    + e @ W_e``.  Zero padding leaves every result unchanged.
    """

    weights: Tensor
    biases: Tensor
    input_layers: int
    mid_layers: int
    hidden: int  # padded to 16
    color: int  # padded to 16
    x_freqs: int
    d_freqs: int

    @property
    def x_features(self) -> int:
        return _pad16(6 * self.x_freqs)

    @property
    def d_features(self) -> int:
        return _pad16(6 * self.d_freqs)

    def matrix_shapes(self) -> List[Tuple[int, int]]:
        h, c, xe, de = self.hidden, self.color, self.x_features, self.d_features
        shapes = [(xe, h)] + [(h, h)] * (self.input_layers - 1)
        shapes += [(h, h), (xe, h)]  # skip: z part, x_emb part
        shapes += [(h, h)] * (self.mid_layers - 1)
        shapes += [(h, 16), (h, c), (de, c), (c, 16)]  # density, color z/d, rgb
        return shapes

    def bias_sizes(self) -> List[int]:
        h = self.hidden
        return [h] * (self.input_layers + self.mid_layers) + [16, self.color, 16]

    def matrices(self) -> Iterator[Tensor]:
        offset = 0
        for k, n in self.matrix_shapes():
            yield self.weights[offset : offset + k * n].view(k, n)
            offset += k * n

    def bias_vectors(self) -> Iterator[Tensor]:
        offset = 0
        for n in self.bias_sizes():
            yield self.biases[offset : offset + n]
            offset += n


def pack_vanilla_params(
    dense: Sequence[Tuple[Tensor, Tensor]],
    input_layers: int = 5,
    mid_layers: int = 4,
    x_freqs: int = 10,
    d_freqs: int = 4,
) -> PackedMLP:
    """Pack a vanilla MLP's Dense layers into kernel operands.

    :param dense: ``(weight [out, in], bias [out])`` per layer, in flax's
        ``Dense_i`` order (``models.vanilla.NeRFModel.dense_layers``).
    """
    x_dim, d_dim = 6 * x_freqs, 6 * d_freqs
    density_i = input_layers + mid_layers
    h = _pad16(dense[0][0].shape[0])
    c = _pad16(dense[density_i + 1][0].shape[0])
    xe, de = _pad16(x_dim), _pad16(d_dim)
    device = dense[0][0].device

    def kernel(i):  # flax layout [in, out]
        return dense[i][0].detach().t()

    def mat(w, k, n):
        out = torch.zeros((k, n), dtype=torch.float32, device=device)
        out[: w.shape[0], : w.shape[1]] = w
        return out

    def vec(i, n):
        out = torch.zeros((n,), dtype=torch.float32, device=device)
        out[: dense[i][1].shape[0]] = dense[i][1].detach()
        return out

    mats, biases = [], []
    for i in range(input_layers):
        mats.append(mat(kernel(i), xe if i == 0 else h, h))
        biases.append(vec(i, h))
    skip = kernel(input_layers)
    mats += [mat(skip[:-x_dim], h, h), mat(skip[-x_dim:], xe, h)]
    biases.append(vec(input_layers, h))
    for i in range(input_layers + 1, density_i):
        mats.append(mat(kernel(i), h, h))
        biases.append(vec(i, h))
    mats.append(mat(kernel(density_i), h, 16))
    biases.append(vec(density_i, 16))
    color = kernel(density_i + 1)
    mats += [mat(color[:-d_dim], h, c), mat(color[-d_dim:], de, c)]
    biases.append(vec(density_i + 1, c))
    mats.append(mat(kernel(density_i + 2), c, 16))
    biases.append(vec(density_i + 2, 16))
    return PackedMLP(
        weights=torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16),
        biases=torch.cat(biases),
        input_layers=input_layers,
        mid_layers=mid_layers,
        hidden=h,
        color=c,
        x_freqs=x_freqs,
        d_freqs=d_freqs,
    )


def _padded_features(coords: Tensor, freqs: int, width: int) -> Tensor:
    feats = sinusoidal_features(coords, freqs)
    return F.pad(feats, (0, width - feats.shape[-1]))


def fused_mlp_reference(packed: PackedMLP, x: Tensor, d: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel.

    :param x: ``[M, 3]`` f32 points.
    :param d: ``[M, 3]`` f32 directions.
    :return: ``[M, 4]`` f32: density, rgb.
    """
    mats = packed.matrices()
    biases = packed.bias_vectors()

    def mm(a, w):  # bf16 operands, f32 products and sums
        return a.to(torch.bfloat16).float() @ w.float()

    x_emb = _padded_features(x, packed.x_freqs, packed.x_features)
    d_emb = _padded_features(d, packed.d_freqs, packed.d_features)
    z = x_emb
    for _ in range(packed.input_layers):
        z = torch.relu(mm(z, next(mats)) + next(biases))
    w_z, w_e = next(mats), next(mats)
    z = mm(z, w_z) + next(biases) + mm(x_emb, w_e)
    for _ in range(packed.mid_layers - 1):
        z = mm(torch.relu(z), next(mats)) + next(biases)
    density = F.softplus(mm(z, next(mats)) + next(biases))[:, :1]
    w_cz, w_cd = next(mats), next(mats)
    c = torch.relu(mm(z, w_cz) + next(biases) + mm(d_emb, w_cd))
    rgb = torch.tanh(mm(c, next(mats)) + next(biases))[:, :3]
    return torch.cat([density, rgb], dim=-1)


def check_kernel_operands(packed: PackedMLP, *tensors: Tensor) -> None:
    """Raise unless the kernel takes these operands: f32 contiguous CUDA
    tensors on the packed weights' device, and widths within its tiles."""
    device = packed.weights.device
    if device.type != "cuda":
        raise ValueError(f"packed weights are on {device}, not on a CUDA device")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"operand on {t.device}, packed weights on {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"operand must be contiguous float32, got {t.dtype}")
    if packed.weights.dtype != torch.bfloat16 or packed.biases.dtype != torch.float32:
        raise ValueError("packed weights must be bfloat16 and biases float32")
    if packed.weights.data_ptr() % 256:
        raise ValueError("packed weights must start 256-byte aligned")
    if not (
        packed.hidden <= MAX_HIDDEN
        and packed.color <= MAX_COLOR
        and packed.x_features <= MAX_X_FEATURES
        and packed.d_features <= MAX_D_FEATURES
        and packed.input_layers >= 1
        and packed.mid_layers >= 1
    ):
        raise ValueError(
            f"the kernel takes hidden <= {MAX_HIDDEN}, color <= {MAX_COLOR}, "
            f"6 * x_freqs <= {MAX_X_FEATURES}, 6 * d_freqs <= {MAX_D_FEATURES} "
            f"and at least one input and one mid layer; got {packed}"
        )
    build.require_hopper(device)


def dims_args(packed: PackedMLP) -> Tuple[int, ...]:
    """The layer-shape arguments every entry point of the library takes."""
    return (
        packed.input_layers,
        packed.mid_layers,
        packed.hidden,
        packed.color,
        packed.x_freqs,
        packed.d_freqs,
    )


def fused_mlp_cuda(packed: PackedMLP, x: Tensor, d: Tensor) -> Tensor:
    """Launch the kernel on the current stream: ``[M, 3]`` x2 -> ``[M, 4]``."""
    check_kernel_operands(packed, x, d)
    if x.shape != d.shape or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x and d must both be [M, 3], got {x.shape}, {d.shape}")
    out = torch.empty((x.shape[0], 4), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.nerf_fused_mlp(
            x.data_ptr(), d.data_ptr(), packed.weights.data_ptr(),
            packed.biases.data_ptr(), out.data_ptr(), x.shape[0],
            *dims_args(packed), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, err, "fused_mlp")
    counter.launches += 1
    return out


def fused_mlp(packed: PackedMLP, x: Tensor, d: Tensor) -> Tuple[Tensor, Tensor]:
    """Run the fused MLP on ``[..., 3]`` points and directions.

    :return: ``(density [..., 1], rgb [..., 3])`` in f32.
    """
    lead = x.shape[:-1]
    xf = x.reshape(-1, 3).float().contiguous()
    df = d.reshape(-1, 3).float().contiguous()
    if xf.device.type == "cpu":
        counter.plain_calls += 1
        out = fused_mlp_reference(packed, xf, df)
    else:
        out = fused_mlp_cuda(packed, xf, df)
    out = out.reshape(*lead, 4)
    return out[..., 0:1], out[..., 1:4]
