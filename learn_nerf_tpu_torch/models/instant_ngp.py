"""Instant NGP models (Mueller et al., arXiv:2201.05989), port of
``learn_nerf_tpu.models.instant_ngp`` (``InstantNGPModel`` and the
Ref-NeRF hybrid ``InstantNGPRefNeRFModel``).

A multiresolution hash-grid encoding (:mod:`..ops.hashgrid`) feeds small
64-wide MLPs: ``exp`` density from output channel 0, and a color branch
over ``[d_emb, density features]`` (direction first) with a tanh output.

The encoding is always f32.  ``compute_dtype="bfloat16"`` runs the MLPs as
flax's ``Dense(dtype=bfloat16)`` does: inputs, kernel and bias cast to
bf16, the product rounded to bf16, then the bias added in bf16.  The
density ``exp`` and the color ``tanh`` run in f32.  The 64-wide layers are
plain matmuls (the JAX package leaves them to XLA too), except in an f32
forward on the card with autograd off (frames): there the layers after the
encoding run as one kernel (:mod:`..kernels.ngp_mlp`).
"""

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..kernels import ngp_mlp
from ..ops.encoding import sinusoidal_features
from ..ops.hashgrid import dense_level_rows, hash_grid_encode, hash_grid_encode_dx
from .base import FieldModel, flax_dense
from .ref_nerf import RefNeRFBase, density_row_vjp, relu_vjp

Tensor = torch.Tensor

COMPUTE_DTYPES = ("float32", "bfloat16")


class HashGridEncoding(nn.Module):
    """Owns one ``table_{i}`` parameter per level (flax's
    ``HashGridEncoding_0/table_i``), initialized uniform in +-1e-4."""

    def __init__(
        self,
        table_sizes: Sequence[int],
        grid_sizes: Sequence[int],
        bbox_min: Tuple[float, float, float],
        bbox_max: Tuple[float, float, float],
        feature_dim: int = 2,
        smooth: bool = False,
    ):
        super().__init__()
        if len(table_sizes) != len(grid_sizes):
            raise ValueError(
                f"table_sizes ({len(table_sizes)}) and grid_sizes "
                f"({len(grid_sizes)}) must list the same number of levels"
            )
        self.table_sizes = [int(t) for t in table_sizes]
        self.grid_sizes = [int(g) for g in grid_sizes]
        self.bbox_min = tuple(float(v) for v in bbox_min)
        self.bbox_max = tuple(float(v) for v in bbox_max)
        self.feature_dim = feature_dim
        self.smooth = smooth
        for i, (g, t) in enumerate(zip(self.grid_sizes, self.table_sizes)):
            rows = dense_level_rows(g, t)
            self.register_parameter(
                f"table_{i}", nn.Parameter(1e-4 * (torch.rand(rows, feature_dim) * 2.0 - 1.0))
            )

    def tables(self) -> List[Tensor]:
        return [getattr(self, f"table_{i}") for i in range(len(self.grid_sizes))]

    def forward(self, x: Tensor) -> Tensor:
        return hash_grid_encode(
            self.tables(), x.float(), self.grid_sizes, self.table_sizes,
            self.bbox_min, self.bbox_max, smooth=self.smooth,
        )

    def vjp_points(self, x: Tensor, cotangent: Tensor) -> Tensor:
        """The encoding's VJP in the points ``x [N, 3]`` for the cotangent
        ``[N, L * F]``: ``[N, 3]``, differentiable in the cotangent and the
        tables (:func:`~..ops.hashgrid.hash_grid_encode_dx`)."""
        return hash_grid_encode_dx(
            self.tables(), x.float(), cotangent, self.grid_sizes, self.table_sizes,
            self.bbox_min, self.bbox_max, smooth=self.smooth,
        )


class InstantNGPModel(FieldModel):
    """Submodules map one-to-one onto flax's names: ``encoding`` is
    ``HashGridEncoding_0``; ``density_layers``, ``density_out``,
    ``color_layers`` and ``rgb`` are ``Dense_0..Dense_{DL+CL+1}`` in order
    (see :meth:`dense_layers`)."""

    def __init__(
        self,
        table_sizes: Sequence[int],
        grid_sizes: Sequence[int],
        bbox_min: Tuple[float, float, float],
        bbox_max: Tuple[float, float, float],
        table_feature_dim: int = 2,
        table_smooth: bool = False,
        d_freqs: int = 4,
        hidden_dim: int = 64,
        density_dim: int = 16,
        density_layers: int = 1,
        color_layers: int = 2,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
        self.compute_dtype = compute_dtype
        self.d_freqs = d_freqs
        self.encoding = HashGridEncoding(
            table_sizes, grid_sizes, bbox_min, bbox_max, table_feature_dim, table_smooth
        )
        enc_dim = len(grid_sizes) * table_feature_dim
        self.density_layers = nn.ModuleList(
            nn.Linear(enc_dim if i == 0 else hidden_dim, hidden_dim) for i in range(density_layers)
        )
        self.density_out = nn.Linear(hidden_dim if density_layers else enc_dim, density_dim)
        color_in = 6 * d_freqs + density_dim
        self.color_layers = nn.ModuleList(
            nn.Linear(color_in if i == 0 else hidden_dim, hidden_dim) for i in range(color_layers)
        )
        self.rgb = nn.Linear(hidden_dim if color_layers else color_in, 3)

    def dense_layers(self) -> List[nn.Linear]:
        """The layers in flax's ``Dense_i`` order."""
        return [*self.density_layers, self.density_out, *self.color_layers, self.rgb]

    def flax_layout(self) -> Dict[str, int]:
        """Layer counts the checkpoint bridge needs for this model."""
        return dict(density_layers=len(self.density_layers))

    def _dense(self, layer: nn.Linear, x: Tensor) -> Tensor:
        return flax_dense(layer, x, self.compute_dtype)

    def forward(self, x: Tensor, d: Tensor, spatial_only: bool = False):  # -> FieldOutput
        """``(density [..., 1], rgb [..., 3], {})``; with ``spatial_only``
        the bare ``[..., density_dim]`` spatial features instead.  Where
        :func:`~..kernels.ngp_mlp.engages` (an f32 frame on the card) the
        layers after the encoding run as one ``ngp_mlp`` kernel."""
        if ngp_mlp.engages(self.dense_layers(), self.d_freqs, self.compute_dtype, x, spatial_only):
            density, color = ngp_mlp.ngp_mlp(self.dense_layers(), self.encoding(x), d)
            return density, color, {}
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        out = self.encoding(x).to(dtype)
        for layer in self.density_layers:
            out = torch.relu(self._dense(layer, out))
        out = self._dense(self.density_out, out)
        if spatial_only:
            return out
        density = torch.exp(out[..., 0:1].float())
        d_emb = sinusoidal_features(d.float(), self.d_freqs).to(dtype)
        out = torch.cat([d_emb, out], dim=-1)
        for layer in self.color_layers:
            out = torch.relu(self._dense(layer, out))
        color = torch.tanh(self._dense(self.rgb, out).float())
        return density, color, {}


class InstantNGPRefNeRFModel(RefNeRFBase):
    """The hash-grid trunk under the Ref-NeRF head.  Smooth mode is forced,
    so the density gradient is continuous.  The spatial block is the
    encoding, ``density_layers`` of ``hidden_dim`` and ``density_out`` (its
    ``density_dim`` channels are the Ref-NeRF head's); the directional block
    ``color_layers`` of ``hidden_dim`` and ``rgb`` over the head's
    ``density_dim + sh_degree^2 + 1`` inputs.  Submodule names are
    :class:`InstantNGPModel`'s, so the flax tree is too
    (``HashGridEncoding_0/table_i``, ``Dense_0..``).  f32 only.

    The normal's VJP runs the transposed density layers and then the
    encoding's VJP in the points: on the card the ``hashgrid_dx`` kernel,
    and in training its backward kernel (:mod:`..kernels.hashgrid_dx`)."""

    def __init__(
        self,
        table_sizes: Sequence[int],
        grid_sizes: Sequence[int],
        bbox_min: Tuple[float, float, float],
        bbox_max: Tuple[float, float, float],
        sh_degree: int = 4,
        table_feature_dim: int = 2,
        hidden_dim: int = 64,
        density_dim: int = 16,
        density_layers: int = 1,
        color_layers: int = 2,
    ):
        super().__init__(sh_degree)
        self.encoding = HashGridEncoding(
            table_sizes, grid_sizes, bbox_min, bbox_max, table_feature_dim, smooth=True
        )
        enc_dim = len(grid_sizes) * table_feature_dim
        self.density_layers = nn.ModuleList(
            nn.Linear(enc_dim if i == 0 else hidden_dim, hidden_dim) for i in range(density_layers)
        )
        self.density_out = nn.Linear(hidden_dim if density_layers else enc_dim, density_dim)
        color_in = density_dim + sh_degree**2 + 1
        self.color_layers = nn.ModuleList(
            nn.Linear(color_in if i == 0 else hidden_dim, hidden_dim) for i in range(color_layers)
        )
        self.rgb = nn.Linear(hidden_dim if color_layers else color_in, 3)

    def dense_layers(self) -> List[nn.Linear]:
        """The layers in flax's ``Dense_i`` order."""
        return [*self.density_layers, self.density_out, *self.color_layers, self.rgb]

    def flax_layout(self) -> Dict[str, int]:
        """Layer counts the checkpoint bridge needs for this model."""
        return dict(density_layers=len(self.density_layers))

    def spatial_block(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        out = self.encoding(x)
        pres = []
        for layer in self.density_layers:
            pres.append(layer(out))
            out = torch.relu(pres[-1])
        out = self.density_out(out)
        # The VJP at -e0: down the density layers to the encoding, then the
        # encoding's VJP in the points.
        cot = density_row_vjp(self.density_out, x.shape[0])
        for layer, pre in zip(reversed(self.density_layers), reversed(pres)):
            cot = relu_vjp(cot, pre) @ layer.weight
        return out, self.encoding.vjp_points(x, cot.contiguous())

    def directional_block(self, x: Tensor) -> Tensor:
        for layer in self.color_layers:
            x = torch.relu(layer(x))
        return self.rgb(x)
