"""Ref-NeRF (Verbin et al., arXiv:2112.03907), port of
``learn_nerf_tpu.models.ref_nerf``.

* The spatial block's output channels split into ``density(1) |
  diffuse(3) | spectral(1) | roughness(1) | normal(3) | bottleneck``.
* The analytic normal is the normalized negative density gradient in the
  points.  The JAX package takes it with ``jax.vjp`` of the spatial block
  at the cotangent ``-e0``.  Here each model writes that VJP out as plain
  tensor ops (:meth:`RefNeRFBase.spatial_block`): the Dense/ReLU chain
  transposed, with the ReLU mask ``pre > 0`` that JAX's relu gradient uses,
  then the derivative of the input encoding in the points (the sinusoidal
  features', or the hash-grid encoding's VJP,
  :func:`~..ops.hashgrid.hash_grid_encode_dx`).  So the normal, and
  ``normal_mse``, come out under ``torch.no_grad()`` and
  ``torch.inference_mode()`` too (the grid refresh and serving), and in
  training autograd differentiates the VJP once more, as ``jax.grad``
  differentiates ``jax.vjp``.
* View directions reflect about the predicted normal and feed the
  integrated directional encoding (:mod:`..ops.sh`).
* The colour is gamma-compressed (linear -> sRGB) and mapped to ``[-1, 1]``.
* Aux losses: ``normal_mse`` (predicted against analytic normal) and
  ``neg_normal`` (normals facing away from the camera).

Ref-NeRF runs in f32 only, as in the JAX package.
"""

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import sinusoidal_features
from ..ops.sh import integrated_dir_enc
from .base import FieldModel, FieldOutput

Tensor = torch.Tensor

# Channels the physical heads read; the rest is bottleneck.
REF_NERF_OUT_DIM = 9


def safe_normalize(v: Tensor, eps: float = 1e-10) -> Tensor:
    """Normalize without NaN at the origin."""
    return v * torch.rsqrt((v * v).sum(dim=-1, keepdim=True) + eps)


def leaky_clip(x: Tensor) -> Tensor:
    """Clip to [0, 1] but keep identity gradients."""
    return x + (torch.clamp(x, 0.0, 1.0) - x).detach()


def linear_to_srgb(colors: Tensor) -> Tensor:
    """Gamma compression, NaN-safe at 0."""
    safe = torch.clamp(colors, min=1e-5)
    return torch.where(colors <= 0.0031308, 12.92 * colors, 1.055 * safe ** (1.0 / 2.4) - 0.055)


def relu_vjp(cotangent: Tensor, pre: Tensor) -> Tensor:
    """The cotangent through ``relu(pre)``: JAX's relu gradient is 1 where
    ``pre > 0`` and 0 elsewhere (0 at 0 too)."""
    return cotangent * (pre > 0).to(cotangent.dtype)


def density_row_vjp(layer: nn.Linear, rows: int) -> Tensor:
    """The cotangent of ``layer``'s input for the cotangent ``-e0`` of its
    output: ``-W[0]``, one row broadcast over ``rows``."""
    return (-layer.weight[0]).expand(rows, layer.in_features)


def sinusoidal_vjp(x_emb: Tensor, cotangent: Tensor, freqs: int) -> Tensor:
    """The VJP of :func:`~..ops.encoding.sinusoidal_features` in the
    coordinates, from its output ``x_emb [N, D * 2k]`` (sines, then
    cosines, per dim): ``sum_k 2^k (c_sin cos - c_cos sin)`` per dim."""
    n = x_emb.shape[0]
    feats = x_emb.view(n, -1, 2 * freqs)
    cot = cotangent.reshape(n, -1, 2 * freqs)
    coeffs = 2.0 ** torch.arange(freqs, dtype=x_emb.dtype, device=x_emb.device)
    sin, cos = feats[..., :freqs], feats[..., freqs:]
    return (coeffs * (cot[..., :freqs] * cos - cot[..., freqs:] * sin)).sum(dim=-1)


class RefNeRFBase(FieldModel):
    """The Ref-NeRF head over a spatial block (which returns its output and
    its VJP at ``-e0``) and a directional block."""

    def __init__(self, sh_degree: int):
        super().__init__()
        self.sh_degree = sh_degree

    def spatial_block(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """``x [N, 3]`` -> ``(spatial_out [N, C], -d spatial_out[:, 0] / dx
        [N, 3])``."""
        raise NotImplementedError

    def directional_block(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def forward(self, x: Tensor, d: Tensor) -> FieldOutput:
        lead = x.shape[:-1]
        x = x.reshape(-1, 3)
        d = d.reshape(-1, 3)
        spatial_out, real_normal = self.spatial_block(x)
        real_normal = safe_normalize(real_normal)
        if spatial_out.shape[-1] < REF_NERF_OUT_DIM:
            raise ValueError(
                f"Ref-NeRF spatial block must emit >= {REF_NERF_OUT_DIM} "
                f"channels (density, diffuse, spectral, roughness, normal); "
                f"got {spatial_out.shape[-1]} — raise the trunk's output dim"
            )
        density = torch.exp(spatial_out[..., 0:1])
        # Diffuse starts near 0.25, so the first summed colour is ~0.5.
        diffuse = torch.sigmoid(spatial_out[..., 1:4] - math.log(3))
        spectral = torch.sigmoid(spatial_out[..., 4:5])
        roughness = F.softplus(spatial_out[..., 5:6])
        normal = safe_normalize(spatial_out[..., 6:9])

        reflection = d - 2.0 * normal * (d * normal).sum(dim=-1, keepdim=True)
        reflection_enc = integrated_dir_enc(self.sh_degree, reflection, roughness)
        normal_dot = (-d * normal).sum(dim=-1, keepdim=True)
        dir_input = torch.cat([spatial_out, reflection_enc, normal_dot], dim=-1)
        spectral_color = torch.sigmoid(self.directional_block(dir_input))

        full_color = linear_to_srgb(leaky_clip(spectral_color * spectral + diffuse)) * 2.0 - 1.0
        aux = dict(
            normal_mse=((normal - real_normal) ** 2).sum(dim=-1).reshape(lead),
            neg_normal=(torch.clamp((normal * d).sum(dim=-1), min=0.0) ** 2).reshape(lead),
        )
        return density.reshape(*lead, 1), full_color.reshape(*lead, 3), aux


class RefNeRFModel(RefNeRFBase):
    """Ref-NeRF on the original NeRF MLP trunk.  Submodules map one-to-one
    onto flax's ``Dense_i`` names (see :meth:`dense_layers`):
    ``input_layers`` are Dense_0..IL-1, ``mid_layers`` Dense_IL..IL+ML-1
    (the first over the skip concat ``[z, x_emb]``), then ``color`` and
    ``rgb``, the directional block."""

    def __init__(
        self,
        sh_degree: int = 4,
        input_layers: int = 5,
        mid_layers: int = 4,
        hidden_dim: int = 256,
        color_layer_dim: int = 128,
        x_freqs: int = 10,
    ):
        super().__init__(sh_degree)
        if mid_layers < 1:
            raise ValueError("Ref-NeRF's trunk needs at least one mid layer (its output)")
        self.num_input_layers = input_layers
        self.num_mid_layers = mid_layers
        self.x_freqs = x_freqs
        x_dim = 6 * x_freqs
        self.input_layers = nn.ModuleList(
            nn.Linear(x_dim if i == 0 else hidden_dim, hidden_dim) for i in range(input_layers)
        )
        skip_in = (hidden_dim if input_layers else x_dim) + x_dim
        self.mid_layers = nn.ModuleList(
            nn.Linear(skip_in if i == 0 else hidden_dim, hidden_dim) for i in range(mid_layers)
        )
        self.color = nn.Linear(hidden_dim + sh_degree**2 + 1, color_layer_dim)
        self.rgb = nn.Linear(color_layer_dim, 3)

    def dense_layers(self) -> List[nn.Linear]:
        """The layers in flax's ``Dense_i`` order."""
        return [*self.input_layers, *self.mid_layers, self.color, self.rgb]

    def flax_layout(self) -> Dict[str, int]:
        """Layer counts the checkpoint bridge needs for this model."""
        return dict(input_layers=self.num_input_layers, mid_layers=self.num_mid_layers, ref_nerf=True)

    def spatial_block(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        x_emb = sinusoidal_features(x, self.x_freqs)
        pres = []
        z = x_emb
        for layer in self.input_layers:
            pres.append(layer(z))
            z = torch.relu(pres[-1])
        z = torch.cat([z, x_emb], dim=-1)
        mids = []
        for i, layer in enumerate(self.mid_layers):
            if i > 0:
                z = torch.relu(z)
            z = layer(z)
            mids.append(z)

        # The VJP at -e0, from the last mid layer down to the skip concat
        # [z, x_emb], then down the input layers to x_emb.
        cot = density_row_vjp(self.mid_layers[-1], x.shape[0])
        for i in range(len(self.mid_layers) - 1, 0, -1):
            cot = relu_vjp(cot, mids[i - 1]) @ self.mid_layers[i - 1].weight
        x_dim = x_emb.shape[-1]
        cot, cot_emb = cot[:, :-x_dim], cot[:, -x_dim:]
        for j in range(len(self.input_layers) - 1, -1, -1):
            cot = relu_vjp(cot, pres[j]) @ self.input_layers[j].weight
        return z, sinusoidal_vjp(x_emb, cot_emb + cot, self.x_freqs)

    def directional_block(self, x: Tensor) -> Tensor:
        return self.rgb(torch.relu(self.color(x)))
