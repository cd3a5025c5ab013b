"""Vanilla NeRF MLP (Mildenhall et al. 2020), port of
``learn_nerf_tpu.models.vanilla``.

5 input layers, a skip concat of the positional embedding, 4 mid layers
(ReLU between but not after), a softplus density head, and a 128-wide color
branch conditioned on the direction embedding with a tanh output.

``compute_dtype="float32"`` runs ``nn.Linear`` layers in f32.
``compute_dtype="bfloat16"`` runs the whole forward through the fused MLP
(:mod:`..kernels.fused_mlp`): the CUDA kernel for CUDA tensors, its plain
version for CPU tensors.  Its rounding points are the Pallas kernel's
(bf16 product operands, f32 sums and biases), not flax's bf16 module's.
Parameters stay f32 either way.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_mlp import PackedMLP, fused_mlp, pack_vanilla_params
from ..ops.encoding import sinusoidal_features
from .base import FieldModel, FieldOutput

Tensor = torch.Tensor

COMPUTE_DTYPES = ("float32", "bfloat16")


class NeRFModel(FieldModel):
    """Submodules map one-to-one onto flax's ``Dense_i`` names (see
    :meth:`dense_layers`): ``input_layers`` are Dense_0..IL-1, ``skip`` is
    Dense_IL over ``[z, x_emb]``, ``mid_layers`` follow, then ``density``,
    ``color`` over ``[z, d_emb]``, and ``rgb``."""

    def __init__(
        self,
        input_layers: int = 5,
        mid_layers: int = 4,
        hidden_dim: int = 256,
        color_layer_dim: int = 128,
        x_freqs: int = 10,
        d_freqs: int = 4,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
        self.num_input_layers = input_layers
        self.num_mid_layers = mid_layers
        self.hidden_dim = hidden_dim
        self.color_layer_dim = color_layer_dim
        self.x_freqs = x_freqs
        self.d_freqs = d_freqs
        self.compute_dtype = compute_dtype
        x_dim, d_dim = 6 * x_freqs, 6 * d_freqs
        self.input_layers = nn.ModuleList(
            nn.Linear(x_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(input_layers)
        )
        self.skip = nn.Linear(hidden_dim + x_dim, hidden_dim)
        self.mid_layers = nn.ModuleList(
            nn.Linear(hidden_dim, hidden_dim) for _ in range(mid_layers - 1)
        )
        self.density = nn.Linear(hidden_dim, 1)
        self.color = nn.Linear(hidden_dim + d_dim, color_layer_dim)
        self.rgb = nn.Linear(color_layer_dim, 3)
        self._packed = None
        self._packed_key = None

    def dense_layers(self) -> List[nn.Linear]:
        """The layers in flax's ``Dense_i`` order."""
        return [
            *self.input_layers,
            self.skip,
            *self.mid_layers,
            self.density,
            self.color,
            self.rgb,
        ]

    def flax_layout(self) -> Dict[str, int]:
        """Layer counts the checkpoint bridge needs for this model."""
        return dict(input_layers=self.num_input_layers, mid_layers=self.num_mid_layers)

    def packed(self) -> PackedMLP:
        """Kernel operands for the current weights, repacked only after the
        weights change (a new storage, device or in-place update)."""
        key = tuple((p.data_ptr(), p.device, p._version) for p in self.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_vanilla_params(
                    [(l.weight, l.bias) for l in self.dense_layers()],
                    input_layers=self.num_input_layers,
                    mid_layers=self.num_mid_layers,
                    x_freqs=self.x_freqs,
                    d_freqs=self.d_freqs,
                )
            self._packed_key = key
        return self._packed

    def forward(self, x: Tensor, d: Tensor) -> FieldOutput:
        if self.compute_dtype == "bfloat16":
            density, rgb = fused_mlp(self.packed(), x, d)
            return density, rgb, {}
        x_emb = sinusoidal_features(x, self.x_freqs)
        d_emb = sinusoidal_features(d, self.d_freqs)
        z = x_emb
        for layer in self.input_layers:
            z = torch.relu(layer(z))
        z = self.skip(torch.cat([z, x_emb], dim=-1))
        for layer in self.mid_layers:
            z = layer(torch.relu(z))
        density = F.softplus(self.density(z))
        z = torch.relu(self.color(torch.cat([z, d_emb], dim=-1)))
        rgb = torch.tanh(self.rgb(z))
        return density, rgb, {}
