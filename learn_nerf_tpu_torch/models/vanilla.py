"""Vanilla NeRF MLP (Mildenhall et al. 2020), port of
``learn_nerf_tpu.models.vanilla``.

5 input layers, a skip concat of the positional embedding, 4 mid layers
(ReLU between but not after), a softplus density head, and a 128-wide color
branch conditioned on the direction embedding with a tanh output.

``compute_dtype="float32"`` runs ``nn.Linear`` layers in f32.
``compute_dtype="bfloat16"`` has two routes (:meth:`NeRFModel.set_bf16_route`):

* ``"fused"`` (the default, for serving): the whole forward through the
  fused MLP (:mod:`..kernels.fused_mlp`), the CUDA kernel for CUDA tensors
  and its plain version for CPU tensors.  Its rounding points are the
  Pallas kernel's (bf16 product operands, f32 sums and biases).  It works
  on detached packed weights, so it has no backward: with grad enabled and
  parameters that require grad it raises.
* ``"flax"`` (what the train loops select):
  autograd through plain ``torch`` products, rounded where flax's bf16
  ``Dense`` rounds: operands, biases and layer outputs in bf16, the
  encodings computed in f32, the density and rgb heads cast to f32 before
  softplus and tanh.  The JAX package trains this model through flax, not
  through Pallas.

Parameters stay f32 either way.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_mlp import PackedMLP, fused_mlp, pack_vanilla_params
from ..ops.encoding import sinusoidal_features
from .base import FieldModel, FieldOutput, flax_dense

Tensor = torch.Tensor

COMPUTE_DTYPES = ("float32", "bfloat16")
BF16_ROUTES = ("fused", "flax")


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
        self.bf16_route = "fused"
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

    def set_bf16_route(self, route: str) -> "NeRFModel":
        """Pick the bf16 forward: ``"fused"`` (serving) or ``"flax"``
        (training; see the module doc).  No effect in f32."""
        if route not in BF16_ROUTES:
            raise ValueError(f"bf16_route must be one of {BF16_ROUTES}, got {route!r}")
        self.bf16_route = route
        return self

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
        if self.compute_dtype == "bfloat16" and self.bf16_route == "fused":
            if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
                raise RuntimeError(
                    "the fused bf16 route works on detached packed weights and has no backward; "
                    "train through set_bf16_route('flax') (the train loops select it), or run "
                    "under torch.no_grad()"
                )
            density, rgb = fused_mlp(self.packed(), x, d)
            return density, rgb, {}
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

        def dense(layer: nn.Linear, z: Tensor) -> Tensor:
            return flax_dense(layer, z, self.compute_dtype)

        x_emb = sinusoidal_features(x, self.x_freqs).to(dtype)
        d_emb = sinusoidal_features(d, self.d_freqs).to(dtype)
        z = x_emb
        for layer in self.input_layers:
            z = torch.relu(dense(layer, z))
        z = dense(self.skip, torch.cat([z, x_emb], dim=-1))
        for layer in self.mid_layers:
            z = dense(layer, torch.relu(z))
        density = F.softplus(dense(self.density, z).float())
        z = torch.relu(dense(self.color, torch.cat([z, d_emb], dim=-1)))
        rgb = torch.tanh(dense(self.rgb, z).float())
        return density, rgb, {}
