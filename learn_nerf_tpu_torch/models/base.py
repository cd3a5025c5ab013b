"""Model base class (port of ``learn_nerf_tpu.models.base``)."""

from typing import Dict, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
FieldOutput = Tuple[Tensor, Tensor, Dict[str, Tensor]]


def flax_dense(layer: nn.Linear, x: Tensor, compute_dtype: str) -> Tensor:
    """``layer(x)`` as flax's ``Dense(dtype=compute_dtype)`` computes it: in
    bf16, bf16 operands, the product rounded to bf16, then a bf16 bias add."""
    if compute_dtype == "bfloat16":
        bf16 = torch.bfloat16
        return torch.matmul(x.to(bf16), layer.weight.to(bf16).t()) + layer.bias.to(bf16)
    return layer(x)


class FieldModel(nn.Module):
    """A neural field.

    ``forward(x [..., 3], d [..., 3]) -> (density [..., 1], rgb [..., 3],
    aux)`` over any number of leading dims: density non-negative, rgb in
    ``[-1, 1]``, aux a dict of ``[...]`` per-point auxiliary losses.
    """

    def forward(self, x: Tensor, d: Tensor) -> FieldOutput:
        raise NotImplementedError


def reset_parameters_like_flax(model: nn.Module) -> None:
    """Initialize every ``nn.Linear`` as flax's ``Dense`` does: a
    lecun-normal kernel (a normal of variance ``1 / fan_in`` truncated at two
    standard deviations) and a zero bias.  Draws from torch's global
    generator."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            # The truncation shrinks the variance; flax divides it out.
            std = (1.0 / module.in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(module.weight, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
