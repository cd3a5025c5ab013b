"""Model base class (port of ``learn_nerf_tpu.models.base``)."""

from typing import Dict, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
FieldOutput = Tuple[Tensor, Tensor, Dict[str, Tensor]]


class FieldModel(nn.Module):
    """A neural field.

    ``forward(x [..., 3], d [..., 3]) -> (density [..., 1], rgb [..., 3],
    aux)`` over any number of leading dims: density non-negative, rgb in
    ``[-1, 1]``, aux a dict of ``[...]`` per-point auxiliary losses.
    """

    def forward(self, x: Tensor, d: Tensor) -> FieldOutput:
        raise NotImplementedError
