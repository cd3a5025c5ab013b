"""Neural field models (``nn.Module``), port of ``learn_nerf_tpu.models``.

``model(x [..., 3], d [..., 3])`` returns ``(density [..., 1], rgb [..., 3],
aux)`` over any number of leading dims.
"""

from .base import FieldModel
from .instant_ngp import InstantNGPModel, InstantNGPRefNeRFModel
from .ref_nerf import RefNeRFModel
from .vanilla import NeRFModel

__all__ = ["FieldModel", "InstantNGPModel", "InstantNGPRefNeRFModel", "NeRFModel", "RefNeRFModel"]
