"""Scene metadata: the dataset's ``metadata.json`` (``min``/``max`` bbox),
as ``learn_nerf_tpu.data.dataset.ModelMetadata`` reads it."""

import json
from dataclasses import dataclass
from typing import Tuple

Vec3 = Tuple[float, float, float]


@dataclass
class ModelMetadata:
    bbox_min: Vec3
    bbox_max: Vec3

    @classmethod
    def from_json(cls, path: str) -> "ModelMetadata":
        with open(path, "rb") as f:
            metadata = json.load(f)
        return cls(bbox_min=tuple(metadata["min"]), bbox_max=tuple(metadata["max"]))
