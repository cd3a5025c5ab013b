"""Dataset loading: scene metadata and PNG+JSON views, as
``learn_nerf_tpu.data.dataset`` reads them (this package's own copy: NumPy
and PIL only).

A dataset directory holds ``metadata.json`` (the ``min``/``max`` bbox) and,
per view, ``NAME.png`` beside ``NAME.json`` (the camera).  Images are
alpha-premultiplied on load and colours map to ``[-1, 1]`` as
``v / 127.5 - 1``.
"""

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from .camera import CameraView

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


@dataclass
class NeRFView(CameraView):
    def image(self) -> np.ndarray:
        """The view's image as ``[H, W, 3]`` uint8 RGB."""
        raise NotImplementedError

    def rays(self) -> np.ndarray:
        """All rays with target colours, packed ``[N, 3, 3]``: rows are
        (origin, direction, colour), colours in ``[-1, 1]``."""
        img = self.image()
        bare = self.bare_rays(img.shape[1], img.shape[0])
        colors = img.reshape(-1, 3).astype(np.float32) / 127.5 - 1.0
        return np.concatenate([bare, colors[:, None]], axis=1).astype(np.float32)


@dataclass
class FileNeRFView(NeRFView):
    image_path: str

    def image(self) -> np.ndarray:
        from PIL import Image

        rgba = np.asarray(Image.open(self.image_path).convert("RGBA"))
        # Premultiply alpha so transparent borders don't leak colours.
        rgb = rgba[:, :, :3].astype(np.float32) * (rgba[:, :, 3:].astype(np.float32) / 255.0)
        return np.round(rgb).astype(np.uint8)


@dataclass
class NeRFDataset:
    metadata: ModelMetadata
    views: List[NeRFView]

    def iterate_batches(
        self,
        dir_path: str,
        seed: int,
        batch_size: int,
        repeat: bool = True,
        num_shards: int = 32,
    ) -> Iterator[np.ndarray]:
        """Shuffled ``[N, 3, 3]`` ray batches (see
        :class:`~.shuffle.ShuffledDataset`; ``dir_path`` holds its cache)."""
        from .shuffle import ShuffledDataset

        with ShuffledDataset(dir_path, self, seed, num_shards=num_shards) as sd:
            yield from sd.iterate_batches(batch_size, repeat=repeat)


def load_dataset(directory: str) -> NeRFDataset:
    """Load a dataset directory of per-frame PNG+JSON plus metadata.json."""
    dataset = NeRFDataset(
        metadata=ModelMetadata.from_json(os.path.join(directory, "metadata.json")), views=[]
    )
    skipped = []
    for name in sorted(os.listdir(directory)):
        if name.startswith(".") or not name.endswith(".png"):
            continue
        img_path = os.path.join(directory, name)
        json_path = img_path[: -len(".png")] + ".json"
        if not os.path.exists(json_path):
            if name.endswith("_depth.png"):
                continue  # distillation depth companions have no camera
            # An extra camera-less png is skipped loudly; only a directory
            # with no usable view at all is an error.
            skipped.append(name)
            continue
        dataset.views.append(FileNeRFView.from_json(json_path, image_path=img_path))
    if skipped:
        shown = ", ".join(skipped[:5]) + ("..." if len(skipped) > 5 else "")
        if not dataset.views:
            raise FileNotFoundError(
                f"no usable views in {directory}: every png lacks its "
                f"camera json ({shown}); rename depth companions "
                f"*_depth.png or add the jsons"
            )
        print(
            f"warning: skipping {len(skipped)} camera-less png(s) in {directory}: {shown}",
            flush=True,
        )
    return dataset
