"""Host-side data layer (NumPy): cameras and scene metadata."""

from .camera import CameraView
from .dataset import ModelMetadata

__all__ = ["CameraView", "ModelMetadata"]
