"""Host-side data layer (NumPy): cameras, scene metadata, the dataset
reader, the two-stage ray shuffle and the host-to-device prefetch."""

from .camera import CameraView
from .dataset import ModelMetadata, NeRFDataset, load_dataset

__all__ = ["CameraView", "ModelMetadata", "NeRFDataset", "load_dataset"]
