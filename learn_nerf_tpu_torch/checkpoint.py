"""Checkpoints: the pickle contract shared with ``learn_nerf_tpu``, and the
bridge between flax parameter trees and torch state dicts.

The pickle holds a plain dict ``{"coarse": tree, "fine": tree,
"background": [3]}`` of NumPy arrays, where each tree is flax's
``{"Dense_i": {"kernel": [in, out], "bias": [out]}}``; occupancy runs add
``occupancy_densities`` (flat ``[r^3]``) and ``occupancy_resolution``.
A checkpoint written by either package loads in the other: the model trees
convert through :func:`params_from_flax` / :func:`params_to_flax` and every
other key passes through unchanged.
"""

import os
import pickle
from typing import Any, Dict, List

import numpy as np
import torch

Tensor = torch.Tensor

MODEL_KEYS = ("coarse", "fine")


def dense_names(input_layers: int = 5, mid_layers: int = 4) -> List[str]:
    """Torch submodule name of each flax ``Dense_i``, in order (the layout of
    :class:`~.models.vanilla.NeRFModel`)."""
    return (
        [f"input_layers.{i}" for i in range(input_layers)]
        + ["skip"]
        + [f"mid_layers.{i}" for i in range(mid_layers - 1)]
        + ["density", "color", "rgb"]
    )


def params_from_flax(
    tree: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Tensor]:
    """Flax ``Dense_i`` tree -> ``NeRFModel`` state dict (f32 tensors).
    Flax's ``kernel`` is ``[in, out]``; torch's ``weight`` is ``[out, in]``."""
    names = dense_names(input_layers, mid_layers)
    if len(tree) != len(names):
        raise ValueError(
            f"tree has {len(tree)} Dense layers; {input_layers} input + "
            f"{mid_layers} mid layers need {len(names)}"
        )
    state = {}
    for i, name in enumerate(names):
        layer = tree[f"Dense_{i}"]
        kernel = np.asarray(layer["kernel"], dtype=np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        state[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], dtype=np.float32))
    return state


def params_to_flax(
    state: Dict[str, Tensor], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: NumPy ``Dense_i`` tree."""
    tree = {}
    for i, name in enumerate(dense_names(input_layers, mid_layers)):
        weight = state[f"{name}.weight"].detach().cpu().numpy()
        tree[f"Dense_{i}"] = dict(
            kernel=np.ascontiguousarray(weight.T),
            bias=state[f"{name}.bias"].detach().cpu().numpy().copy(),
        )
    return tree


def checkpoint_from_flax(
    params: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Pickle-contract dict -> the same dict with state dicts for
    ``coarse``/``fine``; ``background`` and the occupancy keys pass through."""
    return {
        k: params_from_flax(v, input_layers, mid_layers) if k in MODEL_KEYS else v
        for k, v in params.items()
    }


def checkpoint_to_flax(
    ckpt: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Inverse of :func:`checkpoint_from_flax`; other values become NumPy."""
    out = {}
    for k, v in ckpt.items():
        if k in MODEL_KEYS:
            out[k] = params_to_flax(v, input_layers, mid_layers)
        elif isinstance(v, Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out


class _NoJaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"this checkpoint stores {module}.{name} objects and needs jax "
                "to load; re-save it with NumPy arrays (learn_nerf_tpu's "
                "save_params_pickle does)"
            )
        return super().find_class(module, name)


def load_params_pickle(path: str) -> Dict[str, Any]:
    """Load a pickle-contract checkpoint (NumPy trees, as saved)."""
    with open(path, "rb") as f:
        return _NoJaxUnpickler(f).load()


def save_params_pickle(path: str, params: Dict[str, Any]) -> None:
    """Write a pickle-contract dict atomically (tmp + fsync + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(params, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
