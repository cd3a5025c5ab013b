"""Checkpoints: the pickle contract shared with ``learn_nerf_tpu``, and the
bridge between flax parameter trees and torch state dicts.

The pickle holds a plain dict ``{"coarse": tree, "fine": tree,
"background": [3]}`` of NumPy arrays, where each tree is flax's
``{"Dense_i": {"kernel": [in, out], "bias": [out]}}``, plus, for an
Instant-NGP model, ``{"HashGridEncoding_0": {"table_i": [rows, F]}}``;
occupancy runs add ``occupancy_densities`` (flat ``[r^3]``) and
``occupancy_resolution``.  A checkpoint written by either package loads in
the other: the model trees convert by kind (:func:`model_params_from_flax`
/ :func:`model_params_to_flax`) and every other key passes through
unchanged.  NGP trees saved by the reference implementation
(``MultiresHashTableEncoding_i/HashTableEncoding_j/table``) are renamed on
load, as ``learn_nerf_tpu.checkpoint.load_params_pickle`` does.
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


def _dense_to_state(layer: Dict[str, Any], name: str, state: Dict[str, Tensor]) -> None:
    kernel = np.asarray(layer["kernel"], dtype=np.float32)
    state[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
    state[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], dtype=np.float32))


def _dense_to_flax(state: Dict[str, Tensor], name: str) -> Dict[str, np.ndarray]:
    weight = state[f"{name}.weight"].detach().cpu().numpy()
    return dict(
        kernel=np.ascontiguousarray(weight.T),
        bias=state[f"{name}.bias"].detach().cpu().numpy().copy(),
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
    state: Dict[str, Tensor] = {}
    for i, name in enumerate(names):
        _dense_to_state(tree[f"Dense_{i}"], name, state)
    return state


def params_to_flax(
    state: Dict[str, Tensor], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: NumPy ``Dense_i`` tree."""
    return {
        f"Dense_{i}": _dense_to_flax(state, name)
        for i, name in enumerate(dense_names(input_layers, mid_layers))
    }


def ngp_dense_names(density_layers: int = 1, color_layers: int = 2) -> List[str]:
    """Torch submodule name of each flax ``Dense_i``, in order (the layout of
    :class:`~.models.instant_ngp.InstantNGPModel`)."""
    return (
        [f"density_layers.{i}" for i in range(density_layers)]
        + ["density_out"]
        + [f"color_layers.{i}" for i in range(color_layers)]
        + ["rgb"]
    )


def is_ngp_tree(tree: Dict[str, Any]) -> bool:
    return "HashGridEncoding_0" in tree


def ngp_params_from_flax(tree: Dict[str, Any], density_layers: int = 1) -> Dict[str, Tensor]:
    """Flax Instant-NGP tree -> ``InstantNGPModel`` state dict (f32):
    ``HashGridEncoding_0/table_i`` -> ``encoding.table_i`` and ``Dense_i``
    -> :func:`ngp_dense_names`."""
    dense = sum(1 for k in tree if k.startswith("Dense_"))
    if set(tree) - {"HashGridEncoding_0"} - {f"Dense_{i}" for i in range(dense)}:
        raise ValueError(f"not an Instant-NGP tree: {sorted(tree)}")
    state = {
        f"encoding.{name}": torch.from_numpy(np.array(table, dtype=np.float32))
        for name, table in tree["HashGridEncoding_0"].items()
    }
    for i, name in enumerate(ngp_dense_names(density_layers, dense - density_layers - 2)):
        _dense_to_state(tree[f"Dense_{i}"], name, state)
    return state


def ngp_params_to_flax(state: Dict[str, Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`ngp_params_from_flax`: NumPy tree."""
    prefix = "encoding."
    tables = {
        k[len(prefix):]: v.detach().cpu().numpy().copy() for k, v in state.items()
        if k.startswith(prefix)
    }
    count = lambda group: sum(1 for k in state if k.startswith(group) and k.endswith(".weight"))
    names = ngp_dense_names(count("density_layers."), count("color_layers."))
    tree: Dict[str, Any] = {"HashGridEncoding_0": tables}
    for i, name in enumerate(names):
        tree[f"Dense_{i}"] = _dense_to_flax(state, name)
    return tree


def model_params_from_flax(
    tree: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4, density_layers: int = 1
) -> Dict[str, Tensor]:
    """One model tree -> state dict, by the tree's kind (NGP or vanilla)."""
    if is_ngp_tree(tree):
        return ngp_params_from_flax(tree, density_layers)
    return params_from_flax(tree, input_layers, mid_layers)


def model_params_to_flax(
    state: Dict[str, Tensor], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Inverse of :func:`model_params_from_flax`, by the state's kind."""
    if "encoding.table_0" in state:
        return ngp_params_to_flax(state)
    return params_to_flax(state, input_layers, mid_layers)


def checkpoint_from_flax(
    params: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4, density_layers: int = 1
) -> Dict[str, Any]:
    """Pickle-contract dict -> the same dict with state dicts for
    ``coarse``/``fine`` (by kind; the layer counts are a model's
    ``flax_layout()``); ``background`` and the occupancy keys pass through."""
    return {
        k: model_params_from_flax(v, input_layers, mid_layers, density_layers)
        if k in MODEL_KEYS else v
        for k, v in params.items()
    }


def checkpoint_to_flax(
    ckpt: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4
) -> Dict[str, Any]:
    """Inverse of :func:`checkpoint_from_flax`; other values become NumPy."""
    out = {}
    for k, v in ckpt.items():
        if k in MODEL_KEYS:
            out[k] = model_params_to_flax(v, input_layers, mid_layers)
        elif isinstance(v, Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out


def import_reference_params(params: Any) -> Any:
    """Rename an Instant-NGP tree saved by the reference implementation:
    ``MultiresHashTableEncoding_i/HashTableEncoding_j/table`` becomes
    ``HashGridEncoding_i/table_j``; everything else is unchanged (port of
    ``learn_nerf_tpu.checkpoint.import_reference_params``)."""
    if not isinstance(params, dict):
        return params
    out = {}
    for key, value in params.items():
        if key.startswith("MultiresHashTableEncoding_"):
            idx = key.rsplit("_", 1)[1]
            out[f"HashGridEncoding_{idx}"] = {
                f"table_{k.rsplit('_', 1)[1]}": v["table"] for k, v in value.items()
            }
        else:
            out[key] = import_reference_params(value)
    return out


def _is_reference_tree(params: Any) -> bool:
    if not isinstance(params, dict):
        return False
    return any(
        k.startswith("MultiresHashTableEncoding_") or _is_reference_tree(v)
        for k, v in params.items()
    )


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
    """Load a pickle-contract checkpoint (NumPy trees, as saved);
    reference-format NGP trees are renamed on the fly."""
    with open(path, "rb") as f:
        params = _NoJaxUnpickler(f).load()
    if _is_reference_tree(params):
        params = import_reference_params(params)
    return params


def save_params_pickle(path: str, params: Dict[str, Any]) -> None:
    """Write a pickle-contract dict atomically (tmp + fsync + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(params, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
