"""Checkpoints: the pickle contract shared with ``learn_nerf_tpu``, the
bridge between flax parameter trees and torch state dicts, and the port's
full train state.

The pickle holds a plain dict ``{"coarse": tree, "fine": tree,
"background": [3]}`` of NumPy arrays, where each tree is flax's
``{"Dense_i": {"kernel": [in, out], "bias": [out]}}``, plus, for an
Instant-NGP model, ``{"HashGridEncoding_0": {"table_i": [rows, F]}}``;
occupancy runs add ``occupancy_densities`` (flat ``[r^3]``),
``occupancy_resolution`` and, from the train loop, ``occupancy_host_step``.  A checkpoint written by either package loads in
the other: the model trees convert by kind (:func:`model_params_from_flax`
/ :func:`model_params_to_flax`) and every other key passes through
unchanged.  NGP trees saved by the reference implementation
(``MultiresHashTableEncoding_i/HashTableEncoding_j/table``) are renamed on
load, as ``learn_nerf_tpu.checkpoint.load_params_pickle`` does.

The full train state (:func:`save_train_state`) is the port's own format:
an atomic ``torch.save`` of plain tensors, dicts and numbers (it loads with
``torch.load(..., weights_only=True)``): the models' state dicts and the
background, ``optimizer.state_dict()`` (Adam's moments and step), the
optimizer's and the train state's step counters, the EMA average, and for
the occupancy loop its grid, host step and auto budget.  The JAX package
writes a flax msgpack there; neither package reads the other's full state,
and handing the port a msgpack refuses.  The params pickle stays the format
both read.
"""

import os
import pickle
import zipfile
from typing import Any, Callable, Dict, List

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
    ckpt: Dict[str, Any], input_layers: int = 5, mid_layers: int = 4, density_layers: int = 1
) -> Dict[str, Any]:
    """Inverse of :func:`checkpoint_from_flax`; other values become NumPy.
    Takes any model's ``flax_layout()`` (an NGP state names its own layers,
    so ``density_layers`` is not needed here)."""
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


def _atomic_write(path: str, write: Callable[[Any], None]) -> None:
    """``write(file)`` into ``path + ".tmp"``, fsync, rename over ``path``,
    fsync the directory: a crash leaves the old file or the new one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def save_params_pickle(path: str, params: Dict[str, Any]) -> None:
    """Write a pickle-contract dict atomically (tmp + fsync + rename)."""
    _atomic_write(path, lambda f: pickle.dump(params, f))


FULL_STATE_FORMAT = "learn_nerf_tpu_torch full train state"
FULL_STATE_VERSION = 1


def _on_cpu(tree: Any) -> Any:
    """``tree`` with every tensor detached, copied to the CPU."""
    if isinstance(tree, Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    return tree


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """Write a loop's full train state (atomic ``torch.save``, tensors on
    the CPU), tagged with the format and version."""
    state = dict(_on_cpu(state), format=FULL_STATE_FORMAT, version=FULL_STATE_VERSION)
    _atomic_write(path, lambda f: torch.save(state, f))


def _read_train_state(path: str) -> Dict[str, Any]:
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a full train state of learn_nerf_tpu_torch (a torch.save archive); "
            "learn_nerf_tpu writes its full state as a flax msgpack, which the port does not read. "
            "Resume from the params pickle (--save_path), which both packages read"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FULL_STATE_FORMAT:
        raise ValueError(f"{path} is not a full train state of learn_nerf_tpu_torch")
    if state["version"] != FULL_STATE_VERSION:
        raise ValueError(f"{path}: full-state version {state['version']}, this package reads {FULL_STATE_VERSION}")
    return state


def _reconcile_ema(raw: Dict[str, Any], ema_enabled: bool) -> Dict[str, Any]:
    """Match the state's ``ema`` to the loading loop's EMA setting (port of
    ``learn_nerf_tpu.checkpoint._reconcile_ema``), four cases:

    * no average saved, EMA off: nothing;
    * no average saved (the key absent, or None: saved EMA-off), EMA on:
      seed the average from a copy of the saved ``params``;
    * an average saved, EMA off: drop it (the raw parameters continue, and
      a stale average must not reach ``eval_params``).
    * an average saved, EMA on: keep it.
    """
    if not ema_enabled:
        raw["ema"] = None
    elif raw.get("ema") is None:
        raw["ema"] = _clone(raw["params"])
    return raw


def _clone(tree: Any) -> Any:
    if isinstance(tree, Tensor):
        return tree.clone()
    return {k: _clone(v) for k, v in tree.items()}


def load_train_state(path: str, loop: str, ema_enabled: bool) -> Dict[str, Any]:
    """Read a full train state written by :func:`save_train_state` for a
    loop of kind ``loop`` (``"hierarchy"`` or ``"occupancy"``), its ``ema``
    reconciled with ``ema_enabled`` (:func:`_reconcile_ema`)."""
    state = _read_train_state(path)
    if state["loop"] != loop:
        raise ValueError(f"{path} holds the {state['loop']} loop's state, not the {loop} loop's")
    return _reconcile_ema(state, ema_enabled)


def peek_train_state_step(path: str) -> int:
    """The train state's step counter of a full-state checkpoint, with no
    loop built (the cosine-schedule CLI reads it before it knows how many
    steps remain), as ``learn_nerf_tpu.checkpoint.peek_train_state_step``
    reads ``state.step``."""
    return int(_read_train_state(path)["step"])


def train_state_from_flax(
    params: Dict[str, Any], opt_state: Any = None, density_layers: int = 1
) -> Dict[str, Any]:
    """The JAX occupancy loop's train state as the port's, for tests that
    start both loops from one state.

    :param params: the JAX loop's ``state.params`` (``fine`` tree and
        ``background``) as NumPy arrays.
    :param opt_state: optionally optax's Adam state for those params: any
        object or mapping with ``mu``, ``nu`` (trees shaped like ``params``)
        and ``count`` (``optax.ScaleByAdamState``).
    :return: ``dict(fine=<state dict>, background=tensor)``, plus, with an
        ``opt_state``, ``exp_avg`` and ``exp_avg_sq`` (the same layout, for
        ``torch.optim.Adam``'s per-parameter state) and ``step`` (an int).
    """
    def convert(tree):
        return dict(
            fine=model_params_from_flax(tree["fine"], density_layers=density_layers),
            background=torch.from_numpy(np.array(tree["background"], dtype=np.float32)),
        )

    out = convert(params)
    if opt_state is not None:
        field = (lambda k: opt_state[k]) if isinstance(opt_state, dict) else (
            lambda k: getattr(opt_state, k))
        out.update(
            exp_avg=convert(field("mu")), exp_avg_sq=convert(field("nu")),
            step=int(np.asarray(field("count"))),
        )
    return out
