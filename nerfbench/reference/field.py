"""The two field models as plain PyTorch functions of a parameter dict
(``reference/fields/<field>.py`` names each for the configurations).

Names of the parameters follow the port's modules (``encoding.table_0``,
``density_layers.0.weight``, ...), so the harness hands one dict to the
program and to this reference.  Every product is a ``torch.matmul``; the
``matmul`` argument replaces it, which is how the controls compute in a
lower precision (see :mod:`.precision`).

* Instant-NGP (Mueller et al. 2022): a multiresolution hash-grid encoding
  (trilinear over the 8 corners of each level's lattice normalised to the
  bbox; dense index ``x + g (y + g z)`` where ``g^3`` rows fit the table,
  else the spatial hash ``x ^ 19349663 y ^ 83492791 z mod T`` in uint32),
  ``exp`` density from channel 0 of the density MLP, and a colour MLP over
  ``[sinusoidal(d, 4), density features]`` with a tanh output.
* NeRF (Mildenhall et al. 2020) in the port's layout: ``sinusoidal(x, 10)``
  (60 features), five 256-wide ReLU layers, a skip layer over ``[h,
  gamma(x)]``, three more 256-wide layers (ReLU before each, none after),
  a softplus density head, a 128-wide ReLU view layer over ``[h,
  sinusoidal(d, 4)]`` and a tanh colour head.
"""

from typing import Callable, Dict, Sequence

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Matmul = Callable[[Tensor, Tensor], Tensor]

HASH_PRIME_Y = 19_349_663
HASH_PRIME_Z = 83_492_791
CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def linear(params: Params, name: str, x: Tensor, matmul: Matmul) -> Tensor:
    return matmul(x, params[f"{name}.weight"].t()) + params[f"{name}.bias"]


def sinusoidal(coords: Tensor, freqs: int) -> Tensor:
    """``[..., D]`` -> ``[..., 2 D freqs]``: per input dim the sines at
    ``2^0 .. 2^(freqs-1)``, then the cosines."""
    angles = coords[..., None] * 2.0 ** torch.arange(freqs, dtype=torch.float32, device=coords.device)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(*coords.shape[:-1], -1)


def level_rows(grid_size: int, table_size: int) -> int:
    return grid_size**3 if grid_size**3 <= table_size else table_size


def corner_rows(x: Tensor, grid_size: int, table_size: int, bbox_min: Tensor, bbox_max: Tensor):
    """``(rows [N, 8] int64, weights [N, 8])`` of one level for points ``x
    [N, 3]``."""
    frac = torch.clamp((x - bbox_min) / (bbox_max - bbox_min), 0.0, 1.0)
    findex = float(grid_size - 1) * frac
    floored = torch.clamp(torch.floor(findex), max=float(grid_size - 2))
    cf = findex - floored
    offs = torch.tensor(CORNERS, dtype=torch.int64, device=x.device)
    c = floored.to(torch.int64)[:, None, :] + offs
    per_axis = torch.where(offs > 0, cf[:, None, :], 1.0 - cf[:, None, :])
    weights = per_axis[..., 0] * per_axis[..., 1] * per_axis[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    if grid_size**3 > table_size:
        rows = ((cx ^ (HASH_PRIME_Y * cy) ^ (HASH_PRIME_Z * cz)) & 0xFFFFFFFF) % table_size
    else:
        rows = cx + grid_size * (cy + grid_size * cz)
    return rows, weights


def hash_encode(params: Params, x: Tensor, grid_sizes: Sequence[int], table_sizes: Sequence[int],
                bbox_min: Tensor, bbox_max: Tensor) -> Tensor:
    """``[N, 3]`` -> ``[N, L F]``, the levels concatenated."""
    outs = []
    for level, (g, t) in enumerate(zip(grid_sizes, table_sizes)):
        rows, weights = corner_rows(x, g, t, bbox_min, bbox_max)
        table = params[f"encoding.table_{level}"]
        feats = table[rows.reshape(-1)].reshape(*rows.shape, table.shape[1])
        outs.append((weights[..., None] * feats).sum(dim=-2))
    return torch.cat(outs, dim=-1)


def ngp_field(params: Params, cfg: dict, x: Tensor, d: Tensor, matmul: Matmul = torch.matmul):
    """Instant-NGP at points ``x`` and unit directions ``d`` ``[N, 3]``:
    ``(density [N], rgb [N, 3])``."""
    bbox_min = torch.tensor(cfg["bbox_min"], dtype=torch.float32, device=x.device)
    bbox_max = torch.tensor(cfg["bbox_max"], dtype=torch.float32, device=x.device)
    h = hash_encode(params, x, cfg["grid_sizes"], cfg["table_sizes"], bbox_min, bbox_max)
    for i in range(cfg["density_hidden_layers"]):
        h = torch.relu(linear(params, f"density_layers.{i}", h, matmul))
    h = linear(params, "density_out", h, matmul)
    density = torch.exp(h[:, 0])
    h = torch.cat([sinusoidal(d, cfg["dir_frequencies"]), h], dim=-1)
    for i in range(cfg["color_hidden_layers"]):
        h = torch.relu(linear(params, f"color_layers.{i}", h, matmul))
    return density, torch.tanh(linear(params, "rgb", h, matmul))


def nerf_field(params: Params, cfg: dict, x: Tensor, d: Tensor, matmul: Matmul = torch.matmul):
    """NeRF at points ``x`` and unit directions ``d`` ``[N, 3]``:
    ``(density [N], rgb [N, 3])``."""
    x_emb = sinusoidal(x, cfg["multires"])
    h = x_emb
    for i in range(cfg["input_layers"]):
        h = torch.relu(linear(params, f"input_layers.{i}", h, matmul))
    h = linear(params, "skip", torch.cat([h, x_emb], dim=-1), matmul)
    for i in range(cfg["mid_layers"] - 1):
        h = linear(params, f"mid_layers.{i}", torch.relu(h), matmul)
    density = torch.nn.functional.softplus(linear(params, "density", h, matmul))[:, 0]
    h = torch.relu(linear(params, "color", torch.cat([h, sinusoidal(d, cfg["multires_views"])], dim=-1), matmul))
    return density, torch.tanh(linear(params, "rgb", h, matmul))

