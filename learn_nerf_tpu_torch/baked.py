"""Baked inference for Instant-NGP fields, port of ``learn_nerf_tpu.baked``.

Once training ends, the spatial half of the NGP model (hash encoding and
density MLP, up to the ``density_dim`` features whose channel 0 is the log
density) is a fixed function of position.  :func:`bake_instant_ngp` sweeps
it once over the ``r^3`` vertices of a lattice over the bbox and stores the
features in one table; :class:`BakedInstantNGP` then evaluates the field
with one trilinear lookup in that table (``kernels/baked.baked_lookup``:
the CUDA kernel on the card) followed by the source model's unchanged
colour MLP.  At a lattice vertex the baked field equals the live one up to
the table's storage rounding (bf16: round to nearest even).

The table is **logical**: ``[r^3, pack * F]``, rows x-major (``x + r*(y +
r*z)``).  A row holds ``pack`` (1, 2, 4 or 8) corners: segment ``s`` holds
the vertex shifted by the low bits of ``s`` (z = bit 0, y = bit 1, x = bit
2), +1 and clamped at ``r - 1``, so a lookup reads ``8 / pack`` rows at
``pack`` times the memory and gives the same bits for every pack.  The JAX
package's 128-lane segmented layout (``physical_rows_per_row``,
``to_physical``, ``_segments_from_physical``) is a TPU tiling and is not
carried over; :func:`baked_from_flax` converts its tables.
"""

import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .kernels.baked import PACKS, baked_lookup
from .models.base import FieldModel
from .models.instant_ngp import InstantNGPModel, flax_dense
from .ops.encoding import sinusoidal_features

Tensor = torch.Tensor

# Lattice vertices the bake sweeps at once, in whole z-planes.
SWEEP_POINTS = 1 << 21
GRID_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BakedInstantNGP(FieldModel):
    """A dense-grid spatial field and the source NGP model's colour head.

    ``grid`` is a buffer, not a parameter: the baked field does not train.
    ``color_layers`` and ``rgb`` are the source model's layers of those
    names (flax's ``Dense_{density_layers+1..}``), run in ``compute_dtype``
    as the source model ran them.
    """

    def __init__(
        self,
        grid: Tensor,
        resolution: int,
        bbox_min: Tuple[float, float, float],
        bbox_max: Tuple[float, float, float],
        d_freqs: int = 4,
        hidden_dim: int = 64,
        density_dim: int = 16,
        color_layers: int = 2,
        pack: int = 1,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if pack not in PACKS:
            raise ValueError(f"pack must be 1, 2, 4, or 8 (got {pack})")
        if tuple(grid.shape) != (resolution**3, pack * density_dim):
            raise ValueError(
                f"want grid [{resolution}^3, {pack * density_dim}]; got {tuple(grid.shape)}"
            )
        self.resolution = resolution
        self.bbox_min = tuple(float(v) for v in bbox_min)
        self.bbox_max = tuple(float(v) for v in bbox_max)
        self.d_freqs = d_freqs
        self.density_dim = density_dim
        self.pack = pack
        self.compute_dtype = compute_dtype
        self.register_buffer("grid", grid)
        color_in = 6 * d_freqs + density_dim
        self.color_layers = nn.ModuleList(
            nn.Linear(color_in if i == 0 else hidden_dim, hidden_dim) for i in range(color_layers)
        )
        self.rgb = nn.Linear(hidden_dim if color_layers else color_in, 3)

    def features(self, x: Tensor) -> Tensor:
        """The baked spatial features ``[..., density_dim]`` (f32)."""
        lead = x.shape[:-1]
        out = baked_lookup(self.grid, x.reshape(-1, 3), self.resolution, self.pack,
                           self.bbox_min, self.bbox_max)
        return out.reshape(*lead, self.density_dim)

    def forward(self, x: Tensor, d: Tensor):  # -> FieldOutput
        f = self.features(x)
        density = torch.exp(f[..., 0:1])
        d_emb = sinusoidal_features(d.float(), self.d_freqs)
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        h = torch.cat([d_emb, f], dim=-1).to(dtype)
        for layer in self.color_layers:
            h = torch.relu(flax_dense(layer, h, self.compute_dtype))
        color = torch.tanh(flax_dense(self.rgb, h, self.compute_dtype).float())
        return density, color, {}


def _shifted_copy(dst: Tensor, src: Tensor, dy: int, dx: int) -> None:
    """``dst[:, y, x] = src[:, min(y + dy, r - 1), min(x + dx, r - 1)]`` for
    ``[nz, r, r, F]`` views, in at most four slice copies."""
    r = src.shape[1]

    def spans(d):  # (target, source) slices of a clamped +d shift
        return [(slice(0, r - d), slice(d, r))] + ([(slice(r - 1, r), slice(r - 1, r))] if d else [])

    for ty, sy in spans(dy):
        for tx, sx in spans(dx):
            dst[:, ty, tx] = src[:, sy, sx]


def write_planes(out: Tensor, planes: Tensor, z0: int, pack: int) -> None:
    """Write every row segment that the z-planes ``z0 .. z0 + nz - 1`` feed.

    :param out: the ``[r^3, pack * F]`` table being filled.
    :param planes: ``[nz, r, r, F]`` features of those planes, ``[z, y, x]``.

    Segment ``s`` of row ``(z, y, x)`` is vertex ``(min(z + dz, r-1),
    min(y + dy, r-1), min(x + dx, r-1))`` with ``dz, dy, dx`` bits 0, 1, 2
    of ``s``: plane ``z`` fills the rows of plane ``z - dz``, and the last
    plane also its own rows.
    """
    nz, r = planes.shape[0], planes.shape[1]
    rows = out.view(r, r, r, pack, -1)
    for s in range(pack):
        dz, dy, dx = s & 1, (s >> 1) & 1, (s >> 2) & 1
        first = dz if z0 == 0 else 0  # plane 0 feeds no row through a z shift
        if first < nz:
            _shifted_copy(rows[z0 + first - dz : z0 + nz - dz, :, :, s], planes[first:], dy, dx)
        if dz and z0 + nz == r:
            _shifted_copy(rows[r - 1 :, :, :, s], planes[nz - 1 :], dy, dx)


def pack_baked_grid(grid: Tensor, resolution: int, pack: int) -> Tensor:
    """The ``[r^3, pack * F]`` table from the pack-1 table ``grid [r^3, F]``
    (written into one new tensor: no shifted copy of the table exists)."""
    if pack not in PACKS:
        raise ValueError(f"pack must be 1, 2, 4, or 8 (got {pack})")
    r, features = resolution, grid.shape[-1]
    out = torch.empty((r**3, pack * features), dtype=grid.dtype, device=grid.device)
    write_planes(out, grid.view(r, r, r, features), 0, pack)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_bakeable(model: FieldModel) -> None:
    """Raise unless ``model`` is the plain Instant-NGP model (the Ref-NeRF
    hybrid's normals need the live encoding)."""
    if not isinstance(model, InstantNGPModel):
        raise ValueError(
            "--baked supports the plain Instant-NGP model only "
            f"(got {type(model).__name__})"
        )


def bake_instant_ngp(
    model: InstantNGPModel,
    resolution: int,
    dtype: torch.dtype = torch.bfloat16,
    pack: int = 1,
    verbose: bool = True,
) -> BakedInstantNGP:
    """Sweep the trained spatial stack onto a dense grid, on the model's
    device.

    Vertex ``i`` of an axis sits at ``bbox_min + i / (r - 1) * (bbox_max -
    bbox_min)`` (the lookup's indexing).  The sweep runs the model with
    ``spatial_only=True`` over chunks of whole z-planes and writes each
    chunk's row segments into the preallocated table: peak memory is the
    table plus one chunk.  f32 features are stored in ``dtype`` rounded to
    nearest even.

    :param model: the trained plain ``InstantNGPModel``.
    :param dtype: ``torch.bfloat16`` or ``torch.float32``.
    :param pack: corners a row (1, 2, 4 or 8): ``pack`` x the memory for
        ``8 / pack`` row reads a sample, the same output bits.
    """
    check_bakeable(model)
    if pack not in PACKS:
        raise ValueError(f"pack must be 1, 2, 4, or 8 (got {pack})")
    r = int(resolution)
    if r < 2:
        raise ValueError(f"bake resolution must be at least 2 (got {r})")
    encoding = model.encoding
    features = model.density_out.out_features
    device = model.density_out.weight.device
    bbox_min = torch.tensor(encoding.bbox_min, dtype=torch.float32, device=device)
    bbox_max = torch.tensor(encoding.bbox_max, dtype=torch.float32, device=device)
    grid = torch.empty((r**3, pack * features), dtype=dtype, device=device)
    planes = max(1, min(r, SWEEP_POINTS // (r * r)))

    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        plane_ids = torch.arange(r * r, device=device)
        cx, cy = plane_ids % r, plane_ids // r
        for z0 in range(0, r, planes):
            nz = min(planes, r - z0)
            cz = torch.arange(z0, z0 + nz, device=device).repeat_interleave(r * r)
            coords = torch.stack([cx.repeat(nz), cy.repeat(nz), cz], dim=-1).float()
            pts = bbox_min + coords / (r - 1) * (bbox_max - bbox_min)
            feats = model(pts, torch.zeros_like(pts), spatial_only=True).to(dtype)
            write_planes(grid, feats.view(nz, r, r, features), z0, pack)
    _sync(device)
    seconds = time.perf_counter() - t0

    baked = baked_like(model, grid, r, pack).to(device)
    with torch.no_grad():
        for src, dst in zip([*model.color_layers, model.rgb], [*baked.color_layers, baked.rgb]):
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
    baked.eval()
    if verbose:
        gb = grid.numel() * grid.element_size() / 1e9
        dtype_name = str(dtype).replace("torch.", "")
        print(
            f"baked {r}^3 x {features} spatial grid ({gb:.2f} GB {dtype_name}, pack {pack}, "
            f"{pack * features}-wide rows) in {seconds:.1f} s on {device}",
            flush=True,
        )
    return baked


def baked_from_flax(
    tree: Dict[str, np.ndarray], resolution: int, pack: int, density_dim: int
) -> Dict[str, Tensor]:
    """The JAX package's baked params -> :class:`BakedInstantNGP`'s state
    dict (NumPy only).

    The JAX grid is ``[ceil(r^3 / S), pack * S * F]`` with ``S = 128 // F``
    when F divides 128, else 1 (``physical_rows_per_row``): physical row
    ``n``, segment ``c``, sub-row ``j`` holds segment ``c`` of logical row
    ``n S + j``.  A bf16 grid comes as its uint16 bits.  ``Dense_i``
    becomes ``color_layers.i`` and, last, ``rgb``.
    """
    r, f = resolution, density_dim
    s = 128 // f if f <= 128 and 128 % f == 0 else 1
    raw = np.asarray(tree["grid"])
    n = raw.shape[0]
    if raw.shape != (-(-(r**3) // s), pack * s * f):
        raise ValueError(f"JAX grid {raw.shape} is not r={r}, pack={pack}, F={f}")
    rows = raw.reshape(n, pack, s, f).transpose(0, 2, 1, 3).reshape(n * s, pack * f)[: r**3]
    rows = np.array(rows)  # a writable copy in row order
    if rows.dtype == np.uint16:
        grid = torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
    else:
        grid = torch.from_numpy(rows.astype(np.float32))
    state = {"grid": grid}
    dense = sum(1 for name in tree if name.startswith("Dense_"))
    names = [f"color_layers.{i}" for i in range(dense - 1)] + ["rgb"]
    for i, name in enumerate(names):
        layer = tree[f"Dense_{i}"]
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["kernel"], dtype=np.float32).T))
        state[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], dtype=np.float32))
    return state


def baked_state_arrays(baked: BakedInstantNGP) -> Dict[str, np.ndarray]:
    """The state dict as NumPy arrays, a bf16 grid as its uint16 bits
    (``np.savez`` has no bfloat16)."""
    arrays = {}
    for name, value in baked.state_dict().items():
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            arrays[name] = value.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[name] = value.numpy()
    return arrays


def baked_state_from_arrays(arrays, grid_dtype: torch.dtype) -> Dict[str, Tensor]:
    """Inverse of :func:`baked_state_arrays`."""
    state = {}
    for name in arrays:
        value = np.asarray(arrays[name])
        if name == "grid" and grid_dtype == torch.bfloat16:
            state[name] = torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
        else:
            state[name] = torch.from_numpy(np.array(value))
    return state


def baked_like(model: InstantNGPModel, grid: Tensor, resolution: int, pack: int) -> BakedInstantNGP:
    """A baked model of ``model``'s shapes and bbox around ``grid`` (its
    colour head still to be copied or loaded)."""
    encoding = model.encoding
    return BakedInstantNGP(
        grid,
        resolution=resolution,
        bbox_min=encoding.bbox_min,
        bbox_max=encoding.bbox_max,
        d_freqs=model.d_freqs,
        hidden_dim=model.rgb.in_features,
        density_dim=model.density_out.out_features,
        color_layers=len(model.color_layers),
        pack=pack,
        compute_dtype=model.compute_dtype,
    )
