"""Iso-surface extraction and mesh writers (the port's own copy of
``learn_nerf_tpu.mesh``, NumPy only).

Extraction is vectorized marching *tetrahedra*: each grid cell splits into
6 tetrahedra and each tetrahedron contributes 0-2 triangles with vertices
linearly interpolated onto the iso-surface.  Table-free (16 cases by
construction), vectorized over all cells in NumPy, and the meshes are
watertight.

Writers: OBJ and a binary STL.
"""

import struct
from typing import Tuple

import numpy as np

# Decomposition of a unit cube into 6 tetrahedra sharing the main diagonal
# (0,0,0)-(1,1,1).  Corner ids: bit 0 -> x, bit 1 -> y, bit 2 -> z.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)

_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int64
)


def marching_tetrahedra(
    volume: np.ndarray, level: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``volume == level`` iso-surface.

    :param volume: ``[X, Y, Z]`` scalar field.
    :param level: iso value.
    :return: ``(verts [V, 3] float32 in index coordinates, faces [F, 3]
             int64)``.  Faces are oriented with outward normals pointing
             toward decreasing field values.
    """
    nx, ny, nz = volume.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1

    verts_list = []
    faces_list = []
    n_verts = 0

    # Z-slab chunking + crossing-cell pre-filter: materializing [C, 8, 3]
    # corner tensors for ALL cells at once costs ~3.3 GB host RAM at
    # resolution 256 (17M cells), while only the tiny fraction of cells
    # the surface crosses contributes triangles.
    slab = max(1, (2**22) // max(cy * cz, 1))
    for x0 in range(0, cx, slab):
        x1 = min(cx, x0 + slab)
        base = np.stack(
            np.meshgrid(
                np.arange(x0, x1, dtype=np.int32),
                np.arange(cy, dtype=np.int32),
                np.arange(cz, dtype=np.int32),
                indexing="ij",
            ),
            axis=-1,
        ).reshape(-1, 3)

        # Field values at the 8 corners of every slab cell: [C, 8].
        # int32 coords: the [C, 8, 3] index tensor is the slab loop's
        # peak allocation (~400 MB at the 2^22 slab), and grid axes are
        # nowhere near 2^31.
        corner_coords = base[:, None, :] + _CORNERS[None, :, :].astype(np.int32)
        vals = volume[
            corner_coords[..., 0], corner_coords[..., 1], corner_coords[..., 2]
        ]
        inside_all = vals > level  # [C, 8]
        crossing = inside_all.any(axis=1) & ~inside_all.all(axis=1)
        if not crossing.any():
            continue
        base = base[crossing]
        vals = vals[crossing]
        inside_all = inside_all[crossing]
        # Global corner ids [S, 8]: canonicalize shared-edge interpolation
        # order below, so adjacent tetrahedra produce BIT-IDENTICAL
        # vertices on a shared edge and the dedupe rounding always merges
        # them (opposite-endpoint-order interpolation differs by ~1e-6,
        # which cracked the shell whenever it straddled a rounding
        # boundary — measured ~4% open edges on a smooth sphere).
        corner_keys = (
            (corner_coords[crossing, :, 0] * ny + corner_coords[crossing, :, 1])
            * nz
            + corner_coords[crossing, :, 2]
        )

        n_verts = _march_cells(
            base, vals, inside_all, corner_keys, level,
            verts_list, faces_list, n_verts,
        )

    if not verts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    verts = np.concatenate(verts_list, axis=0)
    faces = np.concatenate(faces_list, axis=0)
    return _dedupe_vertices(verts, faces)


def _march_cells(
    base, vals, inside_all, corner_keys, level, verts_list, faces_list, n_verts
):
    """Triangulate one batch of crossing cells (see marching_tetrahedra)."""
    for tet in _TETS:
        tv = vals[:, tet]  # [C, 4]
        inside = inside_all[:, tet]  # [C, 4] bool
        count = inside.sum(axis=1)
        tkeys = corner_keys[:, tet]  # [C, 4]

        tet_pos = (base[:, None, :] + _CORNERS[tet][None, :, :]).astype(
            np.float32
        )  # [C, 4, 3]

        def interp_edge(sel, a, b):
            """Iso intersection on edge (a, b) of selected tets: [S, 3].

            Endpoints are ordered by GLOBAL corner id first, so the same
            physical edge interpolates identically regardless of which
            cell/tetrahedron asks — watertightness depends on it.
            """
            swap = tkeys[sel, a] > tkeys[sel, b]
            va = np.where(swap, tv[sel, b], tv[sel, a])
            vb = np.where(swap, tv[sel, a], tv[sel, b])
            pa = np.where(swap[:, None], tet_pos[sel, b], tet_pos[sel, a])
            pb = np.where(swap[:, None], tet_pos[sel, a], tet_pos[sel, b])
            t = (level - va) / np.where(vb != va, vb - va, 1.0)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return pa * (1 - t) + pb * t

        # Case: exactly one corner inside -> one triangle.
        for k in range(4):
            one = (count == 1) & inside[:, k]
            if not one.any():
                continue
            others = [j for j in range(4) if j != k]
            tri = np.stack([interp_edge(one, k, j) for j in others], axis=1)
            # Orient: flip for odd permutation parity so normals are
            # consistent (outward from the inside corner).
            if _needs_flip(k, others):
                tri = tri[:, ::-1]
            verts_list.append(tri.reshape(-1, 3))
            faces_list.append(
                np.arange(tri.shape[0] * 3).reshape(-1, 3) + n_verts
            )
            n_verts += tri.shape[0] * 3

        # Case: exactly three corners inside == one outside -> one triangle
        # (same edges, opposite orientation).
        for k in range(4):
            one = (count == 3) & ~inside[:, k]
            if not one.any():
                continue
            others = [j for j in range(4) if j != k]
            tri = np.stack([interp_edge(one, k, j) for j in others], axis=1)
            if not _needs_flip(k, others):
                tri = tri[:, ::-1]
            verts_list.append(tri.reshape(-1, 3))
            faces_list.append(
                np.arange(tri.shape[0] * 3).reshape(-1, 3) + n_verts
            )
            n_verts += tri.shape[0] * 3

        # Case: two inside, two outside -> quad (two triangles) across the
        # four crossing edges.
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        for a, b in pairs:
            two = (count == 2) & inside[:, a] & inside[:, b]
            if not two.any():
                continue
            c, d = [j for j in range(4) if j not in (a, b)]
            # Quad vertices in cyclic order: ac, ad, bd, bc.
            v0 = interp_edge(two, a, c)
            v1 = interp_edge(two, a, d)
            v2 = interp_edge(two, b, d)
            v3 = interp_edge(two, b, c)
            quad = np.stack([v0, v1, v2, v3], axis=1)
            if _needs_flip_quad(a, b, c, d):
                quad = quad[:, ::-1]
            t1 = quad[:, [0, 1, 2]]
            t2 = quad[:, [0, 2, 3]]
            tris = np.concatenate([t1, t2], axis=0)
            verts_list.append(tris.reshape(-1, 3))
            faces_list.append(
                np.arange(tris.shape[0] * 3).reshape(-1, 3) + n_verts
            )
            n_verts += tris.shape[0] * 3

    return n_verts


def _needs_flip(k: int, others) -> bool:
    """Whether (k, *others) is an odd permutation of (0, 1, 2, 3)."""
    perm = [k, *others]
    inversions = sum(
        1
        for i in range(4)
        for j in range(i + 1, 4)
        if perm[i] > perm[j]
    )
    return inversions % 2 == 1


def _needs_flip_quad(a, b, c, d) -> bool:
    return _needs_flip(a, [b, c, d])


def _dedupe_vertices(verts, faces):
    """Merge exactly-coincident vertices so meshes are watertight."""
    rounded = np.round(verts * 1e5).astype(np.int64)
    uniq, inverse = np.unique(rounded, axis=0, return_inverse=True)
    out_verts = np.zeros((uniq.shape[0], 3), np.float32)
    out_verts[inverse] = verts
    new_faces = inverse[faces]
    # Drop degenerate triangles produced by interpolation hitting a corner.
    keep = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    return out_verts, new_faces[keep]


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """ASCII OBJ writer (1-indexed faces, matching the reference output)."""
    if len(vertices) == 0 or len(faces) == 0:
        # Writing just the two separator newlines is not a valid OBJ for
        # strict parsers; an empty extraction is a caller decision, not a
        # file to discover later.
        raise ValueError("refusing to write an empty mesh")
    with open(path, "w") as f:
        f.write(
            "\n".join(f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in vertices.tolist())
        )
        f.write("\n")
        f.write("\n".join(f"f {a+1} {b+1} {c+1}" for a, b, c in faces.tolist()))
        f.write("\n")


def write_stl(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary STL writer (the reference's STL branch is broken; this works)."""
    tris = vertices[faces]  # [F, 3, 3]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    normals = np.cross(e1, e2)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.where(lens > 0, lens, 1.0)
    records = np.concatenate([normals[:, None], tris], axis=1).astype("<f4")
    body = records.reshape(len(faces), 12).view(np.uint8)  # 48 bytes/record
    padded = np.concatenate(
        [body, np.zeros((body.shape[0], 2), np.uint8)], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", len(faces)))
        f.write(padded)
