"""The data path's batches, held to the scene: every row a batch serves is
one pixel's (origin, direction, colour) of one training view, exactly as
the dataset layout defines it (colours ``v / 127.5 - 1``), and no row
comes twice."""

from typing import List, Tuple

import numpy as np

from .. import scene


def batch_mismatch(batches: List[np.ndarray], views: List[Tuple["scene.Camera", np.ndarray]]) -> dict:
    """``rows_wrong``: rows that are no pixel's row of any view, bit for
    bit; ``rows_repeated``: rows served more than once."""
    size = views[0][1].shape[0]
    rows = np.concatenate(batches).reshape(-1, 9)
    origins = np.stack([np.asarray(cam.origin, dtype=np.float32) for cam, _ in views])
    view = np.full(rows.shape[0], -1)
    for i, o in enumerate(origins):
        view[np.all(rows[:, 0:3] == o, axis=1)] = i
    wrong = int(np.sum(view < 0))
    expected = np.zeros_like(rows)
    pixel = np.zeros(rows.shape[0], dtype=np.int64)
    for i, (cam, image) in enumerate(views):
        sel = view == i
        if not sel.any():
            continue
        d = rows[sel, 3:6].astype(np.float64)
        z, x, y = (np.asarray(v, dtype=np.float64) for v in (cam.z, cam.x, cam.y))
        along = d @ z
        col = np.rint(((d @ x) / along / np.tan(cam.x_fov / 2) + 1) / 2 * (size - 1)).astype(np.int64)
        row = np.rint(((d @ y) / along / np.tan(cam.y_fov / 2) + 1) / 2 * (size - 1)).astype(np.int64)
        inside = (col >= 0) & (col < size) & (row >= 0) & (row < size)
        flat = np.clip(row, 0, size - 1) * size + np.clip(col, 0, size - 1)
        rays = scene.bare_rays(cam, size, size)[flat]
        colours = image.reshape(-1, 3)[flat].astype(np.float32) / 127.5 - 1.0
        expected[sel] = np.concatenate([rays.reshape(-1, 6), colours], axis=1)
        pixel[sel] = i * size * size + flat
        wrong += int(np.sum(~inside))
    wrong += int(np.sum(np.any(rows != expected, axis=1) & (view >= 0)))
    return dict(rows_wrong=wrong, rows_repeated=int(rows.shape[0] - np.unique(pixel[view >= 0]).shape[0]))
