"""The random draws each cell's timed path makes, worked out again from
the seeds the harness gives the program.

The train loops seed one generator a step with ``fold_seed(base seed, 0,
step)`` (splitmix64's finaliser over the three, shifted to 63 bits) and
fill their uniform buffers from it in the order the loss reads them: the
occupancy loop its ``[N, C]`` candidate uniforms, the hierarchy its ``[N,
coarse]`` then its ``[N, fine]`` uniforms.  A frame's tiles draw from the
frame's generator in tile order: the occupancy path one ``[S, C]`` block a
tile, the hierarchy ``[S, coarse]`` then ``[S, fine]``.
"""

import torch

MASK64 = (1 << 64) - 1


def fold_seed(base_seed: int, tag: int, step: int) -> int:
    z = (base_seed * 0x9E3779B97F4A7C15 + tag * 0xD1B54A32D192ED03 + step * 0x94D049BB133111EB) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


def train_uniforms(base_seed: int, step: int, widths, rays: int, device) -> list:
    """The step's uniform blocks ``[rays, w]``, one for each width in
    ``widths``, in draw order."""
    generator = torch.Generator(device=device).manual_seed(fold_seed(base_seed, 0, step))
    return [torch.empty((rays, w), dtype=torch.float32, device=device).uniform_(generator=generator)
            for w in widths]


def frame_uniforms(frame_seed: int, skip_tiles: int, tile: int, widths, device):
    """Yields each tile's uniform blocks ``[tile, w]`` in tile order, after
    ``skip_tiles`` tiles' worth (an auto-budget frame that overflowed
    renders again with the draws that follow its first pass)."""
    generator = torch.Generator(device=device).manual_seed(frame_seed)
    for _ in range(skip_tiles):
        for w in widths:
            torch.rand((tile, w), generator=generator, device=device)
    while True:
        yield [torch.rand((tile, w), generator=generator, device=device) for w in widths]
