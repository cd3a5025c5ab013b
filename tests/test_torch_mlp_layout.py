"""The fused MLP kernels' weight stream (PackedMLP.kernel_weights): the
padded, swizzled K-major layout the Hopper kernels' wgmma descriptors read
(csrc/sm90.cuh, csrc/nerf_mlp.cuh), built in Python and checked here.

Unpacking the stream gives back the packed matrices bit for bit, padded
with zeros to the full widths; every ring stage the kernel's producer
copies is a legal bulk copy; the swizzle puts each 16-byte chunk where the
128-byte swizzle mode reads it, and a wrong swizzle phase breaks the round
trip.
"""

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.kernels import fused_mlp as fm

from .torch_helpers import port_model, random_flax_tree

WIDTHS = {
    "full": dict(input_layers=5, mid_layers=4, hidden=256, color=128),
    "narrow": dict(input_layers=2, mid_layers=2, hidden=40, color=20),
}


def _packed(width):
    w = WIDTHS[width]
    tree = random_flax_tree(11, **w)
    return port_model(tree, "bfloat16", input_layers=w["input_layers"],
                      mid_layers=w["mid_layers"]).packed()


def _bits(x):
    return x.contiguous().view(torch.int16)


def _unpack(flat, k, n, phase=None):
    """``[K, N]`` from one matrix of the stream: slice s, row r, position p
    holds chunk ``p ^ phase[r]`` (``r % 8`` by default) of column r's
    K-values 64 s .. 64 s + 63."""
    phase = torch.arange(n) % 8 if phase is None else phase
    slices = flat.view(k // fm.SLICE_K, n, 8, 8)
    out = torch.empty_like(slices)
    for p in range(8):
        out[:, torch.arange(n), p ^ phase] = slices[:, :, p]
    return out.permute(1, 0, 2, 3).reshape(n, k).t()


def _stream(packed, phase=None):
    """The full-width matrices of ``kernel_weights``, in order."""
    offset = 0
    for k, n in fm.kernel_matrix_shapes(packed.input_layers, packed.mid_layers):
        yield _unpack(packed.kernel_weights[offset : offset + k * n], k, n, phase)
        offset += k * n


@pytest.mark.parametrize("width", ["full", "narrow"])
def test_kernel_weights_unpack_to_the_packed_matrices(width):
    packed = _packed(width)
    shapes = fm.kernel_matrix_shapes(packed.input_layers, packed.mid_layers)
    assert packed.kernel_weights.dtype == torch.bfloat16
    assert packed.kernel_weights.numel() == sum(k * n for k, n in shapes)
    mats, full = list(packed.matrices()), list(_stream(packed))
    assert len(mats) == len(full) == len(shapes)
    for m, f, shape in zip(mats, full, shapes):
        assert tuple(f.shape) == shape
        k, n = m.shape
        assert torch.equal(_bits(f[:k, :n]), _bits(m))
        padding = f.clone()
        padding[:k, :n] = 0
        assert not _bits(padding).any()
    offset = 0
    for b, n in zip(packed.bias_vectors(), fm.kernel_bias_sizes(packed.input_layers, packed.mid_layers)):
        kb = packed.kernel_biases[offset : offset + n]
        assert torch.equal(kb[: b.numel()], b) and not kb[b.numel():].any()
        offset += n
    assert offset == packed.kernel_biases.numel()


@pytest.mark.parametrize("width", ["full", "narrow"])
def test_ring_stages_are_legal_bulk_copies(width):
    """The producer copies each matrix in pieces of at most STAGE_BYTES
    (csrc/nerf_mlp.cuh Producer::load)."""
    packed = _packed(width)
    stages, start = [], 0
    for k, n in fm.kernel_matrix_shapes(packed.input_layers, packed.mid_layers):
        size = 2 * k * n
        for o in range(0, size, fm.STAGE_BYTES):
            piece = min(fm.STAGE_BYTES, size - o)
            # A stage holds whole 64-deep slices: 128 bytes per column.
            assert o % (128 * n) == 0 and piece % (128 * n) == 0
            stages.append((start + o, piece))
        start += size
    assert start == 2 * packed.kernel_weights.numel()
    for offset, size in stages:
        assert offset % 128 == 0 and size % 16 == 0 and 0 < size <= fm.STAGE_BYTES
    if width == "full":  # 1,180 KiB per tile: 36 stages of 32 KiB, then 8, 16 and 4
        assert start == 1180 * 1024 and len(stages) == 39
        assert [size for _, size in stages[-5:]] == [8192, 32768, 32768, 16384, 4096]


def test_swizzle_puts_chunk_c_of_row_n_at_c_xor_n_mod_8():
    k, n = 128, 24
    ids = torch.arange(k * n).reshape(k, n)
    flat = fm.swizzle_k_major(ids)
    rng = np.random.RandomState(0)
    for kk, nn in zip(rng.randint(0, k, 200).tolist(), rng.randint(0, n, 200).tolist()):
        s, within = divmod(kk, fm.SLICE_K)
        chunk, lane = divmod(within, 8)
        assert flat[s * n * 64 + nn * 64 + (chunk ^ (nn % 8)) * 8 + lane] == ids[kk, nn]
    assert torch.equal(_unpack(flat, k, n), ids)


WRONG_PHASES = {
    "row + 1": lambda r: (r + 1) % 8,
    "row // 8": lambda r: (r // 8) % 8,
    "unswizzled": lambda r: r * 0,
}


@pytest.mark.parametrize("phase", sorted(WRONG_PHASES))
def test_a_wrong_swizzle_phase_breaks_the_round_trip(phase):
    packed = _packed("full")
    first = next(packed.matrices())  # the first input layer, [64, 256]
    right = next(_stream(packed))
    wrong = next(_stream(packed, WRONG_PHASES[phase](torch.arange(fm.MAX_HIDDEN))))
    assert torch.equal(_bits(right), _bits(first))
    assert not torch.equal(_bits(wrong), _bits(first))
