"""Coordinate encodings (port of ``learn_nerf_tpu.ops.encoding``)."""

import torch

Tensor = torch.Tensor


def sinusoidal_features(coords: Tensor, freqs: int) -> Tensor:
    """NeRF positional encoding: sin/cos at power-of-two frequencies.

    For each input dim the ``freqs`` sines come first, then the ``freqs``
    cosines: ``[sin(x*1)..sin(x*2^{k-1}), cos(x*1)..cos(x*2^{k-1}),
    sin(y*1)...]``.  Always f32: the angles reach ``2^(k-1) * |x|``.

    :param coords: ``[..., D]`` coordinates.
    :param freqs: number of octaves ``k``.
    :return: ``[..., D * 2 * freqs]`` features.
    """
    coeffs = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=coords.device)
    angles = coords[..., None] * coeffs  # [..., D, k]
    feats = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return feats.reshape(feats.shape[:-2] + (-1,))
