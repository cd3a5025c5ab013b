"""Real spherical harmonics and Ref-NeRF's integrated directional encoding
(port of ``learn_nerf_tpu.ops.sh``).

The basis comes from the associated-Legendre recurrences, unrolled in
Python over the static degree, for any degree in ``[1, 8]``.  The ordering
and signs are tiny-cuda-nn's, which equal the usual real spherical
harmonics with the Condon-Shortley phase folded in: ``Y[l*(l+1)+m]`` for
``l in [0, L)``, ``m in [-l, l]``, e.g. ``Y[1] = -0.4886 y``,
``Y[2] = +0.4886 z``, ``Y[3] = -0.4886 x``.
"""

import math
from typing import List

import torch

Tensor = torch.Tensor


def _k(l: int, m: int) -> float:
    """Normalization sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!)."""
    return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m))


def spherical_harmonics(degree: int, coords: Tensor) -> Tensor:
    """The real SH basis at unit direction vectors.

    :param degree: number of bands ``L`` in ``[1, 8]``.
    :param coords: ``[..., 3]`` unit directions.
    :return: ``[..., degree^2]`` SH values.
    """
    if not 1 <= degree <= 8:
        raise ValueError(f"degree must be in [1, 8], got {degree}")
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]

    # c[m] = cos(m*phi) * sin(theta)^m, s[m] likewise with sin(m*phi),
    # built from (x, y) = sin(theta) * (cos(phi), sin(phi)).
    c: List[Tensor] = [torch.ones_like(x)]
    s: List[Tensor] = [torch.zeros_like(x)]
    for m in range(1, degree):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])

    # p[m][l] = associated Legendre P_l^m(z) with the (1-z^2)^{m/2} factor
    # absorbed into c/s, the Condon-Shortley (-1)^m phase included.
    p = [[None] * degree for _ in range(degree)]
    for m in range(degree):
        pmm = 1.0
        for i in range(1, m + 1):
            pmm *= -(2 * i - 1)  # (-1)^m (2m-1)!!
        p[m][m] = torch.full_like(z, pmm) if m > 0 else torch.ones_like(z)
        if m + 1 < degree:
            p[m][m + 1] = (2 * m + 1) * z * p[m][m]
        for l in range(m + 2, degree):
            p[m][l] = ((2 * l - 1) * z * p[m][l - 1] - (l + m - 1) * p[m][l - 2]) / (l - m)

    out: List[Tensor] = []
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            if m == 0:
                out.append(_k(l, 0) * p[0][l])
            elif m > 0:
                out.append(math.sqrt(2.0) * _k(l, m) * p[m][l] * c[m])
            else:
                out.append(math.sqrt(2.0) * _k(l, am) * p[am][l] * s[am])
    return torch.stack(out, dim=-1)


def sh_band_indices(degree: int, device=None) -> Tensor:
    """Band index ``l`` of each SH coefficient, shape ``[degree^2]`` (f32):
    coefficient ``i`` lies in band ``l`` when ``l^2 <= i < (l+1)^2``.
    Computed on ``device`` (a tensor made from a Python list is a host copy,
    which a captured train step may not make)."""
    i = torch.arange(degree * degree, device=device)
    squares = torch.arange(1, degree, device=device) ** 2
    return (squares[None, :] <= i[:, None]).sum(dim=1).to(torch.float32)


def integrated_dir_enc(degree: int, coords: Tensor, roughness: Tensor) -> Tensor:
    """Ref-NeRF's integrated directional encoding: the SH coefficients
    attenuated by ``exp(-roughness * l(l+1)/2)``, so that rougher surfaces
    blur the directional signal.

    :param degree: SH bands in ``[1, 8]``.
    :param coords: ``[..., 3]`` unit reflection directions.
    :param roughness: ``[..., 1]`` non-negative roughness.
    :return: ``[..., degree^2]`` encoding.
    """
    levels = sh_band_indices(degree, coords.device)
    attenuation = torch.exp(-roughness * (levels * (levels + 1.0)) * 0.5)
    return spherical_harmonics(degree, coords) * attenuation
