"""Image-quality metrics for evaluation tooling (host-side NumPy; the
port's own copy of ``learn_nerf_tpu.utils.metrics``).

PSNR and SSIM over u8 images, as reported by ``eval_psnr``.  SSIM follows
Wang et al. 2004 ("Image quality assessment: from error visibility to
structural similarity") with the settings NeRF papers use: an 11x11
Gaussian window (sigma 1.5), K1=0.01, K2=0.03, Gaussian-weighted local
moments (population normalization), the per-channel map averaged over the
valid windows.  NumPy only.
"""

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB (``inf`` for identical images)."""
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def _filter_valid(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable 2-D correlation ('valid' padding) over axes 0 and 1 of a
    ``[H, W, C]`` array (the Gaussian is symmetric: correlation equals
    convolution)."""
    win = sliding_window_view(img, kernel.size, axis=0)
    img = np.tensordot(win, kernel, axes=([-1], [0]))
    win = sliding_window_view(img, kernel.size, axis=1)
    return np.tensordot(win, kernel, axes=([-1], [0]))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean structural similarity of two ``[H, W]`` or ``[H, W, C]``
    images, at least 11 pixels on each side (the window)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel()
    if a.shape[0] < k.size or a.shape[1] < k.size:
        raise ValueError(f"image {a.shape[:2]} smaller than the {k.size}x{k.size} SSIM window")
    mu_a = _filter_valid(a, k)
    mu_b = _filter_valid(b, k)
    # Gaussian-weighted population moments.
    var_a = _filter_valid(a * a, k) - mu_a**2
    var_b = _filter_valid(b * b, k) - mu_b**2
    cov = _filter_valid(a * b, k) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float((num / den).mean())
