"""Training losses: L1 + D-SSIM, the standard 3DGS photometric objective.

Counterpart of ``gausplat_tpu/train/losses.py``:
``(1 - lam) * L1 + lam * (1 - SSIM)`` with ``lam = 0.2``; SSIM uses an
11x11 Gaussian window as two separable 1-D depthwise convolutions with
SAME zero padding (``F.conv2d``, one group per channel).

On a CUDA card ``F.conv2d`` goes through cuDNN, which by default runs an
f32 convolution in TF32 (``torch.backends.cudnn.allow_tf32`` is True) and
keeps about three digits; code that holds these losses to a reference on
the card turns that off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _window_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The window on ``device``, copied there once (a captured CUDA graph
    may copy nothing from the host)."""
    return torch.as_tensor(_gaussian_window(size, sigma), device=device)


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with SAME zero padding by the
    1-D window ``kernel`` (on the image's device)."""
    size = kernel.shape[0]
    # Channels as the batch: [C, 1, H, W] with a one-channel kernel.
    x = img.permute(2, 0, 1)[:, None]
    x = F.conv2d(x, kernel.reshape(1, 1, size, 1), padding=(size // 2, 0))
    x = F.conv2d(x, kernel.reshape(1, 1, 1, size), padding=(0, size // 2))
    return x[:, 0].permute(1, 2, 0)


def ssim_map(a: torch.Tensor, b: torch.Tensor, size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map between two [H, W, C] images."""
    w = _window_on(size, sigma, a.device)
    mu_a, mu_b = _blur(a, w), _blur(b, w)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # E[x^2] - E[x]^2 can go slightly negative in f32; a variance cannot.
    sig_a = torch.clamp_min(_blur(a * a, w) - mu_aa, 0.0)
    sig_b = torch.clamp_min(_blur(b * b, w) - mu_bb, 0.0)
    sig_ab = _blur(a * b, w) - mu_ab
    num = (2 * mu_ab + SSIM_C1) * (2 * sig_ab + SSIM_C2)
    den = (mu_aa + mu_bb + SSIM_C1) * (sig_a + sig_b + SSIM_C2)
    return num / den


def ssim(a: torch.Tensor, b: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between two [H, W, C] images in [0, 1]."""
    return torch.mean(ssim_map(a, b, size, sigma))


def photometric_loss(rendered: torch.Tensor, target: torch.Tensor,
                     ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - lam) * L1 + lam * (1 - SSIM)."""
    l1 = torch.mean(torch.abs(rendered - target))
    if ssim_weight == 0.0:
        return l1
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(rendered, target))


def psnr(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((rendered - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
