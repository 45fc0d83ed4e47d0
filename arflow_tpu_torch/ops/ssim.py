"""SSIM distances (port of ``arflow_tpu/ops/ssim.py``). NCHW.

``ssim_loss`` is UFlow's decomposed variant (SAME padding), the ELBO
loss's ``ssim`` data term; ``ssim_dist`` is ARFlow's (VALID padding), the
unflow, elbo and fullres losses' photometric term. The moments are
stride-1 box means whose divisor counts the zero padding, as torch's
``avg_pool2d(count_include_pad=True)`` and the JAX ``reduce_window`` sum
over the full window have it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arflow_tpu_torch.ops.census import _group_normalize, zero_mask_border

C1 = 0.01**2
C2 = 0.03**2


def avg_pool(x: torch.Tensor, patch_size: int, padding: str = "SAME"
             ) -> torch.Tensor:
    """Stride-1 box mean over ``patch_size`` squared pixels; ``"SAME"``
    pads ``patch_size // 2`` zeros on each side and counts them."""
    pad = patch_size // 2 if padding == "SAME" else 0
    return F.avg_pool2d(x, patch_size, stride=1, padding=pad,
                        count_include_pad=True)


def _moments(image_a, image_b, patch_size, padding):
    mu_x = avg_pool(image_a, patch_size, padding)
    mu_y = avg_pool(image_b, patch_size, padding)
    sigma_x = avg_pool(image_a * image_a, patch_size, padding) - mu_x**2
    sigma_y = avg_pool(image_b * image_b, patch_size, padding) - mu_y**2
    sigma_xy = avg_pool(image_a * image_b, patch_size, padding) - mu_x * mu_y
    return mu_x, mu_y, sigma_x, sigma_y, sigma_xy


def ssim_loss(image_a: torch.Tensor, image_b: torch.Tensor,
              mask: torch.Tensor, patch_size: int = 7, num_groups: int = 1):
    """UFlow's decomposed SSIM: ([d1_sq, d2_sq], weights), the luminance
    and contrast-structure distances clipped to [0, 1], and the
    border-zeroed mask divided by its (detached) sum per batch group."""
    mu_x, mu_y, sigma_x, sigma_y, sigma_xy = _moments(
        image_a, image_b, patch_size, "SAME")
    s1 = (2 * mu_x * mu_y + C1) / (mu_x**2 + mu_y**2 + C1)
    s2 = (2 * sigma_xy + C2) / (sigma_x + sigma_y + C2)
    d1_sq = (1 - s1).clamp(0.0, 1.0)
    d2_sq = (1 - s2).clamp(0.0, 1.0)
    weights = _group_normalize(zero_mask_border(mask, patch_size), num_groups)
    return [d1_sq, d2_sq], weights


def ssim_dist(x: torch.Tensor, y: torch.Tensor, md: int = 1) -> torch.Tensor:
    """ARFlow's SSIM distance ``(1 - SSIM) / 2`` clipped to [0, 1], over
    ``2 md + 1`` square windows without padding: (B,C,H-2md,W-2md)."""
    mu_x, mu_y, sigma_x, sigma_y, sigma_xy = _moments(x, y, 2 * md + 1,
                                                      "VALID")
    ssim_n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    ssim_d = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    return ((1 - ssim_n / ssim_d) / 2).clamp(0.0, 1.0)
