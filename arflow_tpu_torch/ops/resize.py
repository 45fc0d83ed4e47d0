"""Bilinear image and flow resizing (port of ``arflow_tpu/ops/resize.py``).

The JAX package writes each resize as two interpolation-matrix products with
torch ``F.interpolate`` weights; here it is ``F.interpolate`` itself. NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear, align_corners=False (the UFlow pyramid convention)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(img.shape[-2:]):
        return img
    return F.interpolate(img, size=(oh, ow), mode="bilinear",
                         align_corners=False)


def upsample(img: torch.Tensor, is_flow: bool, scale_factor: float = 2.0
             ) -> torch.Tensor:
    """UFlow upsample: bilinear, align_corners=False; flow values scaled."""
    h, w = img.shape[-2], img.shape[-1]
    out = resize_bilinear(img, (int(h * scale_factor), int(w * scale_factor)))
    return out * scale_factor if is_flow else out


def downsample(img: torch.Tensor, is_flow: bool, scale_factor: float = 2.0
               ) -> torch.Tensor:
    """UFlow downsample: bilinear, align_corners=False; flow values scaled."""
    h, w = img.shape[-2], img.shape[-1]
    out = resize_bilinear(img, (int(h / scale_factor), int(w / scale_factor)))
    return out / scale_factor if is_flow else out


def image_grads(image: torch.Tensor, stride: int = 1):
    """Forward differences along W, then along H, ``stride`` apart."""
    gx = image[:, :, :, stride:] - image[:, :, :, :-stride]
    gy = image[:, :, stride:, :] - image[:, :, :-stride, :]
    return gx, gy
