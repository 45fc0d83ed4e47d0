"""Warping ops of the UFlow path (port of ``arflow_tpu/ops/warp.py``).

Layout is NCHW: flows and warp coordinates are ``(B, 2, H, W)`` with
channel 0 = u (horizontal, x) and channel 1 = v (vertical, y).

``resample`` is bilinear sampling at pixel coordinates with zeros padding
per tap, the semantics of ``grid_sample(align_corners=True,
padding_mode='zeros')``. The JAX package writes it as a packed gather; here
it is ``F.grid_sample`` itself, since the JAX side is plain XLA and not a
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """Warp coordinates (flow endpoints): the pixel grid plus the flow."""
    h, w = flow.shape[-2], flow.shape[-1]
    y, x = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij",
    )
    return flow + torch.stack([x, y], dim=0)


def mask_invalid(coords: torch.Tensor) -> torch.Tensor:
    """1.0 where warp coords land inside the image, else 0.0. ``(B,1,H,W)``."""
    h, w = coords.shape[-2], coords.shape[-1]
    x, y = coords[:, 0:1], coords[:, 1:2]
    valid = (x >= 0.0) & (x <= w - 1.0) & (y >= 0.0) & (y <= h - 1.0)
    return valid.to(coords.dtype)


def resample(source: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``source`` (B,C,H,W) at pixel ``coords`` (B,2,Hq,Wq).

    Taps outside the image read zero. A bfloat16 ``source`` is sampled in
    float32 at the coordinates as given (bfloat16 ones rounded as the JAX
    package's are) and the result cast back: the JAX package gathers the
    taps itself, where ``grid_sample`` in bfloat16 would round the
    normalized coordinates once more. ``grid_sample`` takes coordinates
    normalized by ``2x/(S-1) - 1``, which has no inverse when a side S is 1
    (it would send every x to column 0). Such a side is padded with one zero
    column or row first: that pixel is exactly the zero an outside tap
    reads, so the result is unchanged and the normalization is defined.
    """
    if source.dtype == torch.bfloat16:
        return resample(source.to(torch.float32),
                        coords.to(torch.float32)).to(torch.bfloat16)
    h, w = source.shape[-2], source.shape[-1]
    pad_h, pad_w = int(h == 1), int(w == 1)
    if pad_h or pad_w:
        source = F.pad(source, (0, pad_w, 0, pad_h))
        h, w = h + pad_h, w + pad_w
    grid = torch.stack(
        [coords[:, 0] * (2.0 / (w - 1)) - 1.0,
         coords[:, 1] * (2.0 / (h - 1)) - 1.0],
        dim=-1,
    )
    return F.grid_sample(
        source, grid, mode="bilinear", padding_mode="zeros", align_corners=True
    )
