"""Warping ops of the UFlow path (port of ``arflow_tpu/ops/warp.py``).

Layout is NCHW: flows and warp coordinates are ``(B, 2, H, W)`` with
channel 0 = u (horizontal, x) and channel 1 = v (vertical, y).

``resample`` is bilinear sampling at pixel coordinates with zeros padding
per tap, the semantics of ``grid_sample(align_corners=True,
padding_mode='zeros')``. The JAX package writes it as a packed gather; here
it is ``F.grid_sample`` itself, since the JAX side is plain XLA and not a
Pallas kernel. ``flow_warp`` is the PWC-Lite family's warp, with zeros or
border padding and both ``align_corners`` conventions.

``bilinear_gather_with_grads`` / ``resample_with_grads`` sample the same
interpolant and also return its exact within-cell partials in x and y, all
from one gather of the four taps (the ELBO's Taylor warp,
``losses/blocks.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_to_warp(flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Warp coordinates (flow endpoints): the pixel grid plus the flow.
    ``row0``: the global row of the flow's first row (a band of rows)."""
    h, w = flow.shape[-2], flow.shape[-1]
    y, x = torch.meshgrid(
        torch.arange(row0, row0 + h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij",
    )
    return flow + torch.stack([x, y], dim=0)


def mask_invalid(coords: torch.Tensor, height: int | None = None
                 ) -> torch.Tensor:
    """1.0 where warp coords land inside the image, else 0.0. ``(B,1,H,W)``.
    ``height``: the image's (default: the coordinates' own; a band's rows
    test against the whole image's)."""
    h, w = coords.shape[-2], coords.shape[-1]
    h = h if height is None else height
    x, y = coords[:, 0:1], coords[:, 1:2]
    valid = (x >= 0.0) & (x <= w - 1.0) & (y >= 0.0) & (y <= h - 1.0)
    return valid.to(coords.dtype)


def border_mask(flow: torch.Tensor) -> torch.Tensor:
    """1.0 where the flow's endpoint lands strictly inside the image (no
    endpoint on the border), else 0.0. ``(B,1,H,W)``."""
    h, w = flow.shape[-2], flow.shape[-1]
    coords = flow_to_warp(flow)
    x, y = coords[:, 0:1], coords[:, 1:2]
    valid = (x > 0.0) & (x < w - 1.0) & (y > 0.0) & (y < h - 1.0)
    return valid.to(flow.dtype)


def resample(source: torch.Tensor, coords: torch.Tensor,
             padding: str = "zeros") -> torch.Tensor:
    """Bilinear sample of ``source`` (B,C,H,W) at pixel ``coords`` (B,2,Hq,Wq).

    Taps outside the image read zero (``padding="zeros"``), or the
    coordinates are clamped to the image (``"border"``). A bfloat16
    ``source`` is sampled in float32 at the coordinates as given (bfloat16
    ones rounded as the JAX package's are) and the result cast back: the
    JAX package gathers the taps itself, where ``grid_sample`` in bfloat16
    would round the normalized coordinates once more. ``grid_sample`` takes coordinates
    normalized by ``2x/(S-1) - 1``, which has no inverse when a side S is 1
    (it would send every x to column 0). Such a side is padded with one zero
    column or row first: that pixel is exactly the zero an outside tap
    reads, so the result is unchanged and the normalization is defined.
    With border padding the side is padded with a copy of its pixel, which
    the clamp to [0, 0] reads alone either way.
    """
    if source.dtype == torch.bfloat16:
        return resample(source.to(torch.float32), coords.to(torch.float32),
                        padding).to(torch.bfloat16)
    h, w = source.shape[-2], source.shape[-1]
    pad_h, pad_w = int(h == 1), int(w == 1)
    if pad_h or pad_w:
        source = F.pad(source, (0, pad_w, 0, pad_h),
                       mode="replicate" if padding == "border" else "constant")
        h, w = h + pad_h, w + pad_w
    grid = torch.stack(
        [coords[:, 0] * (2.0 / (w - 1)) - 1.0,
         coords[:, 1] * (2.0 / (h - 1)) - 1.0],
        dim=-1,
    )
    return F.grid_sample(
        source, grid, mode="bilinear", padding_mode=padding, align_corners=True
    )


def _gather_taps(source, x, y, padding="zeros"):
    """The 2x2 neighbourhood of each point (x, y) (B,Hq,Wq) in ``source``
    (B,C,H,W), from one gather: taps (B,4C,Hq,Wq) ordered (y0,x0),
    (y0,x1), (y1,x0), (y1,x1); x and y after the border clamp, their
    floors, and the zeros padding's whole-sample mask (None for border).

    Zeros padding packs over a zero-padded (H+2, W+2) canvas, so that the
    window of any x0 in [-1, W-1] is addressable, and a point outside
    [-1, W) x [-1, H) reads nothing (the mask). Border padding clamps the
    point into the image and pads one edge copy at the bottom and right.
    A NaN point reads the canvas's corner, and its weights carry the NaN
    into the result, as the JAX gather's do."""
    b, c, h, w = source.shape
    if padding == "border":
        x, y = x.clamp(0.0, w - 1.0), y.clamp(0.0, h - 1.0)
        canvas = F.pad(source, (0, 1, 0, 1), mode="replicate")
        x0, y0 = torch.floor(x), torch.floor(y)
        ix, iy = x0.nan_to_num(0.0).long(), y0.nan_to_num(0.0).long()
        mask = None
    else:
        canvas = F.pad(source, (1, 1, 1, 1))
        x0, y0 = torch.floor(x), torch.floor(y)
        ix = (x0.nan_to_num(-1.0).clamp(-1, w - 1) + 1).long()
        iy = (y0.nan_to_num(-1.0).clamp(-1, h - 1) + 1).long()
        mask = ((x >= -1.0) & (x < w) & (y >= -1.0)
                & (y < h)).to(source.dtype).unsqueeze(1)
    packed = torch.cat([canvas[:, :, :-1, :-1], canvas[:, :, :-1, 1:],
                        canvas[:, :, 1:, :-1], canvas[:, :, 1:, 1:]], dim=1)
    ph, pw = packed.shape[-2:]
    idx = (iy * pw + ix).reshape(b, 1, -1).expand(b, 4 * c, -1)
    taps = packed.reshape(b, 4 * c, ph * pw).gather(2, idx)
    return taps.reshape((b, 4 * c) + x.shape[1:]), x, y, x0, y0, mask


def bilinear_gather_with_grads(source: torch.Tensor, x: torch.Tensor,
                               y: torch.Tensor, padding: str = "zeros"):
    """Bilinear sample of ``source`` (B,C,H,W) at pixel coordinates x, y
    (B,Hq,Wq), with the interpolant's partials in x and y:
    ``(value, gx, gy)``, each (B,C,Hq,Wq). Within a 2x2 cell the
    interpolant is bilinear, so

        gx = wy0 (t01 - t00) + wy1 (t11 - t10)
        gy = wx0 (t10 - t00) + wx1 (t11 - t01)

    are its exact derivatives there, from the taps the value reads. At an
    integer coordinate the cell is the one to its right (below), as
    ``floor`` picks it. Gradients reach x and y through the weights; a
    bfloat16 ``source`` is sampled in float32 and the results cast back."""
    if source.dtype == torch.bfloat16:
        out = bilinear_gather_with_grads(source.to(torch.float32),
                                         x.to(torch.float32),
                                         y.to(torch.float32), padding)
        return tuple(t.to(torch.bfloat16) for t in out)
    c = source.shape[1]
    taps, x, y, x0, y0, mask = _gather_taps(source, x, y, padding)
    t00, t01, t10, t11 = taps.split(c, dim=1)
    wx1, wy1 = (x - x0).unsqueeze(1), (y - y0).unsqueeze(1)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    val = wy0 * (wx0 * t00 + wx1 * t01) + wy1 * (wx0 * t10 + wx1 * t11)
    gx = wy0 * (t01 - t00) + wy1 * (t11 - t10)
    gy = wx0 * (t10 - t00) + wx1 * (t11 - t01)
    if mask is not None:
        val, gx, gy = val * mask, gx * mask, gy * mask
    return val, gx, gy


def resample_with_grads(source: torch.Tensor, coords: torch.Tensor):
    """``resample`` (zeros padding) with the interpolant's exact partials:
    ``bilinear_gather_with_grads`` at ``coords`` (B,2,Hq,Wq)."""
    return bilinear_gather_with_grads(source, coords[:, 0], coords[:, 1])


def flow_warp(x: torch.Tensor, flow: torch.Tensor, pad: str = "zeros",
              align_corners: bool = True) -> torch.Tensor:
    """``x`` (B,C,H,W) sampled at the pixel grid plus ``flow`` (B,2,H,W),
    bilinear, with ``pad`` "zeros" or "border". ``align_corners=False``
    remaps pixel coordinate p to ``p * S / (S - 1) - 0.5`` first, the
    half-pixel convention of ``grid_sample`` on the align-corners grid
    (``arflow_tpu/ops/warp.py:flow_warp``)."""
    if pad not in ("zeros", "border"):
        raise ValueError(f"flow_warp pad {pad!r}: 'zeros' or 'border'")
    coords = flow_to_warp(flow)
    if not align_corners:
        h, w = x.shape[-2], x.shape[-1]
        coords = torch.stack(
            [coords[:, 0] * w / max(w - 1, 1) - 0.5,
             coords[:, 1] * h / max(h - 1, 1) - 0.5], dim=1)
    return resample(x, coords, padding=pad)
