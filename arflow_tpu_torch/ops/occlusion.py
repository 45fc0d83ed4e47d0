"""Range maps and occlusion masks (port of ``arflow_tpu/ops/occlusion.py``).
NCHW.

The range map counts how often each pixel is sampled by a flow: a bilinear
splat of weight 1 from every pixel to its flow endpoint. Corners that fall
outside the image are dropped; the rest are accumulated with ``index_add``
over the flattened ``B*H*W`` range, the semantics of the JAX package's
``_scatter_add_bilinear``. The JAX package's one-hot matmul splat
(``_matmul_bilinear``) is a relayout for the TPU's matrix unit with the
same result and is not ported. On CUDA the add is atomic, so its order,
and the last bits of a count, vary from run to run, unless
``torch.use_deterministic_algorithms`` is on.

The ARFlow losses' masks: ``get_corresponding_map`` is the same splat from
warp coordinates; ``get_occu_mask_backward`` thresholds it (Wang et al.),
``get_occu_mask_bidirection`` tests forward-backward consistency (Brox et
al.). Both return 1.0 at occluded pixels.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.ops.warp import flow_to_warp, flow_warp


def compute_range_map(flow: torch.Tensor, row0: int = 0,
                      height: int | None = None) -> torch.Tensor:
    """How often each pixel is sampled by ``flow`` (B,2,H,W) -> (B,1,H,W).
    A band of rows from global row ``row0`` of a flow ``height`` rows high
    splats into the whole (B,1,height,W)."""
    return get_corresponding_map(flow_to_warp(flow, row0), height)


def get_corresponding_map(coords: torch.Tensor, height: int | None = None
                          ) -> torch.Tensor:
    """The bilinear splat of weight 1 from every pixel to its warp
    coordinates ``coords`` (B,2,H,W) -> (B,1,H,W), or into (B,1,height,W)."""
    b, _, h, w = coords.shape
    h = h if height is None else height
    x, y = coords[:, 0], coords[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ox, oy = x - x0, y - y0
    base = (torch.arange(b, device=coords.device) * (h * w)).view(b, 1, 1)
    counts = coords.new_zeros(b * h * w)
    for di in (0, 1):  # vertical corner offset
        for dj in (0, 1):  # horizontal corner offset
            yi, xj = y0 + di, x0 + dj
            wgt = (oy if di else 1.0 - oy) * (ox if dj else 1.0 - ox)
            valid = (yi >= 0) & (yi < h) & (xj >= 0) & (xj < w)
            wgt = torch.where(valid, wgt, 0.0)
            # A dropped corner adds 0 at pixel 0. Clamping alone would keep
            # a NaN coordinate, whose index is out of range (an IndexError
            # on the CPU, a device-side assert on CUDA); XLA's scatter drops
            # such indices.
            idx = (torch.where(valid, yi, 0.0).long() * w
                   + torch.where(valid, xj, 0.0).long() + base)
            counts = counts.index_add(0, idx.reshape(-1), wgt.reshape(-1))
    return counts.view(b, 1, h, w)


def get_occu_mask_bidirection(flow12: torch.Tensor, flow21: torch.Tensor,
                              scale: float = 0.01, bias: float = 0.5
                              ) -> torch.Tensor:
    """1.0 where ``flow12`` and ``flow21`` warped by it do not cancel:
    ``|f12 + f21(x + f12)|^2 > scale (|f12|^2 + |f21(x + f12)|^2) + bias``.
    (B,1,H,W)."""
    flow21_warped = flow_warp(flow21, flow12, pad="zeros")
    diff = flow12 + flow21_warped
    mag = (flow12 * flow12).sum(dim=1, keepdim=True) + (
        flow21_warped * flow21_warped).sum(dim=1, keepdim=True)
    occ = (diff * diff).sum(dim=1, keepdim=True) > scale * mag + bias
    return occ.to(flow12.dtype)


def get_occu_mask_backward(flow21: torch.Tensor, th: float = 0.2
                           ) -> torch.Tensor:
    """1.0 where the range map of ``flow21``, clamped to [0, 1], is below
    ``th``; with ``th = 0`` the soft mask ``1 - clamp``, detached."""
    clamped = get_corresponding_map(flow_to_warp(flow21)).clamp(0.0, 1.0)
    if th > 0:
        return (clamped < th).to(flow21.dtype)
    return 1.0 - clamped.detach()
