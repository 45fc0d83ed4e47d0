"""Range map for occlusion estimation (port of
``arflow_tpu/ops/occlusion.py:compute_range_map``). NCHW.

The range map counts how often each pixel is sampled by a flow: a bilinear
splat of weight 1 from every pixel to its flow endpoint. Corners that fall
outside the image are dropped; the rest are accumulated with ``index_add``
over the flattened ``B*H*W`` range, the semantics of the JAX package's
``_scatter_add_bilinear``. The JAX package's one-hot matmul splat
(``_matmul_bilinear``) is a relayout for the TPU's matrix unit with the
same result and is not ported. On CUDA the add is atomic, so its order,
and the last bits of a count, vary from run to run.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.ops.warp import flow_to_warp


def compute_range_map(flow: torch.Tensor) -> torch.Tensor:
    """How often each pixel is sampled by ``flow`` (B,2,H,W) -> (B,1,H,W)."""
    b, _, h, w = flow.shape
    coords = flow_to_warp(flow)
    x, y = coords[:, 0], coords[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    ox, oy = x - x0, y - y0
    base = (torch.arange(b, device=flow.device) * (h * w)).view(b, 1, 1)
    counts = flow.new_zeros(b * h * w)
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
