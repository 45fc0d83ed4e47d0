"""Cost volume and feature normalization (port of
``arflow_tpu/ops/cost_volume.py``). NCHW.

``compute_cost_volume`` calls the op ``arflow::cost_volume``: a CUDA tensor
goes to the hand-written kernel, a CPU tensor to the plain version, forward
and backward (``ops/cuda/cost_volume.py`` registers the op and holds both).
There is no switch and no fallback.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.ops.cuda.cost_volume import (  # noqa: F401
    compute_cost_volume_reference,
    cost_volume_grad_reference,
)


def compute_cost_volume(features1: torch.Tensor, features2: torch.Tensor,
                        max_displacement: int = 4) -> torch.Tensor:
    """(B,C,H,W) x (B,C,H,W) -> (B,(2md+1)**2,H,W), channel mean of the
    shifted products, dy-major."""
    return torch.ops.arflow.cost_volume(features1, features2,
                                        int(max_displacement))


def normalize_features(f1: torch.Tensor, f2: torch.Tensor):
    """Centre and scale both feature maps before the cost volume.

    Moments are taken per image over (C,H,W), then averaged across the two
    images; the variance is unbiased (n - 1 with n = C*H*W), as
    ``torch.var``.
    """
    dims = (1, 2, 3)
    n = f1.shape[1] * f1.shape[2] * f1.shape[3]
    m1, m2 = f1.mean(dim=dims, keepdim=True), f2.mean(dim=dims, keepdim=True)
    v1 = (f1 - m1).square().sum(dim=dims, keepdim=True) / max(n - 1, 1)
    v2 = (f2 - m2).square().sum(dim=dims, keepdim=True) / max(n - 1, 1)
    mean = (m1 + m2) / 2
    std = torch.sqrt((v1 + v2) / 2 + 1e-16)
    return (f1 - mean) / std, (f2 - mean) / std
