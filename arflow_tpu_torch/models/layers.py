"""Layer primitives with the reference geometry (port of
``arflow_tpu/models/layers.py``, gates-off math only).

Convs pad symmetrically by ``((k-1)*dilation)//2``, which is torch's own
``padding=p``. The context deconv is ``nn.ConvTranspose2d(k=4, s=2, p=1)``,
whose weight layout ``(I, O, kh, kw)`` is the reference checkpoint's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LEAKY_ALPHA = 0.1


def conv2d(in_channels: int, out_channels: int, kernel_size: int = 3,
           stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=((kernel_size - 1) * dilation) // 2,
                     dilation=dilation)


def conv_transpose2d(in_channels: int, out_channels: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(in_channels, out_channels, kernel_size=4,
                              stride=2, padding=1)


def leaky_relu(x: torch.Tensor, negative_slope: float = LEAKY_ALPHA
               ) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


@torch.no_grad()
def init_xavier_uniform(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform weights and zero biases for every (transposed) conv
    and linear layer, in module order, drawn from ``generator`` (the UFlow
    init)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
