"""Layer primitives with the reference geometry (port of
``arflow_tpu/models/layers.py``, gates-off math only).

Convs pad symmetrically by ``((k-1)*dilation)//2``, which is torch's own
``padding=p``. The context deconv is ``nn.ConvTranspose2d(k=4, s=2, p=1)``,
whose weight layout ``(I, O, kh, kw)`` is the reference checkpoint's.

Mixed precision is the JAX package's ``dtype``: a conv built with a
compute dtype (``torch.bfloat16``) keeps its parameters in float32 and
casts its weight, bias and input to that dtype in ``forward``, as the JAX
convs cast kernel, bias and input (``arflow_tpu/models/layers.py``). The
casts are explicit, not ``torch.autocast``: they sit where JAX puts them,
trace unchanged under ``torch.export`` and keep no thread-local state.
Without a ``dtype`` a conv computes in its input's dtype, as ``nn.Conv2d``
does.

Rematerialization is the JAX trainer's ``remat``: inside
``rematerialized()`` each ``remat_region`` of the networks (a pyramid
level, a decoder level, the refinement) runs under non-reentrant
``torch.utils.checkpoint`` with the JAX package's ``dots_saveable`` policy:
convolution outputs are kept, the rest is recomputed in the backward, one
region at a time. The regions draw nothing (level dropout is applied
outside them) and hold no BatchNorm, so a recomputed region repeats the
first run exactly.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

LEAKY_ALPHA = 0.1
_REMAT = contextvars.ContextVar("remat", default=False)


def _save_convolutions(ctx, op, *args, **kwargs):
    """The ``dots_saveable`` policy: keep what convolutions (and transposed
    ones) output, recompute the rest."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def rematerialized():
    """Checkpoint every ``remat_region`` called in this context."""
    token = _REMAT.set(True)
    try:
        yield
    finally:
        _REMAT.reset(token)


def remat_region(fn, *args):
    """``fn(*args)``, checkpointed inside ``rematerialized()``."""
    if not _REMAT.get():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _save_convolutions))


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` where one is set."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` where one
    is set."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


def conv2d(in_channels: int, out_channels: int, kernel_size: int = 3,
           stride: int = 1, dilation: int = 1,
           dtype: torch.dtype | None = None) -> Conv2d:
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=((kernel_size - 1) * dilation) // 2,
                  dilation=dilation, compute_dtype=dtype)


def conv_transpose2d(in_channels: int, out_channels: int,
                     dtype: torch.dtype | None = None) -> ConvTranspose2d:
    return ConvTranspose2d(in_channels, out_channels, kernel_size=4,
                           stride=2, padding=1, compute_dtype=dtype)


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
