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

The int8 feature pyramid is the JAX package's ``model.dtype: "int8"``
(serving only): each pyramid conv (``Conv2d.int8`` not None, the JAX
``Conv2dNPad``) computes ``quantized_conv2d`` where
``int8_pyramid_enabled`` says so. The activations are quantized per
sample, the weights per output channel, both symmetric to [-127, 127];
the int8 conv sums in int32 (an im2col and one ``torch._int_mm``, on the
card cuBLASLt's int8 GEMM) and is dequantized in float32. The integers
equal the JAX package's, and so does the float32 arithmetic around them
as XLA compiles it at batch 2 and more (at batch 1 XLA folds the two
scales' ``/ 127`` into one ``/ 16129``; the port keeps one arithmetic for
every batch, so a sample's result does not depend on its batch).

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
import os

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


# The JAX quantizer's ``/ 127.0`` as XLA compiles it under ``jit``: a
# division by a constant becomes a product with its float32 reciprocal.
_INV_127 = 1.0 / 127.0
# cuBLASLt's int8 GEMM takes M > 16 rows and K, N multiples of 8 (every
# pyramid's N is).
_MM_MIN_ROWS = 17
_MM_MULTIPLE = 8


def int8_pyramid_enabled(default: bool = False) -> bool:
    """Whether a pyramid conv quantizes: ``default`` is its ``int8``
    (``model.dtype: "int8"``, set per instance, never process state), and
    ``ARFLOW_INT8_PYRAMID=0/1`` overrides it both ways. Read at every
    call. Serving only: the rounding has zero gradient, and ``train_main``
    refuses both forms."""
    env = os.environ.get("ARFLOW_INT8_PYRAMID")
    if env is not None:
        return env == "1"
    return default


def quantize_activations(x: torch.Tensor):
    """Per-sample symmetric int8 of NCHW ``x``: ``(xq, ax)``, ``xq`` the
    int8 values as a contiguous NHWC tensor, ``ax`` (B,1,1,1) float32 the
    scales, ``max(max |x|, 1e-6) / 127``; the rounding is half to even."""
    xf = x.float()
    ax = xf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6) * _INV_127
    xq = torch.round(xf / ax).clamp(-127, 127).to(
        torch.int8, memory_format=torch.channels_last)
    return xq.permute(0, 2, 3, 1), ax


def quantize_weights(weight: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW kernel: ``(wq, sw)``,
    ``wq`` int8 OIHW, ``sw`` (O,) float32 the scales,
    ``max(max |w|, 1e-12) / 127``."""
    sw = weight.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) * _INV_127
    wq = torch.round(weight / sw[:, None, None, None]).clamp(-127, 127)
    return wq.to(torch.int8), sw


def im2col(xq: torch.Tensor, k: int, stride: int, pad: int):
    """(B,H,W,C) -> the (B*Ho*Wo, C*k*k) patch matrix of a kxk conv, each
    row in (c, kh, kw) order, an OIHW kernel's; and (B, Ho, Wo). Built
    from a padded, strided view in one copy (``F.unfold`` takes no
    int8)."""
    cols = F.pad(xq, (0, 0, pad, pad, pad, pad)).unfold(1, k, stride).unfold(
        2, k, stride)
    b, ho, wo = cols.shape[:3]
    return cols.reshape(b * ho * wo, -1), (b, ho, wo)


def int8_matmul(a: torch.Tensor, wq2d: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ wq2d.T`` of int8 ``a`` (M, K) and ``wq2d`` (N, K) by
    ``torch._int_mm``; zero rows and columns pad M and K up to what
    cuBLASLt takes (the stem's K of 27 to 32; M of the coarsest level of a
    small image), which adds nothing to a sum. On a CUDA tensor it runs
    the card's GEMM or raises."""
    m, k = a.shape
    mp, kp = max(m, _MM_MIN_ROWS), -(-k // _MM_MULTIPLE) * _MM_MULTIPLE
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
        wq2d = F.pad(wq2d, (0, kp - k))
    return torch._int_mm(a, wq2d.t())[:m]


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int
              ) -> torch.Tensor:
    """The int32 sums of the int8 conv of ``xq`` (B,H,W,C) with the int8
    OIHW kernel ``wq``: (B, Ho, Wo, O), an im2col and one int8 GEMM."""
    a, (b, ho, wo) = im2col(xq, wq.shape[-1], stride, pad)
    return int8_matmul(a, wq.reshape(wq.shape[0], -1)).unflatten(0, (b, ho, wo))


def int8_conv_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                        pad: int) -> torch.Tensor:
    """``int8_conv``'s plain version: ``F.conv2d`` in float64 on the
    integers, as int32. Exact: every sum is at most 127**2 * K in
    magnitude (4.7e6 at K = 288), far below 2**53."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride,
                 padding=pad)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def dequantize(y: torch.Tensor, ax: torch.Tensor, sw: torch.Tensor,
               bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``y * (ax * sw) + bias`` in float32 of the int32 NHWC sums, handed
    on as a contiguous NCHW tensor of ``dtype`` (the transpose rides on
    the cast). ``addcmul`` rounds the product and the sum once, as the
    multiply-add that XLA fuses in the JAX package's (a product rounded
    before the sum parts from it where the sum cancels)."""
    out = torch.addcmul(bias, y.float(), ax * sw)
    return out.permute(0, 3, 1, 2).to(dtype, memory_format=torch.contiguous_format)


def quantized_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stride: int, pad: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's dynamically quantized conv
    (``arflow_tpu/models/layers.py:quantized_conv2d``) on NCHW ``x`` and an
    OIHW float32 ``weight``: per-sample activation scales (a sample's
    result does not depend on its batch), per-output-channel weight
    scales, int32 sums, float32 dequantization plus ``bias``, then
    ``dtype``. Takes and hands on contiguous NCHW."""
    xq, ax = quantize_activations(x)
    wq, sw = quantize_weights(weight)
    return dequantize(int8_conv(xq, wq, stride, pad), ax, sw, bias, dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` where one is set.
    ``int8`` is None for a conv that never quantizes; on a feature
    pyramid's convs it is the default of ``int8_pyramid_enabled`` (True
    under ``model.dtype: "int8"``), and the conv then computes
    ``quantized_conv2d`` where that says so."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 int8: bool | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8 is not None and int8_pyramid_enabled(self.int8):
            return quantized_conv2d(x, self.weight, self.bias, self.stride[0],
                                    self.padding[0],
                                    x.dtype if dt is None else dt)
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
           dtype: torch.dtype | None = None,
           int8: bool | None = None) -> Conv2d:
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=((kernel_size - 1) * dilation) // 2,
                  dilation=dilation, compute_dtype=dtype, int8=int8)


def conv_transpose2d(in_channels: int, out_channels: int,
                     dtype: torch.dtype | None = None) -> ConvTranspose2d:
    return ConvTranspose2d(in_channels, out_channels, kernel_size=4,
                           stride=2, padding=1, compute_dtype=dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = LEAKY_ALPHA
               ) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def conv_block(in_channels: int, out_channels: int, kernel_size: int = 3,
               stride: int = 1, dilation: int = 1, relu: bool = True,
               dtype: torch.dtype | None = None,
               int8: bool | None = None) -> nn.Sequential:
    """The PWC-Lite family's ``conv``: ``Sequential(Conv2d, LeakyReLU)``, or
    the conv alone without ``relu``, so that its weight sits under
    ``.0``, as in the reference's checkpoints."""
    layers = [conv2d(in_channels, out_channels, kernel_size, stride, dilation,
                     dtype=dtype, int8=int8)]
    if relu:
        layers.append(nn.LeakyReLU(LEAKY_ALPHA))
    return nn.Sequential(*layers)


@torch.no_grad()
def init_kaiming_normal(module: nn.Module, generator: torch.Generator) -> None:
    """The PWC-Lite family's init, as the JAX layers draw it: every conv's
    weight normal with variance 2 / fan_in
    (``arflow_tpu/models/layers.py:kaiming_normal``), every transposed
    conv's xavier-uniform (``ConvTranspose2dTorch``'s default), zero
    biases; in module order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            nn.init.xavier_uniform_(m.weight, generator=generator)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


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
