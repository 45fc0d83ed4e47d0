"""Local-correlation cost volume: the CUDA kernels, their plain versions
and the two ``torch.library`` ops that dispatch between them.

The forward kernel (``arflow_tpu_torch/csrc/cost_volume.cu``) replaces the
TPU kernels ``arflow_tpu/ops/pallas/cost_volume_pallas.py:_fwd_kernel_v2``
and ``_fwd_kernel``; the backward kernel (``csrc/cost_volume_bwd.cu``)
replaces their custom VJP, ``_grad_shifted``, and computes both gradients
as one gather (``grad_f2`` with ``g`` mirrored and shifted). Each source
says what bounds it and how its design meets that. Layout is NCHW: f1, f2
``(B,C,H,W)`` give ``(B,(2md+1)**2,H,W)`` with dy-major displacement
channels.

``arflow::cost_volume(f1, f2, max_displacement)`` and its backward
``arflow::cost_volume_bwd`` are registered with ``torch.library``: the CUDA
implementation of each launches its kernel, the CPU implementation is its
plain version, and any other device raises; there is no fallback between
them. Being ops, they are one dispatch path for eager runs, CUDA-graph
capture and ``torch.export``, whose programs keep the op (and so the
kernel) in their graph. Importing this module registers them; it imports
nothing of the models, so a loader of exported programs can import it
alone.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from arflow_tpu_torch.ops.cuda.build import Kernel, load

COST_VOLUME = Kernel(
    name="cost_volume",
    source="arflow_tpu_torch/csrc/cost_volume.cu",
    replaces="arflow_tpu/ops/pallas/cost_volume_pallas.py:201 _fwd_kernel_v2 "
             "(pallas_call :267); :67 _fwd_kernel (pallas_call :96)",
)
COST_VOLUME_BWD = Kernel(
    name="cost_volume_bwd",
    source="arflow_tpu_torch/csrc/cost_volume_bwd.cu",
    replaces="arflow_tpu/ops/pallas/cost_volume_pallas.py:141 _grad_shifted "
             "(the custom VJP of cost_volume_pallas_v2 :226/:300 and of "
             "cost_volume_pallas :174/:188)",
)

_MAX_DISPLACEMENT = 4  # the kernel's template instances: md in 1..4


def compute_cost_volume_reference(f1: torch.Tensor, f2: torch.Tensor,
                                  max_displacement: int = 4) -> torch.Tensor:
    """Plain version: (2md+1)**2 shifted products, each averaged over C."""
    md = max_displacement
    if md <= 0:
        raise ValueError(f"Max displacement of {md} is too small.")
    h, w = f1.shape[-2], f1.shape[-1]
    f2p = F.pad(f2, (md, md, md, md))
    n = 2 * md + 1
    return torch.stack(
        [(f1 * f2p[:, :, i:i + h, j:j + w]).mean(dim=1)
         for i in range(n) for j in range(n)],
        dim=1,
    )


def cost_volume_grad_reference(g: torch.Tensor, f1: torch.Tensor,
                               f2: torch.Tensor, max_displacement: int):
    """Adjoint of the cost volume by shifted products (``_grad_shifted``):

    grad_f1[c, y, x] = sum_k g[k, y, x] * f2[c, y+dy_k, x+dx_k] / C
    grad_f2[c, y, x] = sum_k g[k, y-dy_k, x-dx_k] * f1[c, y-dy_k, x-dx_k] / C
    """
    md = max_displacement
    c, h, w = f1.shape[-3], f1.shape[-2], f1.shape[-1]
    n = 2 * md + 1
    f2p = F.pad(f2, (md, md, md, md))
    grad_f1 = torch.zeros_like(f1)
    grad_f2p = torch.zeros_like(f2p)
    for i in range(n):
        for j in range(n):
            gk = g[:, i * n + j:i * n + j + 1]
            grad_f1 = grad_f1 + gk * f2p[:, :, i:i + h, j:j + w] / c
            grad_f2p[:, :, i:i + h, j:j + w] += gk * f1 / c
    return grad_f1, grad_f2p[:, :, md:md + h, md:md + w]


def _lib():
    lib = load("cost_volume")
    fn = lib.arflow_cost_volume_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks = lib.arflow_cost_volume_blocks
        blocks.argtypes = [ctypes.c_int] * 4
        blocks.restype = ctypes.c_longlong
    return lib


def _bwd_lib():
    lib = load("cost_volume_bwd")
    fn = lib.arflow_cost_volume_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks = lib.arflow_cost_volume_bwd_blocks
        blocks.argtypes = [ctypes.c_int] * 6
        blocks.restype = ctypes.c_longlong
    return lib


def cost_volume_blocks(shape, max_displacement: int = 4) -> int:
    """Grid size (blocks) of the forward kernel's launch for f1 of ``shape``
    (B,C,H,W) on the current CUDA device."""
    b, _, h, w = shape
    n = _lib().arflow_cost_volume_blocks(b, h, w, max_displacement)
    if n < 0:
        raise ValueError(f"cost_volume kernel refuses shape {tuple(shape)}, "
                         f"md={max_displacement}")
    return n


def cost_volume_grad_blocks(shape, max_displacement: int = 4,
                            grads: int = 2) -> int:
    """Grid size (blocks) of the backward kernel's launch for f1 of
    ``shape`` (B,C,H,W) and ``grads`` gradients on the current CUDA
    device."""
    b, c, h, w = shape
    n = _bwd_lib().arflow_cost_volume_bwd_blocks(b, c, h, w, max_displacement,
                                                 grads)
    if n < 0:
        raise ValueError(f"cost_volume_bwd kernel refuses shape {tuple(shape)}, "
                         f"md={max_displacement}")
    return n


def _check(name: str, f1: torch.Tensor, f2: torch.Tensor, md: int) -> None:
    """What both kernels take: f1, f2 equal float32 contiguous (B,C,H,W) on
    one CUDA device, 1 <= md <= 4, sizes within their grids."""
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(
            f"{name} kernel needs f1, f2 on one CUDA device, got "
            f"{f1.device} and {f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(
            f"{name} kernel takes float32, got {f1.dtype}/{f2.dtype} "
            "(bf16 comes with the model.dtype roadmap item)")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"{name} kernel needs equal (B,C,H,W) shapes, got "
            f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous NCHW inputs")
    if not 1 <= md <= _MAX_DISPLACEMENT:
        raise ValueError(f"{name} kernel takes 1 <= md <= 4, got {md}")
    b, c, h, w = f1.shape
    if max(b, c, h * w) >= 2**31 or b >= 32768:
        raise ValueError(f"{name} kernel: shape {tuple(f1.shape)} too large")


def cost_volume_kernel(f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """Launch the forward kernel on the current stream (no synchronization)."""
    md = max_displacement
    _check("cost_volume", f1, f2, md)
    b, c, h, w = f1.shape
    out = torch.empty((b, (2 * md + 1) ** 2, h, w), device=f1.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = _lib().arflow_cost_volume_fwd
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    with torch.cuda.device(f1.device):
        rc = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, md,
                stream)
    if rc != 0:
        raise RuntimeError(f"cost_volume kernel launch failed: CUDA error {rc}")
    COST_VOLUME.launches += 1
    return out


def cost_volume_grad_kernel(g: torch.Tensor, f1: torch.Tensor,
                            f2: torch.Tensor, max_displacement: int = 4,
                            need_f1: bool = True, need_f2: bool = True):
    """Launch the backward kernel on the current stream (no
    synchronization): ``(grad_f1, grad_f2)`` of the cost volume for its
    output gradient ``g``, None for a gradient not asked for."""
    md = max_displacement
    _check("cost_volume_bwd", f1, f2, md)
    b, c, h, w = f1.shape
    k = (2 * md + 1) ** 2
    if (g.device != f1.device or g.dtype != torch.float32
            or tuple(g.shape) != (b, k, h, w) or not g.is_contiguous()):
        raise ValueError(
            f"cost_volume_bwd kernel needs g float32 contiguous {(b, k, h, w)} "
            f"on {f1.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    gf1 = torch.empty_like(f1) if need_f1 else None
    gf2 = torch.empty_like(f2) if need_f2 else None
    if not (need_f1 or need_f2) or f1.numel() == 0:
        return gf1, gf2
    fn = _bwd_lib().arflow_cost_volume_bwd
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    with torch.cuda.device(f1.device):
        rc = fn(g.data_ptr(), f1.data_ptr(), f2.data_ptr(),
                gf1.data_ptr() if need_f1 else None,
                gf2.data_ptr() if need_f2 else None, b, c, h, w, md, stream)
    if rc != 0:
        raise RuntimeError(
            f"cost_volume_bwd kernel launch failed: CUDA error {rc}")
    COST_VOLUME_BWD.launches += 1
    return gf1, gf2


@torch.library.custom_op("arflow::cost_volume", mutates_args=(),
                         device_types="cuda")
def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int) -> torch.Tensor:
    """The cost volume of f1, f2 (B,C,H,W): the forward kernel on a CUDA
    tensor, ``compute_cost_volume_reference`` on a CPU tensor."""
    return cost_volume_kernel(f1, f2, max_displacement)


@cost_volume.register_kernel("cpu")
def _cost_volume_cpu(f1, f2, max_displacement):
    return compute_cost_volume_reference(f1, f2, max_displacement)


@cost_volume.register_fake
def _cost_volume_fake(f1, f2, max_displacement):
    b, _, h, w = f1.shape
    return f1.new_empty((b, (2 * max_displacement + 1) ** 2, h, w))


@torch.library.custom_op("arflow::cost_volume_bwd", mutates_args=(),
                         device_types="cuda")
def cost_volume_bwd(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int, need_f1: bool, need_f2: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(grad_f1, grad_f2)`` of the cost volume for its output gradient
    ``g``: the backward kernel on CUDA tensors, which computes only the
    gradients asked for, ``cost_volume_grad_reference`` on CPU tensors. A
    gradient not asked for comes back empty, shape (0,)."""
    gf1, gf2 = cost_volume_grad_kernel(g, f1, f2, max_displacement, need_f1,
                                       need_f2)
    return _or_empty(gf1, f1), _or_empty(gf2, f2)


def _or_empty(grad, like):
    return like.new_empty(0) if grad is None else grad


@cost_volume_bwd.register_kernel("cpu")
def _cost_volume_bwd_cpu(g, f1, f2, max_displacement, need_f1, need_f2):
    gf1, gf2 = cost_volume_grad_reference(g, f1, f2, max_displacement)
    # grad_f2 is a view into its padded buffer; the op's outputs are
    # contiguous tensors of their own, as the fake describes them.
    return (gf1 if need_f1 else f1.new_empty(0)), (gf2.contiguous() if need_f2
                                                   else f2.new_empty(0))


@cost_volume_bwd.register_fake
def _cost_volume_bwd_fake(g, f1, f2, max_displacement, need_f1, need_f2):
    return (f1.new_empty(f1.shape if need_f1 else (0,)),
            f2.new_empty(f2.shape if need_f2 else (0,)))


def _cost_volume_setup_context(ctx, inputs, output):
    f1, f2, max_displacement = inputs
    ctx.save_for_backward(f1, f2)
    ctx.max_displacement = max_displacement


def _cost_volume_backward(ctx, g):
    need_f1, need_f2 = ctx.needs_input_grad[:2]
    if not (need_f1 or need_f2):
        return None, None, None
    f1, f2 = ctx.saved_tensors
    gf1, gf2 = torch.ops.arflow.cost_volume_bwd(
        g.contiguous(), f1, f2, ctx.max_displacement, need_f1, need_f2)
    return (gf1 if need_f1 else None), (gf2 if need_f2 else None), None


cost_volume.register_autograd(_cost_volume_backward,
                              setup_context=_cost_volume_setup_context)
