"""Bilinear image and flow resizing (port of ``arflow_tpu/ops/resize.py``).

The JAX package writes each resize as two interpolation-matrix products with
torch ``F.interpolate`` weights; here the bilinear one is ``F.interpolate``
itself. NCHW. ``_resize_matrix`` keeps those weights as numpy for the host
side, and ``resize_bilinear_np`` applies them there (the data transforms'
``Scale`` and the resize of output flows in ``inference_main``).
``resize_area`` (the ARFlow losses' image pyramids) is the two matrix
products of the JAX package, so that its weights are rounded to float32
as the JAX ones are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, mode: str = "bilinear"
                   ) -> np.ndarray:
    """(out_size, in_size) weight matrix, float32, of torch's
    ``F.interpolate``: ``"bilinear"`` with ``align_corners=False``
    (half-pixel source coordinates, clamped at 0), or ``"area"``
    (``adaptive_avg_pool``'s integer cell bounds, each cell's mean)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "area":
        for i in range(out_size):
            start = (i * in_size) // out_size
            end = -((-(i + 1) * in_size) // out_size)  # ceil
            m[i, start:end] = 1.0 / (end - start)
        return m.astype(np.float32)
    if mode != "bilinear":
        raise NotImplementedError(mode)
    src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.maximum(src, 0.0)
    x0 = np.floor(src).astype(np.int64)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w1 = src - x0
    np.add.at(m, (np.arange(out_size), x0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), x1), w1)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix_taps(in_size: int, out_size: int):
    """(i0, w0, i1, w1) per output row of ``_resize_matrix``.

    A bilinear row has at most 2 nonzeros, so the row-dot over the whole
    source axis collapses to a 2-tap gather. The taps are ordered
    i0 <= i1, the dense product's accumulation order, so the result equals
    the matrix product bit for bit (the skipped terms are exact +0.0
    adds).
    """
    m = _resize_matrix(in_size, out_size)
    idx = np.argsort(m, axis=1)[:, -2:]
    i0 = idx.min(axis=1)
    i1 = idx.max(axis=1)
    rows = np.arange(m.shape[0])
    return i0, m[rows, i0], i1, m[rows, i1]


def resize_bilinear_np(inputs: np.ndarray, out_hw) -> np.ndarray:
    """(..., H, W, C) -> (..., out_h, out_w, C) in numpy, bilinear with
    align_corners=False, as two 2-tap gather passes (``_matrix_taps``).
    One numpy path that needs neither cv2 nor a device."""
    h, w = inputs.shape[-3:-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return inputs
    dt = inputs.dtype
    i0, w0, i1, w1 = _matrix_taps(h, oh)
    out = (
        inputs[..., i0, :, :] * w0[:, None, None]
        + inputs[..., i1, :, :] * w1[:, None, None]
    )
    j0, v0, j1, v1 = _matrix_taps(w, ow)
    out = out[..., j0, :] * v0[:, None] + out[..., j1, :] * v1[:, None]
    return out.astype(dt)


def resize_bilinear(img: torch.Tensor, out_hw, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear; align_corners=False is the UFlow pyramid convention."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(img.shape[-2:]):
        return img
    return F.interpolate(img, size=(oh, ow), mode="bilinear",
                         align_corners=align_corners)


def resize_area(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Area resize of an NCHW image to ``out_hw``, as torch's
    ``mode="area"`` cells it, with the float32 weights of
    ``_resize_matrix`` in the image's dtype."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = img.shape[-2:]
    if (oh, ow) == (h, w):
        return img
    mh, mw = (torch.from_numpy(_resize_matrix(i, o, "area")).to(img)
              for i, o in ((h, oh), (w, ow)))
    return torch.matmul(torch.matmul(mh, img), mw.t())


def resize_flow(flow: torch.Tensor, new_shape, align_corners: bool = False
                ) -> torch.Tensor:
    """A (B, 2, H, W) flow resized to ``new_shape``, its u scaled by the
    width's ratio and v by the height's."""
    h, w = flow.shape[-2:]
    nh, nw = int(new_shape[0]), int(new_shape[1])
    out = resize_bilinear(flow, (nh, nw), align_corners)
    scale = torch.tensor([nw / w, nh / h], dtype=flow.dtype, device=flow.device)
    return out * scale.view(1, 2, 1, 1)


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
