"""Optical-flow file IO: Middlebury .flo and KITTI 16-bit PNG (the port's
own copy of ``arflow_tpu/utils/flow_io.py``).

``.flo`` is read and written with numpy. The KITTI PNG functions import
cv2 inside the call; KITTI is not on the main path, and nothing else here
needs cv2. ``load_flow`` reads both through the native library
(``arflow_tpu_torch.native``) where it is built.
"""

from __future__ import annotations

import numpy as np

from arflow_tpu_torch import native

TAG_FLOAT = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if magic != TAG_FLOAT:
            raise ValueError(f"Invalid .flo magic in {path}: {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo."""
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array(w, np.int32).tofile(f)
        np.array(h, np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_kitti_png(path: str) -> np.ndarray:
    """Read KITTI 16-bit PNG flow -> (H, W, 3): u, v, valid-mask.

    (value - 2**15) / 64, masked; values with |f| < 1e-10 are clamped to
    1e-10 before masking.
    """
    import cv2

    raw = cv2.imread(path, -1)
    if raw is None:
        raise FileNotFoundError(path)
    raw = raw.astype(np.float32)
    flow = raw[:, :, 2:0:-1]  # BGR -> (u, v)
    mask = raw[:, :, [0]]
    flow = (flow - 32768.0) / 64.0
    flow[np.abs(flow) < 1e-10] = 1e-10
    flow = flow * mask
    return np.concatenate([flow, mask], axis=-1)


def write_kitti_png(path: str, flow: np.ndarray, mask: np.ndarray | None = None):
    """Write (H, W, 2) flow (+ optional validity mask) as KITTI 16-bit PNG."""
    import cv2

    h, w = flow.shape[:2]
    if mask is None:
        mask = np.ones((h, w), np.uint16)
    out = np.zeros((h, w, 3), np.uint16)
    quant = np.clip(flow * 64.0 + 32768.0, 0, 65535).astype(np.uint16)
    out[:, :, 2] = quant[:, :, 0]
    out[:, :, 1] = quant[:, :, 1]
    out[:, :, 0] = mask.astype(np.uint16)
    cv2.imwrite(path, out)


def load_flow(path) -> np.ndarray:
    """A KITTI ``.png`` or a ``.flo``, by extension: through the native
    readers where they are built, else numpy/cv2."""
    if native.available():
        try:
            if str(path).endswith(".png"):
                return native.read_kitti_png(str(path))
            return native.read_flo(str(path))
        except OSError:  # a file the native decoder refuses
            pass
    if str(path).endswith(".png"):
        return read_kitti_png(str(path))
    return read_flo(str(path))
