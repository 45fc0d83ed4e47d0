"""Flow visualization in numpy on the host (the port's own copy of
``arflow_tpu/utils/viz.py``): the HSV wheel and the simple RGB mapping
of the reference's utils/flow_utils.py:67-107. ``_hsv_to_rgb`` is also
the hue op's sector table in ``data/transforms.py``.
"""

from __future__ import annotations

import numpy as np


def flow_to_image(flow: np.ndarray, max_flow: float | None = 256) -> np.ndarray:
    """(H, W, 2) flow -> uint8 RGB via HSV wheel (flow_utils.py:67-82)."""
    if max_flow is not None:
        max_flow = max(max_flow, 1.0)
    else:
        max_flow = float(np.max(flow))

    n = 8
    u, v = flow[:, :, 0], flow[:, :, 1]
    mag = np.sqrt(np.square(u) + np.square(v))
    angle = np.arctan2(v, u)
    im_h = np.mod(angle / (2 * np.pi) + 1, 1)
    im_s = np.clip(mag * n / max_flow, 0, 1)
    im_v = np.clip(n - im_s, 0, 1)
    hsv = np.stack([im_h, im_s, im_v], 2)
    return (_hsv_to_rgb(hsv) * 255).astype(np.uint8)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    out = np.zeros(hsv.shape, hsv.dtype)
    conds = [i == k for k in range(6)]
    rs = [v, q, p, p, t, v]
    gs = [t, v, v, q, p, p]
    bs = [p, p, t, v, v, q]
    for c, r_, g_, b_ in zip(conds, rs, gs, bs):
        out[..., 0] = np.where(c, r_, out[..., 0])
        out[..., 1] = np.where(c, g_, out[..., 1])
        out[..., 2] = np.where(c, b_, out[..., 2])
    return out


def np_flow2rgb(flow_map: np.ndarray, max_value: float | None = None) -> np.ndarray:
    """(2, H, W) or (H, W, 2) flow -> [0,1] RGB (flow_utils.py:85-99)."""
    if flow_map.ndim == 3 and flow_map.shape[-1] == 2:
        flow_map = np.transpose(flow_map, (2, 0, 1))
    _, h, w = flow_map.shape
    rgb = np.ones((h, w, 3), np.float32)
    divisor = max_value if max_value is not None else np.abs(flow_map).max()
    normalized = flow_map / (divisor + 1e-12)
    rgb[:, :, 0] += normalized[0]
    rgb[:, :, 1] -= 0.5 * (normalized[0] + normalized[1])
    rgb[:, :, 2] += normalized[1]
    return rgb.clip(0, 1)


def batch_flow2rgb(flows: np.ndarray) -> np.ndarray:
    """(B, H, W, 2) -> (B, H, W, 3) [0,1] RGB."""
    return np.stack([np_flow2rgb(f) for f in np.asarray(flows)])
