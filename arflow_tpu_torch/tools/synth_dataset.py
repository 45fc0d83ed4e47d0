"""Synthetic FlyingChairs-format dataset with known ground-truth flow
(port of ``arflow_tpu/tools/synth_dataset.py``, numpy only).

Writes pairs in FlyingChairs' on-disk layout (``NNNNN_img1.ppm`` /
``NNNNN_img2.ppm`` / ``NNNNN_flow.flo``), so that the ``Chairs`` dataset
with its fixed train/validation split (``CHAIRS_VALID_INDICES``), the PPM
decoder and the ``.flo`` reader run end to end with no dataset on disk.

Frames have natural-image statistics (1/f amplitude spectrum, correlated
RGB); the flow is a smooth low-frequency field (a global translation and a
few sinusoidal modes, of a given peak magnitude), and frame 2 is the
inverse bilinear warp of frame 1 by that field. For smooth fields the
sampling flow equals the forward ground truth to O(|f| |grad f|), about
1e-2 px at the default settings. The same seed writes the same bytes as
the JAX package's tool.

    python -m arflow_tpu_torch.tools.synth_dataset --root /tmp/synth_chairs \
        --n 64 --size 128x192 --max-flow 6
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from arflow_tpu_torch.utils.flow_io import write_flo


def _pink_noise(rng, h, w, exponent=1.2):
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** (-exponent)
    amp[0, 0] = 0.0
    spec = amp * np.exp(1j * rng.uniform(0, 2 * np.pi, size=amp.shape))
    img = np.fft.irfft2(spec, s=(h, w))
    img -= img.min()
    img /= max(img.max(), 1e-12)
    return img.astype(np.float32)


def _rgb_texture(rng, h, w):
    gray = _pink_noise(rng, h, w)
    tint = 0.15 * _pink_noise(rng, h, w, exponent=1.5)
    return np.clip(
        np.stack(
            [0.85 * gray + 0.5 * tint, 0.9 * gray + 0.2 * tint,
             0.8 * gray - 0.3 * tint + 0.1],
            axis=-1,
        ),
        0, 1,
    ).astype(np.float32)


def smooth_flow(rng, h, w, max_flow=6.0):
    """Global translation + 3 low-frequency sinusoidal modes per component,
    normalized so max |flow| <= max_flow."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    yy, xx = yy / h, xx / w
    comps = []
    for _ in range(2):
        field = rng.uniform(-1, 1) * np.ones((h, w), np.float32)
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 2.0, size=2)
            ph = rng.uniform(0, 2 * np.pi, size=2)
            field = field + rng.uniform(-1, 1) * np.sin(
                2 * np.pi * (fy * yy + ph[0])
            ) * np.sin(2 * np.pi * (fx * xx + ph[1]))
        comps.append(field)
    flow = np.stack(comps, axis=-1).astype(np.float32)
    peak = np.abs(flow).max()
    return flow * (max_flow / max(peak, 1e-6))


def _bilinear_sample(img, y, x):
    """Sample img (H,W,C) at float coords with border clamping."""
    h, w = img.shape[:2]
    y = np.clip(y, 0, h - 1)
    x = np.clip(x, 0, w - 1)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _write_ppm(path, img_u8):
    h, w = img_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img_u8.tobytes())


def generate_chairs(root, n_pairs=64, size=(128, 192), max_flow=6.0, seed=0,
                    start_fid=1):
    """Write n_pairs FlyingChairs-format samples under root; returns root.

    fids run start_fid..start_fid+n_pairs-1, so some fall in the fixed
    validation split (CHAIRS_VALID_INDICES: 6, 18, 43, 46, 59 and 63 within
    the first 64) as in the real dataset."""
    os.makedirs(root, exist_ok=True)
    h, w = size
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    for fid in range(start_fid, start_fid + n_pairs):
        img1 = _rgb_texture(rng, h, w)
        flow = smooth_flow(rng, h, w, max_flow=max_flow)
        # Inverse warp: img2(q) = img1(q - flow(q)); for smooth flow this
        # makes `flow` the forward GT img1->img2 to O(|f||grad f|).
        img2 = _bilinear_sample(img1, yy - flow[..., 1], xx - flow[..., 0])
        img2 = np.clip(
            img2 + rng.randn(h, w, 3).astype(np.float32) * 0.003, 0, 1
        )
        _write_ppm(os.path.join(root, f"{fid:05d}_img1.ppm"),
                   (img1 * 255).astype(np.uint8))
        _write_ppm(os.path.join(root, f"{fid:05d}_img2.ppm"),
                   (img2 * 255).astype(np.uint8))
        write_flo(os.path.join(root, f"{fid:05d}_flow.flo"), flow)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", default="128x192")
    ap.add_argument("--max-flow", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.size.split("x"))
    generate_chairs(args.root, args.n, (h, w), args.max_flow, args.seed)
    print(f"wrote {args.n} pairs at {h}x{w} to {args.root}")


if __name__ == "__main__":
    main()
