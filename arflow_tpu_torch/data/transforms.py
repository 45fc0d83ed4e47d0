"""Host-side augmentation in numpy on stacked frame arrays (the port's own
copy of ``arflow_tpu/data/transforms.py``).

Geometric transforms act on the stacked (N, H, W, 3) frames, so that every
frame gets the same parameters. Photometric transforms are torchvision's
ColorJitter-style brightness, contrast, saturation and hue jitter, plus
RandomGamma and RandomSwapChannels. Each transform draws from the
``RandomState`` it is given, in the JAX package's order, so the same seed
gives the same augmentation bit for bit.
"""

from __future__ import annotations

import numbers

import numpy as np

from arflow_tpu_torch.ops.resize import resize_bilinear_np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


# -- geometric ---------------------------------------------------------------

class RandomCrop:
    def __init__(self, size, rng=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = tuple(size)
        self.rng = rng or np.random

    def __call__(self, inputs):
        h, w = inputs.shape[-3:-1]
        th, tw = self.size
        if (h, w) == (th, tw):
            return inputs
        x1 = self.rng.randint(0, w - tw + 1)
        y1 = self.rng.randint(0, h - th + 1)
        return inputs[..., y1 : y1 + th, x1 : x1 + tw, :]


class RandomHorizontalFlip:
    def __init__(self, rng=None):
        self.rng = rng or np.random

    def __call__(self, inputs):
        if self.rng.rand() < 0.5:
            return inputs[..., :, ::-1, :].copy()
        return inputs


class Scale:
    """Deterministic bilinear scaling, align_corners=False
    (``ops.resize.resize_bilinear_np``). Takes (..., H, W, C) arrays."""

    def __init__(self, size):
        self.size = tuple(size)

    def __call__(self, inputs):
        return resize_bilinear_np(inputs, self.size)


def get_geometric_transforms(cfg, rng=None):
    transforms = []
    if cfg.get("crop"):
        transforms.append(RandomCrop(cfg.crop_size, rng))
    if cfg.get("hflip"):
        transforms.append(RandomHorizontalFlip(rng))
    if cfg.get("scale"):
        transforms.append(Scale(cfg.scale_size))
    return Compose(transforms)


# -- photometric -------------------------------------------------------------

def _rgb_to_hsv(rgb):
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    deltac = maxc - minc
    s = np.where(maxc > 0, deltac / np.maximum(maxc, 1e-12), 0.0)
    deltac_safe = np.where(deltac == 0, 1.0, deltac)
    rc = (maxc - rgb[..., 0]) / deltac_safe
    gc = (maxc - rgb[..., 1]) / deltac_safe
    bc = (maxc - rgb[..., 2]) / deltac_safe
    h = np.where(
        rgb[..., 0] == maxc,
        bc - gc,
        np.where(rgb[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc),
    )
    h = np.where(deltac == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
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


def _grayscale(img):
    return (
        0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]


class ColorJitter:
    """torchvision-style brightness/contrast/saturation/hue jitter."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        ops = []
        # Each factor is bound as a default argument: a bare closure over
        # the reused name would make every op apply the last factor.
        if self.brightness > 0:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda x, f=f: np.clip(x * f, 0, 1))
        if self.contrast > 0:
            f = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(
                lambda x, f=f: np.clip(
                    _grayscale(x).mean(axis=(-3, -2, -1), keepdims=True)
                    * (1 - f)
                    + x * f,
                    0,
                    1,
                )
            )
        if self.saturation > 0:
            f = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(
                lambda x, f=f: np.clip(_grayscale(x) * (1 - f) + x * f, 0, 1)
            )
        if self.hue > 0:
            d = self.rng.uniform(-self.hue, self.hue)

            def shift_hue(x, d=d):
                hsv = _rgb_to_hsv(x)
                hsv[..., 0] = (hsv[..., 0] + d) % 1.0
                return _hsv_to_rgb(hsv)

            ops.append(shift_hue)
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return np.asarray(img, np.float32)  # no copy when already f32


class RandomGamma:
    def __init__(self, min_gamma=0.7, max_gamma=1.5, clip_image=True, rng=None):
        self.min_gamma = min_gamma
        self.max_gamma = max_gamma
        self.clip_image = clip_image
        self.rng = rng or np.random

    def __call__(self, image):
        gamma = self.rng.uniform(self.min_gamma, self.max_gamma)
        out = np.power(np.maximum(image, 0), gamma)
        if self.clip_image:
            out = np.clip(out, 0.0, 1.0)
        return out.astype(np.float32)


class RandomSwapChannels:
    def __init__(self, rng=None):
        self.rng = rng or np.random

    def __call__(self, image):
        ind = self.rng.permutation(image.shape[-1])
        # Written channel by channel into an HWC-contiguous buffer: fancy
        # indexing on the last axis would give a channel-outermost layout,
        # which makes the batch stacking a strided copy.
        out = np.empty_like(image, subok=False)
        for k, j in enumerate(ind):
            out[..., k] = image[..., j]
        return out


def get_photometric_transforms(cfg, rng=None):
    transforms = []
    brightness = cfg.get("brightness", 0)
    contrast = cfg.get("contrast", 0)
    saturation = cfg.get("saturation", 0)
    hue = cfg.get("hue", 0)
    if any(v > 0 for v in (brightness, contrast, saturation, hue)):
        transforms.append(
            ColorJitter(brightness, contrast, saturation, hue, rng)
        )
    if cfg.get("gamma", 0) and cfg.get("gamma") > 0:
        transforms.append(RandomGamma(0.7, 1.5, clip_image=True, rng=rng))
    if cfg.get("swap_channels"):
        transforms.append(RandomSwapChannels(rng))
    return Compose(transforms)
