"""Photometric augmentation on the card, inside the train step (the port of
``arflow_tpu/data/device_aug.py``).

The host then only decodes, flips and stacks: no HSV math per sample on
its threads, and no ``_ph`` copies travel to the card. Each op computes
what the host transform of ``data/transforms.py`` computes, in float32:
brightness, contrast (against each frame's grayscale mean, accumulated in
float64) and saturation, each clipped to [0, 1], and the hue through the
HSV sector table; the four
jitter ops in a per-sample random order out of the n! compositions (the
host path shuffles its op list); then gamma, then a per-sample channel
permutation. The frames of one sample share its parameters, as the host
path transforms the stacked frames together. The draws come from an
explicit ``torch.Generator`` on the images' device; the streams differ from
the host's ``RandomState``, the distributions do not.

The batch is never split into samples in Python: at each position of the
op order every sample computes the blend that brightness, contrast and
saturation share (``base * (1 - f) + x * f`` with base 0, the frame's mean
gray or the pixel's gray) and, where the config has a hue, the hue, and a
``torch.where`` keeps the op that its order puts there. The ops run on
contiguous channel planes, one transpose in and one out. Plain PyTorch
ops: the JAX package computes this in XLA, not in a Pallas kernel.

Enable with ``"device": true`` inside a train data entry's
``photometric_aug``; ``get_dataset`` then skips the host transform and
``UFlowTrainer`` applies this one in its step.
"""

from __future__ import annotations

import itertools

import torch

JITTER_OPS = ("brightness", "contrast", "saturation", "hue")


def _grayscale(x):
    return 0.2989 * x[0:1] + 0.587 * x[1:2] + 0.114 * x[2:3]


def _rgb_to_hsv(r, g, b):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / maxc.clamp(min=1e-12), 0.0)
    deltac_safe = torch.where(deltac == 0, 1.0, deltac)
    rc = (maxc - r) / deltac_safe
    gc = (maxc - g) / deltac_safe
    bc = (maxc - b) / deltac_safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac == 0, 0.0, h)
    # A divisor on the tensor's device: CUDA divides by a Python scalar as
    # a product with its reciprocal, an ulp from the CPU's division.
    return torch.remainder(h / h.new_full((), 6.0), 1.0), s, maxc


def _hsv_to_rgb(h, s, v):
    f6 = h * 6.0
    fl = torch.floor(f6)
    i = fl.long() % 6
    f = f6 - fl
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # Sector table (utils/viz.py:_hsv_to_rgb): rows r, g, b; column i.
    table = torch.stack([v, q, p, p, t, v,
                         t, v, v, q, p, p,
                         p, p, t, v, v, q]).unflatten(0, (3, 6))
    return table.gather(1, i.expand(3, 1, *i.shape))[:, 0]


def _hue(x, d):
    """Channel planes ``x`` (3, ...) with their hue rotated by ``d`` turns
    (``d`` broadcast over the pixels)."""
    h, s, v = _rgb_to_hsv(*x)
    return _hsv_to_rgb(torch.remainder(h + d, 1.0), s, v)


def make_photometric(cfg):
    """``(sample_params, apply)`` for a ``photometric_aug`` config.

    ``sample_params(generator, batch_size, device) -> params`` draws one
    parameter set per sample, float32 factors; ``apply(imgs, params) ->
    imgs_ph`` maps (B, ..., H, W, 3) images, the non-batch leading dims
    (the frame axis) sharing their sample's parameters, to float32.
    ``apply`` is differentiable in ``imgs``.
    """
    amounts = {name: float(cfg.get(name, 0) or 0) for name in JITTER_OPS}
    jitter = [name for name in JITTER_OPS if amounts[name] > 0]
    with_gamma = bool(cfg.get("gamma", 0))
    with_swap = bool(cfg.get("swap_channels", False))
    n = len(jitter)
    orders = list(itertools.permutations(range(n)))
    ranges = {name: (max(0.0, 1 - amounts[name]), 1 + amounts[name])
              for name in ("brightness", "contrast", "saturation")}
    ranges["hue"] = (-amounts["hue"], amounts["hue"])
    blend = [name for name in jitter if name != "hue"]

    def sample_params(generator, batch_size, device):
        def uniform(lo, hi, *shape):
            u = torch.rand(batch_size, *shape, generator=generator,
                           device=device)
            return lo + (hi - lo) * u

        params = {name: uniform(*ranges[name]) for name in jitter}
        if n > 1:
            params["order"] = torch.randint(len(orders), (batch_size,),
                                            generator=generator, device=device)
        if with_gamma:
            params["gamma"] = uniform(0.7, 1.5)
        if with_swap:
            params["channel_perm"] = uniform(0.0, 1.0, 3).argsort(-1)
        return params

    def apply(imgs, params):
        # Channel planes (3, B, ..., H, W): every elementwise kernel reads
        # and writes contiguous memory, where on the interleaved channels
        # each would be strided.
        x = imgs.float().movedim(-1, 0).contiguous()
        b = x.shape[1]

        def per_sample(p):  # (B,) -> broadcast over the sample's pixels
            return p.view(1, b, *(1,) * (x.ndim - 2))

        if jitter:
            factors = torch.stack([params[name].float() for name in jitter], -1)
            if n > 1:
                table = torch.tensor(orders, device=x.device)
                op_at = table[params["order"].long()]  # (B, n): op per position
            else:
                op_at = torch.zeros(b, 1, dtype=torch.long, device=x.device)
            for k in range(n):
                op = op_at[:, k]
                f = per_sample(factors.gather(1, op[:, None])[:, 0])
                op = per_sample(op)
                y = None
                if blend:
                    base = torch.zeros((), device=x.device)
                    if "contrast" in blend or "saturation" in blend:
                        gray = _grayscale(x)
                    if "contrast" in blend:
                        # each frame's mean, accumulated in float64 so that
                        # the card's and the CPU's agree
                        mean = gray.mean(dim=(0, -2, -1), keepdim=True,
                                         dtype=torch.float64).float()
                        base = torch.where(op == jitter.index("contrast"),
                                           mean, base)
                    if "saturation" in blend:
                        base = torch.where(op == jitter.index("saturation"),
                                           gray, base)
                    y = (base * (1.0 - f) + x * f).clamp(0.0, 1.0)
                if "hue" in jitter:
                    hue = _hue(x, f[0])
                    y = hue if y is None else torch.where(
                        op == jitter.index("hue"), hue, y)
                x = y
        if with_gamma:
            x = x.clamp(min=0.0).pow(per_sample(params["gamma"].float()))
            x = x.clamp(0.0, 1.0)
        if with_swap:
            perm = params["channel_perm"].long().t()  # (3, B)
            x = x.gather(0, perm.view(3, b, *(1,) * (x.ndim - 2)).expand(x.shape))
        return x.movedim(0, -1).contiguous()

    return sample_params, apply


def device_photometric_cfg(full_cfg):
    """The ``photometric_aug`` flagged ``device: true`` in the config's
    train data entries, or None."""
    for entry in (full_cfg or {}).get("data", []):
        ph = entry.get("photometric_aug")
        if entry.get("type") == "train" and ph and ph.get("device"):
            return ph
    return None
