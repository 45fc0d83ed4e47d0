"""Gaussian-mixture log pdf and Monte-Carlo mixture entropy (port of
``arflow_tpu/utils/gmm.py``).

NHWC: flow samples (S*B, H, W, 2), samples-major; mixture parameters
(B, H, W, 2K) with u components at even channels and v at odd ones;
weights (B, K).

The Monte-Carlo draws of ``mixture_entropy`` come from a
``torch.Generator``, are given, or are hashed (``hash_draws``): a
counter-based hash (splitmix64 of integer counters, in int64 tensor ops)
of a seed, so that a ``torch.export`` program, which cannot hold a
generator, draws at run time without storing any draw.
"""

from __future__ import annotations

import math

import torch

# splitmix64's increment and multipliers as signed int64 (two's complement
# of 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB).
_GOLDEN = -7046029254386353131
_MIX1 = -4658895280553007687
_MIX2 = -7723592293110705685
_STREAM_NORMAL, _STREAM_COMPONENT = 0, 1


def log_sum_exp(x, w=1.0, dim=0):
    x_max = x.amax(dim=dim, keepdim=True)
    return x_max + torch.log(torch.sum(w * torch.exp(x - x_max), dim=dim,
                                       keepdim=True))


def gaussian_mixture_log_pdf(flow, mean, log_std, weights,
                             per_pixel: bool = False):
    """Mixture log-density of the flow samples: (S*B, 1), the average over
    pixels, or (S*B, H, W, 1) with ``per_pixel``."""
    nsamples = flow.shape[0] // mean.shape[0]
    mean = mean.repeat(nsamples, 1, 1, 1)
    log_std = log_std.repeat(nsamples, 1, 1, 1)
    weights = weights.repeat(nsamples, 1)
    std = torch.exp(log_std)

    u_err = (flow[..., 0:1] - mean[..., 0::2]) / std[..., 0::2]  # (S*B,H,W,K)
    v_err = (flow[..., 1:2] - mean[..., 1::2]) / std[..., 1::2]
    err_sq = u_err * u_err + v_err * v_err
    log_det = log_std[..., 0::2] + log_std[..., 1::2]

    if per_pixel:
        return log_sum_exp(-log_det - err_sq / 2.0, weights[:, None, None, :],
                           dim=-1)

    err_sq = err_sq.sum(dim=(1, 2))  # (S*B, K)
    log_det = log_det.sum(dim=(1, 2))
    rows, cols = flow.shape[1], flow.shape[2]
    return log_sum_exp(-log_det - err_sq / 2.0, weights, dim=1) / (rows * cols)


def _draw(weights, b, h, w, generator, dtype, device):
    """One Monte-Carlo draw: a component per image, (B,), and standard
    normals (B, H, W, 2), in this order from ``generator``."""
    z = torch.multinomial(weights, 1, replacement=True, generator=generator)[:, 0]
    eps = torch.randn((b, h, w, 2), generator=generator, dtype=dtype,
                      device=device)
    return z, eps


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``s`` (torch's ``>>`` is
    arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function of int64 counters, in int64 tensor ops
    (the products wrap modulo 2**64, as the unsigned ones do)."""
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _counter_base(seed: int, stream: int) -> int:
    """Where the counters of ``stream`` start for ``seed``: 2**40 apart,
    more than a stream's draws need."""
    return (2 * int(seed) + stream) << 40


def _uniform24(bits: torch.Tensor, shift: int) -> torch.Tensor:
    """The 24 bits of ``bits`` from bit ``shift`` up (``shift`` <= 40), as
    float32 in [0, 1)."""
    return ((bits >> shift) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24


# Samples hashed per call of ``hash_draws`` in ``mixture_entropy``: one
# call's tensors are HASH_CHUNK x B x H x W, and a program's graph holds one
# hash per chunk, not per sample.
HASH_CHUNK = 10


def hash_draws(first: int, count: int, batch: int, shape_hw, k: int,
               device=None, seed: int = 0):
    """Samples ``first`` .. ``first + count - 1`` of the Monte-Carlo draws
    for a mixture of ``k`` equally weighted components: ``z`` (count, B)
    int64 and ``eps`` (count, B, H, W, 2) float32 standard normals, from
    splitmix64 hashes of ``seed`` and integer counters.

    z = floor(u k) of one uniform per sample and image. eps is Box-Muller in
    float32 of two 24-bit uniforms per pixel, both from one 64-bit hash: u1
    in (0, 1] from the top 24 bits, u2 in [0, 1) from the next 24, and
    (r cos 2 pi u2, r sin 2 pi u2) with r = sqrt(-2 log u1). Elementwise,
    so sample s's values do not depend on ``first`` and ``count``; their
    float32 rounding may depend on the tensor's size on some devices, so
    ``mixture_entropy`` and ``mixture_hash_draws`` both call it with the
    same chunks."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    n = batch * h * w
    pix = torch.arange(first * n, (first + count) * n, dtype=torch.int64,
                       device=device)
    bits = splitmix64(pix + _counter_base(seed, _STREAM_NORMAL))
    r = torch.sqrt(-2.0 * torch.log(1.0 - _uniform24(bits, 40)))
    theta = (2.0 * math.pi) * _uniform24(bits, 16)
    eps = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    img = torch.arange(first * batch, (first + count) * batch,
                       dtype=torch.int64, device=device)
    zbits = splitmix64(img + _counter_base(seed, _STREAM_COMPONENT))
    z = torch.floor(_uniform24(zbits, 40) * k).to(torch.int64).clamp_max(k - 1)
    return z.view(count, batch), eps.view(count, batch, h, w, 2)


def mixture_hash_draws(k: int, batch: int, shape_hw, n_samples: int = 100,
                       device=None, seed: int = 0) -> dict:
    """``hash_draws`` of every sample, in ``HASH_CHUNK``s as
    ``mixture_entropy`` makes them, as its ``z`` and ``eps``:
    ``{'z': (S, B), 'eps': (S, B, H, W, 2)}``."""
    chunks = [hash_draws(s, min(HASH_CHUNK, n_samples - s), batch, shape_hw,
                         k, device, seed)
              for s in range(0, n_samples, HASH_CHUNK)]
    return {"z": torch.cat([z for z, _ in chunks]),
            "eps": torch.cat([e for _, e in chunks])}


def mixture_entropy(mean, log_std, weights, n_samples: int = 100,
                    generator: torch.Generator | None = None, z=None, eps=None,
                    hash_seed: int | None = None):
    """Monte-Carlo per-pixel mixture entropy, (B, H, W, 1): the mean over
    ``n_samples`` draws of -log p(flow), each draw a component z per image
    (from ``weights``) and a flow mean_z + std_z * eps.

    The draws come from ``generator`` (one seeded 0 on the tensors' device
    if none is given), or are given: ``z`` (S, B) component indices and
    ``eps`` (S, B, H, W, 2) standard normals (``mixture_hash_draws``), or,
    with ``hash_seed``, are ``hash_draws`` of that seed, made per
    ``HASH_CHUNK`` samples: those take the weights as uniform.
    """
    std = torch.exp(log_std)
    b, h, w, _ = mean.shape
    mean_u, mean_v = mean[..., 0::2], mean[..., 1::2]
    std_u, std_v = std[..., 0::2], std[..., 1::2]
    neg_log_det = -(log_std[..., 0::2] + log_std[..., 1::2])
    pixel_weights = weights[:, None, None, :]
    if hash_seed is None and (z is None or eps is None) and generator is None:
        generator = torch.Generator(device=mean.device).manual_seed(0)
    ent = 0.0
    for s in range(n_samples):
        if hash_seed is not None:
            if s % HASH_CHUNK == 0:
                z_chunk, eps_chunk = hash_draws(
                    s, min(HASH_CHUNK, n_samples - s), b, (h, w),
                    weights.shape[1], mean.device, hash_seed)
            z_s, eps_s = z_chunk[s % HASH_CHUNK], eps_chunk[s % HASH_CHUNK]
            if eps_s.dtype != mean.dtype:
                eps_s = eps_s.to(mean.dtype)
        elif z is not None and eps is not None:
            z_s, eps_s = z[s], eps[s]
        else:
            z_s, eps_s = _draw(weights, b, h, w, generator, mean.dtype,
                               mean.device)
        idx = torch.stack([2 * z_s, 2 * z_s + 1], dim=-1).view(b, 1, 1, 2)
        idx = idx.expand(b, h, w, 2)
        flow = mean.gather(-1, idx) + std.gather(-1, idx) * eps_s
        # gaussian_mixture_log_pdf(per_pixel=True) with the terms that do
        # not depend on the draw taken out of the loop.
        u_err = (flow[..., 0:1] - mean_u) / std_u
        v_err = (flow[..., 1:2] - mean_v) / std_v
        err_sq = u_err * u_err + v_err * v_err
        ent = ent - log_sum_exp(neg_log_det - err_sq / 2.0, pixel_weights,
                                dim=-1)
    return ent / n_samples
