"""Gaussian-mixture log pdf and Monte-Carlo mixture entropy (port of
``arflow_tpu/utils/gmm.py``).

NHWC: flow samples (S*B, H, W, 2), samples-major; mixture parameters
(B, H, W, 2K) with u components at even channels and v at odd ones;
weights (B, K).
"""

from __future__ import annotations

import torch


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


def mixture_draws(weights, shape_hw, n_samples: int = 100,
                  generator: torch.Generator | None = None,
                  dtype=torch.float32) -> dict:
    """The draws ``mixture_entropy`` takes from ``generator`` (one seeded 0
    on ``weights``' device if none is given) for maps of ``shape_hw``, as
    ``{'z': (S, B), 'eps': (S, B, H, W, 2)}``: the same numbers in the same
    order, to be passed back as ``mixture_entropy(..., **draws)``."""
    if generator is None:
        generator = torch.Generator(device=weights.device).manual_seed(0)
    h, w = shape_hw
    pairs = [_draw(weights, weights.shape[0], h, w, generator, dtype,
                   weights.device) for _ in range(n_samples)]
    return {"z": torch.stack([z for z, _ in pairs]),
            "eps": torch.stack([e for _, e in pairs])}


def mixture_entropy(mean, log_std, weights, n_samples: int = 100,
                    generator: torch.Generator | None = None, z=None, eps=None):
    """Monte-Carlo per-pixel mixture entropy, (B, H, W, 1): the mean over
    ``n_samples`` draws of -log p(flow), each draw a component z per image
    (from ``weights``) and a flow mean_z + std_z * eps.

    The draws come from ``generator`` (one seeded 0 on the tensors' device
    if none is given), or are given: ``z`` (S, B) component indices and
    ``eps`` (S, B, H, W, 2) standard normals (``mixture_draws``).
    """
    std = torch.exp(log_std)
    b, h, w, _ = mean.shape
    if (z is None or eps is None) and generator is None:
        generator = torch.Generator(device=mean.device).manual_seed(0)
    ent = 0.0
    for s in range(n_samples):
        if z is not None and eps is not None:
            z_s, eps_s = z[s], eps[s]
        else:
            z_s, eps_s = _draw(weights, b, h, w, generator, mean.dtype,
                               mean.device)
        idx = torch.stack([2 * z_s, 2 * z_s + 1], dim=-1).view(b, 1, 1, 2)
        idx = idx.expand(b, h, w, 2)
        flow = mean.gather(-1, idx) + std.gather(-1, idx) * eps_s
        ent = ent - gaussian_mixture_log_pdf(flow, mean, log_std, weights,
                                             per_pixel=True)
    return ent / n_samples
