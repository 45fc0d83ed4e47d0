"""Variational-EM fit of the Gaussian-mixture penalties (port of
``arflow_tpu/tools/penalty_em.py``).

A K-component zero-mean scale mixture (Dirichlet prior on the weights,
Gamma prior on the precisions) is fitted to data or smoothness residuals
sampled with ground-truth flow; its ``(pi, beta)`` are the ``gmm``
penalties' ``penalty_{smooth,census}_{pi,beta}``
(``configs/chairs_uflow_elbo_gmm.json``). The EM update runs in float64 on
the residuals' device; the residuals come from the port's loss blocks
(``data_loss_no_penalty`` / ``smooth_loss_no_penalty``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device

F64 = torch.float64


@dataclass
class EMState:
    pi: torch.Tensor
    mu: torch.Tensor
    beta: torch.Tensor
    alpha_bar: torch.Tensor


class EM:
    """Variational EM for a K-component 1-D Gaussian mixture, its state in
    float64 on ``device`` (``"cuda"`` unless asked otherwise)."""

    def __init__(self, k: int = 10, init_vars=None, alpha=1.0, mu_0=0.0,
                 beta_0=1e-3, a=1.0, b=1.0, device="cuda"):
        if init_vars is None:
            init_vars = [0.01, 0.05, 0.1, 0.25, 0.5, 1, 5, 10, 100, 1000]
        self.device = resolve_device(device)
        self.k = k
        self.alpha = torch.ones(k, dtype=F64, device=self.device) * alpha
        self.mu_0, self.beta_0, self.a, self.b = mu_0, beta_0, a, b
        self.state = EMState(
            pi=torch.ones(k, dtype=F64, device=self.device) / k,
            mu=torch.zeros(k, dtype=F64, device=self.device),
            beta=1.0 / torch.as_tensor(init_vars, dtype=F64, device=self.device),
            alpha_bar=torch.ones(k, dtype=F64, device=self.device) * alpha,
        )

    def _update(self, state: EMState, x0, x1):
        pi, mu, beta, alpha_bar = state.pi, state.mu, state.beta, state.alpha_bar
        # E-step: the responsibilities xi.
        log_pi = torch.special.digamma(alpha_bar) - torch.special.digamma(
            alpha_bar.sum())
        arg = -beta[None, :] * (x0[:, None] - mu[None, :]) ** 2 / 2 + log_pi[None, :]
        num = beta.sqrt()[None, :] * torch.exp(arg - arg.amax(dim=1, keepdim=True))
        xi = num / num.sum(dim=1, keepdim=True)

        # M-step: pi through the Dirichlet posterior.
        alpha_bar = self.alpha + (x1[:, None] * xi).sum(dim=0)
        pi = alpha_bar / alpha_bar.sum()

        # M-step: the MAP beta (mu stays at 0, as the reference's loop
        # never updates it).
        num_b = 2 * self.a - 1 + (xi * x1[:, None]).sum(dim=0)
        den_b = (2 * self.b + self.beta_0 * (mu - self.mu_0) ** 2
                 + (xi * x1[:, None] * (x0[:, None] - mu[None, :]) ** 2).sum(dim=0))
        beta = num_b / den_b

        # The ELBO objective.
        sum_i = (xi * x1[:, None]
                 * (beta.log()[None, :] - math.log(2 * math.pi)
                    - beta[None, :] * (x0[:, None] - mu[None, :]) ** 2) / 2
                 - x1[:, None] * torch.special.xlogy(xi, xi)).sum(dim=0)
        sum_j = ((self.a - 0.5) * beta.log()
                 - self.beta_0 * beta * (mu - self.mu_0) ** 2 / 2
                 - self.b * beta + sum_i).sum()
        log_integral = (torch.special.gammaln(alpha_bar).sum()
                        - torch.special.gammaln(alpha_bar.sum()))
        return EMState(pi, mu, beta, alpha_bar), sum_j + log_integral

    def update(self, x0, x1=None) -> float:
        """One EM update on the samples ``x0`` with multiplicities ``x1``
        (ones if None); returns the objective."""
        x0 = torch.as_tensor(x0, dtype=F64, device=self.device)
        x1 = (torch.ones_like(x0) if x1 is None
              else torch.as_tensor(x1, dtype=F64, device=self.device))
        self.state, objective = self._update(self.state, x0, x1)
        return float(objective)

    def fit(self, x0, x1=None, n_iter: int = 30) -> list:
        x0 = torch.as_tensor(x0, dtype=F64, device=self.device)
        return [self.update(x0, x1) for _ in range(n_iter)]


def gaussian_mixture(x, pi, mu, beta):
    """The mixture's density at ``x`` (numpy)."""
    x = np.asarray(x)
    pi, mu, beta = np.asarray(pi), np.asarray(mu), np.asarray(beta)
    arg = -beta[None, :] * (x[:, None] - mu[None, :]) ** 2
    w = pi * np.sqrt(beta) / np.sqrt(2 * np.pi)
    return np.sum(w[None, :] * np.exp(arg / 2), axis=1)


def fwhm_scale(pi, mu, beta, reference_fwhm: float):
    """The factor a for which the mixture with precisions a*beta has the
    reference's full width at half maximum (bisection on [1e-6, 100])."""
    from scipy.optimize import root_scalar

    def func(a):
        return float(
            gaussian_mixture(np.array([reference_fwhm / 2]), pi, mu, a * beta)[0]
            - gaussian_mixture(np.array([0.0]), pi, mu, a * beta)[0] / 2)

    return root_scalar(func, method="bisect", bracket=[1e-6, 100]).root


def robust_l1_fwhm(eps: float = 0.001) -> float:
    return 2 * np.sqrt((eps + np.log(2)) ** 2 - eps**2)


def abs_robust_loss_fwhm(eps: float = 0.01, q: float = 0.4) -> float:
    return 2 * (np.power(eps**q + np.log(2), 1 / q) - eps)


def collect_residuals(loader, loss_cfg, penalty: str = "smooth",
                      subsample: float = 0.95, n_samples: float = 3e6,
                      seed: int = 0, with_bk: bool = True, device="cuda"):
    """Per-pixel residuals sampled with ground-truth flow, as a 1-D numpy
    array: photometric (census) residuals for ``penalty='data'``, flow
    differences for ``'smooth'``, at 1/4 resolution, both directions with
    ``with_bk``. Each map keeps the pixels whose normalized weight exceeds
    1e-6 and whose draw from ``RandomState(seed)`` exceeds ``subsample``,
    drawn in the JAX package's order; batches are read until more than
    ``n_samples`` are kept. The loader's samples need ``target.flow`` and
    ``target.flow_bw`` (e.g. ``Chairs2``)."""
    from arflow_tpu_torch.losses.blocks import (
        data_loss_no_penalty,
        smooth_loss_no_penalty,
    )
    from arflow_tpu_torch.ops import downsample

    dev = resolve_device(device)

    def quarter(flow):
        x = torch.as_tensor(flow[..., :2], dtype=torch.float32, device=dev)
        x = downsample(x.permute(0, 3, 1, 2).contiguous(), is_flow=True,
                       scale_factor=4)
        return x.permute(0, 2, 3, 1).contiguous()

    def host(t):
        return t.detach().cpu().numpy()

    rng = np.random.RandomState(seed)
    out, total = [], 0
    with torch.no_grad():
        for data in loader:
            if total > n_samples:
                break
            im1, im2 = (torch.as_tensor(data[k], dtype=torch.float32, device=dev)
                        for k in ("img1", "img2"))
            f12_2 = quarter(data["target"]["flow"])
            f21_2 = quarter(data["target"]["flow_bw"])
            losses, weights = [], []
            if penalty == "data":
                directions = [(im1, im2, f12_2, f21_2)]
                if with_bk:
                    directions.append((im2, im1, f21_2, f12_2))
                for a, b, fa, fb in directions:
                    pl, pw, _, _ = data_loss_no_penalty(a, b, fa, fb, "none",
                                                        loss_cfg.data_loss)
                    losses.append(host(pl[0]))
                    weights.append(host(pw[0]))
            else:
                directions = [(im1, f12_2)] + ([(im2, f21_2)] if with_bk else [])
                for img, flow in directions:
                    sx, wx, sy, wy = smooth_loss_no_penalty(
                        img, flow, loss_cfg.edge_constant, loss_cfg.edge_asymp)
                    sx, wx, sy, wy = (host(t) for t in (sx, wx, sy, wy))
                    losses += [sx[:, :, :-1, :], sy[:, :-1, :, :]]
                    weights += [np.repeat(wx[:, :, :-1, :], 2, axis=-1),
                                np.repeat(wy[:, :-1, :, :], 2, axis=-1)]
            for loss_map, weight_map in zip(losses, weights):
                w = weight_map / max(weight_map.max(), 1e-12)
                mask = (w > 1e-6) & (rng.rand(*w.shape) > subsample)
                vals = np.broadcast_to(loss_map, mask.shape)[mask]
                out.append(vals.ravel())
                total += vals.size
    return np.concatenate(out) if out else np.zeros(0)
