"""Penalty functions of the ELBO loss (port of ``arflow_tpu/ops/penalties.py``).

``get_penalty`` maps a config name to an elementwise function: ``identity``,
``charbonnier``, ``abs_robust_loss`` and ``gmm``, the negative log-density of
a zero-mean scale mixture of Gaussians with the config's ``pi`` and
``beta``, evaluated at the square root of its (squared) argument. With
``derivative=True`` it gives ``identity_prime`` and ``charbonnier_prime``,
the derivatives in the (squared) argument; ``abs_robust_loss`` and ``gmm``
have none and raise, as in the JAX package. No loss of either package
calls the derivatives.
"""

from __future__ import annotations

import math

import torch


def identity(x):
    return x


def identity_prime(x):
    return torch.ones_like(x)


def charbonnier(x_sq, eps: float = 0.001):
    return torch.sqrt(x_sq + eps**2)


def charbonnier_prime(x_sq, eps: float = 0.001):
    return 1.0 / (2.0 * torch.sqrt(x_sq + eps**2))


def abs_robust_loss(diff, eps: float = 0.01, q: float = 0.4):
    return torch.pow(diff.abs() + eps, q)


def log_gmm(x, pi, beta):
    """Log-density of a zero-mean scale mixture of Gaussians; ``pi`` and
    ``beta`` hold the K weights and precisions."""
    pi = torch.as_tensor(pi, dtype=x.dtype, device=x.device)
    beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    arg = -beta * x.square()[..., None] / 2.0
    w = pi * torch.sqrt(beta) / math.sqrt(2.0 * math.pi)
    c = arg.amax(dim=-1)
    return c + torch.log(torch.sum(w * torch.exp(arg - c[..., None]), dim=-1))


def get_penalty(name: str, derivative: bool = False, pi=None, beta=None):
    """The penalty ``name``, or with ``derivative`` its derivative; ``gmm``
    needs the mixture's ``pi`` and ``beta``."""
    if name == "identity":
        return identity_prime if derivative else identity
    if name == "charbonnier":
        return charbonnier_prime if derivative else charbonnier
    if name == "abs_robust_loss":
        if derivative:
            raise NotImplementedError("derivative not implemented for abs_robust_loss")
        return abs_robust_loss
    if name == "gmm":
        if derivative:
            raise NotImplementedError("derivative not implemented for gmm penalty")
        if pi is None or beta is None:
            raise ValueError("gmm penalty requires pi and beta arrays")

        def gmm_penalty(x):
            # The argument is a squared residual; the mixture is over the
            # signed residual.
            return -log_gmm(torch.sqrt(x.clamp_min(0.0)), pi, beta)

        return gmm_penalty
    raise NotImplementedError(name)
