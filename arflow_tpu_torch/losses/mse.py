"""Supervised Gaussian-posterior MSE loss, ``type: "mse"`` (port of
``arflow_tpu/losses/mse.py``).

The network's level-2 posterior is sampled and regressed to the ground
truth resized to level 2 (``resize_flow``), with an entropy bonus and an
L2 penalty on the off-diagonal bands. Four parametrizations: ``diag`` with
a covariance (flow = mean + exp(log_diag) * eps) or a precision
(exp(-log_diag)), and the 3-band lower-triangular factor L (diagonal A,
left B, over C; D = 0) as the covariance's (mean + L eps) or the
precision's (mean + L^-T eps, ``backward_substitution``), with
``diag_dominant`` adding |B| and |C| to A. Channels of the level-2
output: mean 0:2, log-diagonal 2:4, left 4:6, over 6:8.

Tensors are NHWC, as the model returns them. The draws come from
``generator`` (n_samples x B entries, sample-major), or are injected as
``noise={"eps": ...}``. What the JAX loss passes through ``stop_gradient``
is detached here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc
from arflow_tpu_torch.ops import resize_flow
from arflow_tpu_torch.ops.triag import (
    backward_substitution,
    matrix_vector_product,
    matrix_vector_product_T,
)


def _tile(x, n):
    """(B, ...) -> (n*B, ...), sample-major."""
    return x if n == 1 else x.repeat(n, *([1] * (x.ndim - 1)))


class MseLoss:
    """cfg: w_mse, w_entropy, diag, diag_dominant, inv_cov, approx_entropy,
    n_samples, offdiag_reg, align_corners."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, res_dict, gt_flow, generator=None, noise=None) -> dict:
        """``res_dict`` (the model's outputs, or the ``flows_fw`` list) and
        the NHWC ground truth -> {'total', 'l_mse', 'entropy',
        'l_offdiag'}, scalar tensors."""
        cfg = self.cfg
        n = cfg.n_samples
        output = res_dict["flows_fw"] if isinstance(res_dict, dict) else res_dict
        out2 = output[2]
        b, h, w, _ = out2.shape

        mean = out2[..., 0:2]
        log_diag = out2[..., 2:4]
        diag = torch.exp(log_diag)
        loss_offdiag = out2.new_zeros(())
        if not cfg.diag:
            left = out2[..., 4:6][:, :, :-1]
            over = out2[..., 6:8][:, :-1]
            if cfg.get("diag_dominant", False):
                diag = (diag + F.pad(left.abs(), (0, 0, 1, 0))
                        + F.pad(over.abs(), (0, 0, 0, 0, 1, 0)))
            zero_d = out2.new_zeros((b, h - 1, w - 1, 2))
            loss_offdiag = (cfg.offdiag_reg
                            * (left.square().mean() + over.square().mean()) / 2.0)

        if noise is not None:
            eps = noise["eps"]
        else:
            if generator is None:
                raise ValueError("MseLoss needs a torch.Generator (or injected noise)")
            eps = torch.randn((n * b, h, w, 2), generator=generator,
                              device=out2.device, dtype=out2.dtype)

        mean_t, diag_t, log_diag_t = _tile(mean, n), _tile(diag, n), _tile(log_diag, n)
        if not cfg.diag:
            bands_t = (diag_t, _tile(left, n), _tile(over, n), _tile(zero_d, n))
        if cfg.diag and not cfg.inv_cov:
            flow = mean_t + torch.exp(log_diag_t) * eps
        elif cfg.diag:
            flow = mean_t + torch.exp(-log_diag_t) * eps
        elif not cfg.inv_cov:
            flow = mean_t + matrix_vector_product(*bands_t, eps)
        else:
            flow = mean_t + backward_substitution(*bands_t, eps)

        w_ent = cfg.w_entropy
        if cfg.inv_cov and not cfg.diag and cfg.get("approx_entropy", False):
            tmp = matrix_vector_product_T(*(t.detach() for t in bands_t),
                                          flow - mean_t.detach())
            loss_entropy = w_ent * (tmp * tmp / 2).sum(dim=-1).mean()
        elif cfg.inv_cov:
            loss_entropy = -w_ent * log_diag.sum(dim=-1).mean()
        else:
            loss_entropy = w_ent * log_diag.sum(dim=-1).mean()

        gt2 = to_nhwc(resize_flow(to_nchw(gt_flow[..., 0:2]), (h, w),
                                  align_corners=cfg.get("align_corners", False)))
        loss_mse = cfg.w_mse * (flow - _tile(gt2, n)).square().mean()
        return {"total": loss_mse - loss_entropy + loss_offdiag,
                "l_mse": loss_mse, "entropy": loss_entropy,
                "l_offdiag": loss_offdiag}
