"""Per-pixel flow-uncertainty (entropy) maps per approximation (port of
``arflow_tpu/training/entropy.py``). Returns a 2-channel (u, v) log-std map
at full resolution, NHWC.

As the JAX function does: ``sparse`` with ``inv_cov`` returns
0.5 * log of the marginal variance from ``inverse_diagonal``, and
``mixture`` takes uniform weights where none are predicted.
"""

from __future__ import annotations

import math

import torch

from arflow_tpu_torch.ops import upsample
from arflow_tpu_torch.ops.triag import inverse_diagonal
from arflow_tpu_torch.utils.gmm import mixture_entropy


def _upsample4(x: torch.Tensor) -> torch.Tensor:
    """NHWC map at 1/4 resolution -> full resolution, bilinear."""
    out = upsample(x.permute(0, 3, 1, 2), is_flow=False, scale_factor=4)
    return out.permute(0, 2, 3, 1)


def extract_uv_entropy(flows, loss_cfg, res_dict=None,
                       generator: torch.Generator | None = None, draws=None):
    """flows: the model's forward outputs, full resolution first, NHWC.

    ``mixture`` draws its 100 Monte-Carlo samples from ``generator`` (one
    seeded 0 if none is given), or takes them from ``draws``, a dict with
    ``z`` and ``eps`` as ``mixture_entropy`` takes them.
    """
    approx = loss_cfg.approx
    if approx == "diag":
        return flows[0][..., 2:4]

    if approx == "mixture":
        k = loss_cfg.n_components
        mean = flows[0][..., 0:k * 2]
        # The first component's log-std is shared by all components.
        logstd = flows[0][..., k * 2:k * 2 + 2].repeat(1, 1, 1, k)
        if res_dict is not None and "weights_fw" in res_dict:
            weights = res_dict["weights_fw"]
        else:
            weights = mean.new_ones((mean.shape[0], k)) / k
        ent = mixture_entropy(mean, logstd, weights, n_samples=100,
                              generator=generator, **(draws or {}))
        return ent.repeat(1, 1, 1, 2)

    if approx == "sparse":
        if loss_cfg.get("inv_cov", False):
            log_diag = flows[2][..., 2:4]
            left = flows[2][..., 4:6][:, :, :-1]
            over = flows[2][..., 6:8][:, :-1]
            var = inverse_diagonal(torch.exp(log_diag), left, over)
            return _upsample4(0.5 * torch.log(var) + 2 * math.log(4))
        return flows[0][..., 2:4]

    if approx == "lowrank":
        std = flows[2][..., 2:2 + 2 * loss_cfg.columns]
        u_ent = torch.log((std[..., 0::2] ** 2).sum(dim=-1, keepdim=True)) / 2
        v_ent = torch.log((std[..., 1::2] ** 2).sum(dim=-1, keepdim=True)) / 2
        return _upsample4(torch.cat([u_ent, v_ent], dim=-1) + 2 * math.log(4))

    raise NotImplementedError(f"Invalid approximation {approx}!")
