"""PWCLiteProb: PWC-Lite predicting a flow and its log-variance per level
(port of ``arflow_tpu/models/pwclite_prob.py``).

The 2-frame PWC-Lite with 4-channel estimator and context outputs,
``[flow (2), log_var (2)]``. The log-variance starts at 1, is carried to
the next level with a ``+2 log 2`` bias per 2x upsample (a flow's variance
grows by 4 with its scale), and is clamped at 10 after each level's
context network. With ``upsample`` every level is upsampled 4x, the
log-variance with a ``+2 log 4`` bias. Outputs per level (B,H,W,4), finest
first, float32.
"""

from __future__ import annotations

import math

import torch

from arflow_tpu_torch.models.layers import remat_region
from arflow_tpu_torch.models.pwclite import (
    OUTPUT_LEVEL,
    PWCLite,
    correlate,
    upscale,
)
from arflow_tpu_torch.ops import flow_warp

LOG_VAR_INIT = 1.0
LOG_VAR_MAX = 10.0


class PWCLiteProb(PWCLite):
    """The 2-frame PWC-Lite with a log-variance per level."""

    out_channels = 4

    def __init__(self, n_frames: int = 2, upsample: bool = True,
                 reduce_dense: bool = True, dtype: torch.dtype | None = None):
        if n_frames != 2:
            raise ValueError(f"PWCLiteProb is a 2-frame network, got "
                             f"n_frames {n_frames}")
        super().__init__(n_frames, upsample, reduce_dense, dtype)

    def _decode_level(self, level: int, x1, x2, flow, log_var):
        """One decode level (``PWCLite._decode_level``) with the
        log-variance beside the flow."""
        x2_warp = x2 if level == 0 else flow_warp(x2, flow)
        corr = correlate(x1, x2_warp)
        x1_1by1 = self.conv_1x1[level](x1)
        x_intm, out = self.flow_estimators(
            torch.cat([corr, x1_1by1, flow, log_var], dim=1))
        flow = flow + out[:, 0:2]
        log_var = log_var + out[:, 2:4]
        out = self.context_networks(torch.cat([x_intm, flow, log_var], dim=1))
        flow = flow + out[:, 0:2]
        return flow, torch.clamp(log_var + out[:, 2:4], max=LOG_VAR_MAX)

    def forward_2_frames(self, p1: list, p2: list) -> list:
        b, _, h, w = p1[0].shape
        flow = p1[0].new_zeros((b, 2, h, w))
        log_var = p1[0].new_full((b, 2, h, w), LOG_VAR_INIT)
        flows, log_vars = [], []
        for level in range(OUTPUT_LEVEL + 1):
            if level:
                flow = upscale(flow, 2, scale=2.0)
                log_var = upscale(log_var, 2, bias=2 * math.log(2))
            flow, log_var = remat_region(self._decode_level, level, p1[level],
                                         p2[level], flow, log_var)
            flows.append(flow)
            log_vars.append(log_var)
        if self.upsample:
            flows = [upscale(f, 4, scale=4.0) for f in flows]
            log_vars = [upscale(v, 4, bias=2 * math.log(4)) for v in log_vars]
        outputs = [torch.cat([f, v], dim=1) for f, v in zip(flows, log_vars)]
        return outputs[::-1]
