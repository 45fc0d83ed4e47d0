"""Flow accuracy (the EPE part of ``arflow_tpu/utils/metrics.py:
evaluate_flow``, on tensors)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def evaluate_flow(gt_flows: torch.Tensor, pred_flows: torch.Tensor) -> list:
    """``[mean EPE]`` over a batch: gt (B,H,W,2), pred (B,h,w,2+), NHWC.

    A prediction of another size is resized bilinearly to the ground
    truth's and its values scaled by the size ratio. Ground truth with
    KITTI's occlusion masks (4 channels) raises: its E_noc, E_occ and F1
    metrics are not ported yet."""
    if gt_flows.shape[-1] != 2:
        raise NotImplementedError(
            "ground truth with occlusion masks (E_noc, E_occ, F1_all) is not "
            "ported yet: ROADMAP.md queue 1, 'main-path entry points'")
    hh, ww = gt_flows.shape[1:3]
    h, w = pred_flows.shape[1:3]
    pred = pred_flows[..., :2]
    if (h, w) != (hh, ww):
        pred = F.interpolate(pred.permute(0, 3, 1, 2), size=(hh, ww),
                             mode="bilinear", align_corners=False)
        pred = pred.permute(0, 2, 3, 1)
    pred = pred * pred.new_tensor([ww / w, hh / h])
    epe = (pred - gt_flows).square().sum(dim=-1).sqrt()
    return [float(epe.mean(dim=(1, 2)).mean())]
