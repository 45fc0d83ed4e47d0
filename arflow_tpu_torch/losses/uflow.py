"""UFlow loss (port of ``arflow_tpu/losses/uflow.py``): census photometric
at full resolution plus edge-aware smoothness at 1/4.

Occlusion masks come from the opposite direction's range map at level 2,
upsampled 4x. Flows and images arrive NHWC, as ``PWCFlow.forward`` returns
them; the loss works in NCHW inside and returns ``mask1`` NHWC. What the JAX
package passes through ``stop_gradient`` is detached here.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc
from arflow_tpu_torch.ops import (
    census_loss,
    compute_range_map,
    downsample,
    flow_to_warp,
    image_grads,
    mask_invalid,
    resample,
    robust_l1,
    upsample,
)


class UFlowLoss:
    """cfg: w_census, w_smooth, smooth_order (1|2), edge_constant, with_bk.

    ``smooth_order`` has no default: like the JAX loss, a config without it
    raises ``AttributeError``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def _smooth_one_direction(self, im_2, flow_2):
        cfg = self.cfg
        stride = 2 if cfg.smooth_order == 2 else 1
        im_gx, im_gy = image_grads(im_2.detach(), stride=stride)
        weights_x = torch.exp(
            -(cfg.edge_constant * im_gx).abs().mean(dim=1, keepdim=True))
        weights_y = torch.exp(
            -(cfg.edge_constant * im_gy).abs().mean(dim=1, keepdim=True))
        flow_gx, flow_gy = image_grads(flow_2)
        if cfg.smooth_order == 1:
            tx, ty = flow_gx, flow_gy
        elif cfg.smooth_order == 2:
            tx, _ = image_grads(flow_gx)
            _, ty = image_grads(flow_gy)
        else:
            raise NotImplementedError(f"smooth_order {cfg.smooth_order}")
        return cfg.w_smooth * (
            (weights_x * robust_l1(tx.square())).mean()
            + (weights_y * robust_l1(ty.square())).mean()) / 2.0

    @staticmethod
    def _occlusion(flow_2):
        """Range map of the level-2 flow, clipped to [0, 1] and upsampled to
        full resolution. Only its value is used (the mask is detached)."""
        occu = compute_range_map(flow_2.detach()).clamp(0.0, 1.0)
        return upsample(occu, is_flow=False, scale_factor=4.0)

    def __call__(self, res_dict, img1, img2):
        """Flows (6 per direction, NHWC, finest first) and NHWC images ->
        {'total', 'l_ph', 'l_sm', 'flow_mean', 'mask1'}."""
        cfg = self.cfg
        flows_fw, flows_bw = res_dict["flows_fw"], res_dict["flows_bw"]
        flow12_0 = to_nchw(flows_fw[0][..., 0:2])
        flow12_2 = to_nchw(flows_fw[2][..., 0:2])
        flow21_2 = to_nchw(flows_bw[2][..., 0:2])
        img1, img2 = to_nchw(img1), to_nchw(img2)

        if cfg.with_bk:
            flow21_0 = to_nchw(flows_bw[0][..., 0:2])
            targets = torch.cat([img1, img2], dim=0)
            warp12_0 = flow_to_warp(flow12_0)
            warp21_0 = flow_to_warp(flow21_0)
            recons = torch.cat([resample(img2.detach(), warp12_0),
                                resample(img1.detach(), warp21_0)], dim=0)
            valid = mask_invalid(torch.cat([warp12_0, warp21_0], dim=0))
            # Occlusion from the OPPOSITE direction's range map.
            occu = self._occlusion(torch.cat([flow21_2, flow12_2], dim=0))
            mask = (occu * valid).detach()
            loss_warp = cfg.w_census * census_loss(
                targets, recons, mask, num_groups=2).sum()
            # Both directions in one batch: the mean over 2B is the average
            # of the two per-direction means; the reference sums them.
            loss_smooth = 2.0 * self._smooth_one_direction(
                downsample(targets, is_flow=False, scale_factor=4.0),
                torch.cat([flow12_2, flow21_2], dim=0))
            mask1 = mask[:img1.shape[0]]
        else:
            warp12_0 = flow_to_warp(flow12_0)
            im1_recons = resample(img2.detach(), warp12_0)
            mask1 = (self._occlusion(flow21_2) * mask_invalid(warp12_0)).detach()
            loss_warp = cfg.w_census * census_loss(img1, im1_recons, mask1)
            loss_smooth = self._smooth_one_direction(
                downsample(img1, is_flow=False, scale_factor=4.0), flow12_2)

        flow_mean = torch.cat([flows_fw[0], flows_bw[0]], dim=-1).abs().mean()
        return {
            "total": loss_warp + loss_smooth,
            "l_ph": loss_warp,
            "l_sm": loss_smooth,
            "flow_mean": flow_mean,
            "mask1": to_nhwc(mask1),
        }
