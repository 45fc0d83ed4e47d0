"""Full-resolution photometric loss, ``type: "fullres"`` (port of
``arflow_tpu/losses/fullres.py``).

The photometric terms (L1, ARFlow's SSIM, ternary with
``abs_robust_loss``) compare each image with the other warped by the
finest flow (``warp_pad``, ``align_corners``), masked by the border mask
and the occlusion mask, and normalized by the masks' sums. Occlusion:
``wang`` (the opposite flow's range map below ``wang_thr``), ``wang1``
(that range map clamped to [0, 1], with its gradient), ``brox``
(forward-backward consistency) or ``none`` (a 1-channel mask of ones).
Smoothness acts at level 2 on the images resized there, detached.

As the JAX loss does: SSIM takes the mask centre-cropped to its support,
and the ternary term's mask is detached. Flows and images arrive NHWC; the
loss works NCHW inside.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.losses.blocks import (
    smooth_grad_1st,
    smooth_grad_2nd,
    ternary_loss,
)
from arflow_tpu_torch.models.uflow import to_nchw
from arflow_tpu_torch.ops import (
    abs_robust_loss,
    border_mask,
    compute_range_map,
    flow_warp,
    get_occu_mask_backward,
    get_occu_mask_bidirection,
    resize_bilinear,
    ssim_dist,
)


class FullResLoss:
    """cfg: w_l1, w_ssim, w_ternary, ternary_distance, w_smooth, alpha,
    occ_type (wang|wang1|brox|none), wang_thr, warp_pad, align_corners,
    smooth_2nd, with_bk."""

    def __init__(self, cfg):
        self.cfg = cfg

    def loss_photometric(self, im, im_recons, occu_mask):
        cfg = self.cfg
        loss = 0.0
        if cfg.w_l1 > 0:
            l1 = cfg.w_l1 * (im - im_recons).abs() * occu_mask
            loss = loss + l1.sum() / (occu_mask.sum() + 1e-6)
        if cfg.w_ssim > 0:
            mask_c = occu_mask[:, :, 1:-1, 1:-1]
            ssim = cfg.w_ssim * ssim_dist(im_recons, im) * mask_c
            loss = loss + ssim.sum() / (mask_c.sum() + 1e-6)
        if cfg.w_ternary > 0:
            dist, valid = ternary_loss(im, im_recons,
                                       max_distance=cfg.ternary_distance,
                                       sum_dist=True)
            mask = (valid * occu_mask).detach()
            tern = cfg.w_ternary * abs_robust_loss(dist) * mask
            loss = loss + tern.sum() / (mask.sum() + 1e-6)
        return loss

    def loss_smooth(self, flow, im_scaled):
        if self.cfg.get("smooth_2nd", False):
            return smooth_grad_2nd(flow, im_scaled, self.cfg.alpha) * 2.0
        return smooth_grad_1st(flow, im_scaled, self.cfg.alpha,
                               penalty="uflow") * 2.0

    def _occu_mask(self, flow, flow_other):
        """1 where ``flow``'s pixels are visible, by ``occ_type``."""
        kind = self.cfg.occ_type
        if kind == "wang":
            return 1.0 - get_occu_mask_backward(flow_other, th=self.cfg.wang_thr)
        if kind == "wang1":
            return compute_range_map(flow_other).clamp(0.0, 1.0)
        if kind == "brox":
            return 1.0 - get_occu_mask_bidirection(flow, flow_other)
        if kind == "none":
            return torch.ones_like(flow[:, :1])
        raise NotImplementedError(kind)

    def __call__(self, res_dict, img1, img2):
        """{'total', 'l_ph', 'l_sm', 'flow_mean'}."""
        cfg = self.cfg
        flows_fw, flows_bw = res_dict["flows_fw"], res_dict["flows_bw"]
        flow12_0, flow21_0 = (to_nchw(f[0][..., 0:2]) for f in (flows_fw, flows_bw))
        flow12_2, flow21_2 = (to_nchw(f[2][..., 0:2]) for f in (flows_fw, flows_bw))
        img1, img2 = to_nchw(img1), to_nchw(img2)
        warp = dict(pad=cfg.warp_pad, align_corners=cfg.align_corners)

        im1_recons = flow_warp(img2.detach(), flow12_0, **warp)
        mask1 = self._occu_mask(flow12_0, flow21_0) * border_mask(flow12_0)
        loss_warp = self.loss_photometric(img1, im1_recons, mask1)
        if cfg.with_bk:
            im2_recons = flow_warp(img1.detach(), flow21_0, **warp)
            mask2 = self._occu_mask(flow21_0, flow12_0) * border_mask(flow21_0)
            loss_warp = loss_warp + self.loss_photometric(img2, im2_recons, mask2)

        h, w = flow12_2.shape[-2:]
        im1_2 = resize_bilinear(img1, (h, w), align_corners=cfg.align_corners)
        loss_smooth = self.loss_smooth(flow12_2, im1_2.detach())
        if cfg.with_bk:
            im2_2 = resize_bilinear(img2, (h, w), align_corners=cfg.align_corners)
            loss_smooth = loss_smooth + self.loss_smooth(flow21_2, im2_2.detach())

        flow_mean = torch.cat([flows_fw[0], flows_bw[0]], dim=-1).abs().mean()
        return {"total": loss_warp + cfg.w_smooth * loss_smooth,
                "l_ph": loss_warp, "l_sm": loss_smooth, "flow_mean": flow_mean}
