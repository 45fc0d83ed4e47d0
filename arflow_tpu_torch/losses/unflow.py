"""ARFlow's multi-scale unsupervised loss, ``type: "unflow"`` (port of
``arflow_tpu/losses/unflow.py``).

At each pyramid level with a nonzero ``w_scales`` entry the images are
area-resized to the flow's size and warped by it (``flow_warp`` with
``warp_pad``), and the photometric terms (L1, ARFlow's SSIM, ternary) are
masked by the occlusion masks of the finest flow, resized to the level by
nearest neighbour. Occlusion comes from the opposite direction's range map
thresholded at 0.2 (``occ_from_back``) or from forward-backward
consistency. Smoothness (first or second order, edge-aware) acts on the
flow divided by the finest flow's shorter side.

As the JAX loss does: the level-0 masks are computed from the finest flow
even where ``w_scales[0]`` is 0 (where the reference fails), and the
ternary term is its distance masked by its valid mask.

Flows and images arrive NHWC, flows finest first, as the PWC-Lite models
return them; the loss works NCHW inside.
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
    flow_warp,
    get_occu_mask_backward,
    get_occu_mask_bidirection,
    resize_area,
    ssim_dist,
)


def _resize_nearest(x, out_hw):
    """Nearest-neighbour resize of an NCHW map with the JAX loss's integer
    indices ``(i * h) // oh``."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, iy][:, :, :, ix]


def pyramid_flows(res_dict):
    """Each level's forward and backward outputs side by side, NCHW."""
    return [torch.cat([to_nchw(fw), to_nchw(bw)], dim=1)
            for fw, bw in zip(res_dict["flows_fw"], res_dict["flows_bw"])]


def weighted_sum(terms, weights, like):
    """sum of term * weight, a tensor like ``like`` even where every
    weight is 0."""
    total = like.new_zeros(())
    for t, w in zip(terms, weights):
        total = total + t * w
    return total


class UnFlowLoss:
    """cfg: w_l1, w_ssim, w_ternary, w_scales, w_sm_scales, w_smooth, alpha,
    occ_from_back, smooth_2nd, warp_pad, with_bk."""

    def __init__(self, cfg):
        self.cfg = cfg

    def loss_photometric(self, im_scaled, im_recons, occu_mask):
        cfg = self.cfg
        terms = []
        if cfg.w_l1 > 0:
            terms.append(cfg.w_l1 * (im_scaled - im_recons).abs() * occu_mask)
        if cfg.w_ssim > 0:
            terms.append(cfg.w_ssim * ssim_dist(im_recons * occu_mask,
                                                im_scaled * occu_mask))
        if cfg.w_ternary > 0:
            dist, valid = ternary_loss(im_recons * occu_mask,
                                       im_scaled * occu_mask)
            terms.append(cfg.w_ternary * dist * valid)
        return sum(t.mean() for t in terms) / occu_mask.mean()

    def loss_smooth(self, flow, im_scaled):
        if self.cfg.get("smooth_2nd", False):
            return smooth_grad_2nd(flow, im_scaled, self.cfg.alpha)
        return smooth_grad_1st(flow, im_scaled, self.cfg.alpha)

    def _occu_masks_l0(self, flow0):
        """The finest level's masks, 1 where visible: image 1's, image
        2's."""
        fw, bw = flow0[:, :2], flow0[:, 2:]
        if self.cfg.get("occ_from_back", False):
            return (1.0 - get_occu_mask_backward(bw, th=0.2),
                    1.0 - get_occu_mask_backward(fw, th=0.2))
        return (1.0 - get_occu_mask_bidirection(fw, bw),
                1.0 - get_occu_mask_bidirection(bw, fw))

    def __call__(self, res_dict, img1, img2):
        """{'total', 'l_ph', 'l_sm', 'flow_mean'}."""
        cfg = self.cfg
        flows = pyramid_flows(res_dict)
        img1, img2 = to_nchw(img1), to_nchw(img2)
        warp_losses, smooth_losses = [], []
        occu_l0 = None
        s = 1.0
        for i, flow in enumerate(flows):
            if cfg.w_scales[i] == 0:
                warp_losses.append(0.0)
                smooth_losses.append(0.0)
                continue
            h, w = flow.shape[-2:]
            im1_scaled = resize_area(img1, (h, w))
            im2_scaled = resize_area(img2, (h, w))
            im1_recons = flow_warp(im2_scaled, flow[:, :2], pad=cfg.warp_pad)
            im2_recons = flow_warp(im1_scaled, flow[:, 2:], pad=cfg.warp_pad)
            if occu_l0 is None:
                occu_l0 = self._occu_masks_l0(flows[0])
                s = min(flows[0].shape[-2:])
            if i == 0:
                occu_mask1, occu_mask2 = occu_l0
            else:
                occu_mask1, occu_mask2 = (_resize_nearest(m, (h, w))
                                          for m in occu_l0)

            loss_warp = self.loss_photometric(im1_scaled, im1_recons, occu_mask1)
            loss_smooth = self.loss_smooth(flow[:, :2] / s, im1_scaled)
            if cfg.with_bk:
                loss_warp = (loss_warp + self.loss_photometric(
                    im2_scaled, im2_recons, occu_mask2)) / 2.0
                loss_smooth = (loss_smooth + self.loss_smooth(
                    flow[:, 2:] / s, im2_scaled)) / 2.0
            warp_losses.append(loss_warp)
            smooth_losses.append(loss_smooth)

        warp_loss = weighted_sum(warp_losses, cfg.w_scales, flows[0])
        smooth_loss = cfg.w_smooth * weighted_sum(smooth_losses,
                                                  cfg.w_sm_scales, flows[0])
        return {"total": warp_loss + smooth_loss, "l_ph": warp_loss,
                "l_sm": smooth_loss, "flow_mean": flows[0].abs().mean()}
