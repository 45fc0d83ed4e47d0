"""ARFlow's pyramid ELBO loss, ``type: "elbo"`` (port of
``arflow_tpu/losses/elbo.py``): the unflow loss on one sample per level of
a diagonal Gaussian flow posterior, less an entropy bonus.

Each level's outputs carry [flow (2), log-variance (2)] per direction
(``PWCLiteProb``). The sample is ``mean + exp(log_var / 2) * eps`` with
standard normal ``eps``: injected as ``noise={"eps_fw_<i>": ...,
"eps_bw_<i>": ...}`` (NHWC, as the JAX loss takes them) or drawn from
``generator``, forward then backward per level. The level-0 occlusion
masks come from the level-0 samples. The entropy is half the mean summed
log-variance, averaged over both directions with ``with_bk``.

No trainer of either package runs this loss (``ROADMAP.md`` queue 3):
the ``uflow`` trainer calls a loss without noise, and the ``uflow_elbo``
trainer reads an ``l_oof`` term that it does not return. The port's
trainers refuse it when they are built.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.losses.unflow import (
    UnFlowLoss,
    _resize_nearest,
    pyramid_flows,
    weighted_sum,
)
from arflow_tpu_torch.models.uflow import to_nchw
from arflow_tpu_torch.ops import (
    flow_warp,
    get_occu_mask_backward,
    get_occu_mask_bidirection,
    resize_area,
)


class ElboLoss(UnFlowLoss):
    """cfg adds: w_entropy, w_en_scales."""

    def __call__(self, res_dict, img1, img2, noise=None, generator=None):
        """{'total', 'l_ph', 'l_sm', 'entropy', 'flow_mean'}."""
        cfg = self.cfg
        if noise is None and generator is None:
            raise ValueError("ElboLoss needs a torch.Generator (or injected "
                             "noise)")
        flows = pyramid_flows(res_dict)
        img1, img2 = to_nchw(img1), to_nchw(img2)
        warp_losses, smooth_losses, entropies = [], [], []
        occu1_l0 = occu2_l0 = None
        s = 1.0
        for i, flow in enumerate(flows):
            if cfg.w_scales[i] == 0:
                warp_losses.append(0.0)
                smooth_losses.append(0.0)
                continue
            h, w = flow.shape[-2:]
            im1_scaled = resize_area(img1, (h, w))
            im2_scaled = resize_area(img2, (h, w))

            mean_fw, log_var_fw = flow[:, 0:2], flow[:, 2:4]
            mean_bw, log_var_bw = flow[:, 4:6], flow[:, 6:8]
            if noise is not None:
                eps_fw = to_nchw(noise[f"eps_fw_{i}"])
                eps_bw = to_nchw(noise[f"eps_bw_{i}"])
            else:
                eps_fw, eps_bw = (
                    torch.randn(m.shape, generator=generator, device=m.device,
                                dtype=m.dtype) for m in (mean_fw, mean_bw))
            sample_fw = mean_fw + torch.exp(log_var_fw / 2.0) * eps_fw
            sample_bw = mean_bw + torch.exp(log_var_bw / 2.0) * eps_bw

            im1_recons = flow_warp(im2_scaled, sample_fw, pad=cfg.warp_pad)
            im2_recons = flow_warp(im1_scaled, sample_bw, pad=cfg.warp_pad)

            if i == 0:
                if cfg.get("occ_from_back", False):
                    occu_mask1 = 1.0 - get_occu_mask_backward(sample_bw, th=0.2)
                    occu_mask2 = 1.0 - get_occu_mask_backward(sample_fw, th=0.2)
                else:
                    occu_mask1 = 1.0 - get_occu_mask_bidirection(sample_fw,
                                                                  sample_bw)
                    occu_mask2 = 1.0 - get_occu_mask_bidirection(sample_bw,
                                                                  sample_fw)
                occu1_l0, occu2_l0 = occu_mask1, occu_mask2
                s = min(h, w)
            else:
                occu_mask1 = _resize_nearest(occu1_l0, (h, w))
                occu_mask2 = _resize_nearest(occu2_l0, (h, w))

            loss_warp = self.loss_photometric(im1_scaled, im1_recons, occu_mask1)
            loss_smooth = self.loss_smooth(sample_fw / s, im1_scaled)
            entropy = log_var_fw.sum(dim=1).mean() / 2.0
            if cfg.with_bk:
                loss_warp = (loss_warp + self.loss_photometric(
                    im2_scaled, im2_recons, occu_mask2)) / 2.0
                loss_smooth = (loss_smooth + self.loss_smooth(
                    sample_bw / s, im2_scaled)) / 2.0
                entropy = (entropy + log_var_bw.sum(dim=1).mean() / 2.0) / 2.0
            warp_losses.append(loss_warp)
            smooth_losses.append(loss_smooth)
            entropies.append(entropy)

        like = flows[0]
        warp_loss = weighted_sum(warp_losses, cfg.w_scales, like)
        smooth_loss = cfg.w_smooth * weighted_sum(smooth_losses,
                                                  cfg.w_sm_scales, like)
        entropy = cfg.w_entropy * weighted_sum(entropies, cfg.w_en_scales, like)
        return {"total": warp_loss + smooth_loss - entropy, "l_ph": warp_loss,
                "l_sm": smooth_loss, "entropy": entropy,
                "flow_mean": flows[0].abs().mean()}
