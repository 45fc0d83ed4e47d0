"""Building blocks of the ELBO loss (port of ``arflow_tpu/losses/blocks.py``):
the per-pixel data terms before their penalty, for one direction and for
both in one batch, and the edge-aware smoothness weights.

Tensors come and go NHWC, as in the JAX package; the port's ops run NCHW
inside. What the JAX package passes through ``stop_gradient`` is detached
here: the images as warp sources and smoothness weights, and the masks.

The per-sample warp is exact. The JAX package's opt-in Taylor warp
(``taylor_warp``) is not ported, and ``ssim`` comes with the PWC-Lite
family; both raise.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc
from arflow_tpu_torch.ops import (
    compute_range_map,
    downsample,
    flow_to_warp,
    image_grads,
    mask_invalid,
    resample,
    upsample,
)
from arflow_tpu_torch.ops.census import census_loss_no_penalty

SSIM_NOT_PORTED = ("the ssim data loss is not ported yet: ROADMAP.md queue 1, "
                   "'the PWC-Lite family' (ops/ssim.py)")


def _census_terms(data_loss, targets, recons, mask, **kwargs):
    """(pixel losses, pixel weights) per entry of ``data_loss``, NHWC."""
    pixel_loss, pixel_weight = [], []
    for loss_type in data_loss:
        if loss_type == "ssim":
            raise NotImplementedError(SSIM_NOT_PORTED)
        if loss_type != "census":
            raise NotImplementedError(loss_type)
        loss, weight = census_loss_no_penalty(targets, recons, mask, **kwargs)
        pixel_loss.append(to_nhwc(loss))
        pixel_weight.append(to_nhwc(weight))
    return pixel_loss, pixel_weight


def _occlusion_2(flow_2):
    """The range map of a 1/4-resolution flow, clipped to [0, 1]."""
    return compute_range_map(flow_2).clamp(0.0, 1.0)


def data_loss_no_penalty(im1_0, im2_0, flow12_2, flow21_2, occ_type: str,
                         data_loss, mean12_2=None, mean21_2=None):
    """Per-pixel data losses and weights of the forward direction, before
    the penalties. Images at full resolution, flows and means at 1/4.

    Returns (pixel_loss_list, pixel_weight_list, occu_mask_2,
    valid_mask_0); ``occu_mask_2`` is None for occ_type 'none'."""
    im1_0, im2_0 = to_nchw(im1_0), to_nchw(im2_0)
    flow12_2, flow21_2 = to_nchw(flow12_2), to_nchw(flow21_2)
    warp12_0 = flow_to_warp(upsample(flow12_2, is_flow=True, scale_factor=4.0))
    im1_recons = resample(im2_0.detach(), warp12_0)

    occu_mask_2 = None
    if occ_type == "mean":
        mean12_0 = upsample(to_nchw(mean12_2), is_flow=True, scale_factor=4.0)
        valid_mask_0 = mask_invalid(flow_to_warp(mean12_0))
        occu_mask_2 = _occlusion_2(to_nchw(mean21_2))
    elif occ_type == "sample":
        valid_mask_0 = mask_invalid(warp12_0)
        occu_mask_2 = _occlusion_2(flow21_2)
    elif occ_type == "none":
        valid_mask_0 = mask_invalid(warp12_0)
    else:
        raise NotImplementedError(f"Occlusion type {occ_type} not implemented!")
    mask_0 = valid_mask_0
    if occu_mask_2 is not None:
        mask_0 = upsample(occu_mask_2, is_flow=False, scale_factor=4.0) * mask_0
    pixel_loss, pixel_weight = _census_terms(data_loss, im1_0, im1_recons,
                                             mask_0.detach())
    return (pixel_loss, pixel_weight,
            None if occu_mask_2 is None else to_nhwc(occu_mask_2),
            to_nhwc(valid_mask_0))


def _tile_groups(x, n, groups=2):
    """(G*B, ...) -> (G*n*B, ...), each group tiled sample-major."""
    if n == 1:
        return x
    b = x.shape[0] // groups
    xg = x.reshape((groups, 1, b) + x.shape[1:])
    return xg.expand((groups, n, b) + x.shape[1:]).reshape(
        (groups * n * b,) + x.shape[1:])


def data_loss_no_penalty_bidir(im1_0, im2_0, flow12_2, flow21_2,
                               occ_type: str, data_loss, mean12_2=None,
                               mean21_2=None, n_rep: int = 1):
    """Both directions of ``data_loss_no_penalty`` as one batch [fw; bw].

    Images and means come un-tiled (batch B), the sampled flows tiled
    (n_rep * B, sample-major). Each weight map is normalized over its own
    direction, so the sum of the penalized batch is the sum of the two
    directions' data terms. The target's census runs once per image, and
    for occ_type 'mean' the masks, which do not depend on the sample, are
    computed at B and tiled.

    Returns (pixel_loss_list, pixel_weight_list, occu_mask_2,
    valid_mask_0), each batched [fw; bw] at the flows' batch
    (``occu_mask_2`` None for 'none')."""
    n = n_rep
    im1_0, im2_0 = to_nchw(im1_0), to_nchw(im2_0)
    flow_2 = to_nchw(torch.cat([flow12_2, flow21_2], dim=0))
    warp_0 = flow_to_warp(upsample(flow_2, is_flow=True, scale_factor=4.0))
    # One sampler call for every sample of both directions.
    sources = torch.cat([im2_0.detach().repeat(n, 1, 1, 1),
                         im1_0.detach().repeat(n, 1, 1, 1)], dim=0)
    recons = resample(sources, warp_0)
    targets = torch.cat([im1_0, im2_0], dim=0)

    occu_mask_2 = None
    if occ_type == "mean":
        mean_2 = to_nchw(torch.cat([mean12_2, mean21_2], dim=0))
        mean_0 = upsample(mean_2, is_flow=True, scale_factor=4.0)
        valid_small_0 = mask_invalid(flow_to_warp(mean_0))
        occu_small_2 = _occlusion_2(to_nchw(torch.cat([mean21_2, mean12_2], dim=0)))
        occu_small_0 = upsample(occu_small_2, is_flow=False, scale_factor=4.0)
        valid_mask_0 = _tile_groups(valid_small_0, n)
        occu_mask_2 = _tile_groups(occu_small_2, n)
        mask_0 = _tile_groups((occu_small_0 * valid_small_0).detach(), n)
    elif occ_type == "sample":
        valid_mask_0 = mask_invalid(warp_0)
        occu_mask_2 = _occlusion_2(to_nchw(torch.cat([flow21_2, flow12_2], dim=0)))
        mask_0 = (upsample(occu_mask_2, is_flow=False, scale_factor=4.0)
                  * valid_mask_0).detach()
    elif occ_type == "none":
        valid_mask_0 = mask_invalid(warp_0)
        mask_0 = valid_mask_0.detach()
    else:
        raise NotImplementedError(f"Occlusion type {occ_type} not implemented!")

    pixel_loss, pixel_weight = _census_terms(data_loss, targets, recons, mask_0,
                                             num_groups=2, a_rep=n)
    return (pixel_loss, pixel_weight,
            None if occu_mask_2 is None else to_nhwc(occu_mask_2),
            to_nhwc(valid_mask_0))


def _edge_weight(grad, edge_constant, edge_asymp):
    return edge_asymp + (1.0 - edge_asymp) * torch.exp(
        -(edge_constant * grad).abs().mean(dim=1, keepdim=True))


def smooth_loss_no_penalty(im1_0, flow12_2, edge_constant, edge_asymp):
    """First-order flow differences at 1/4 resolution and their edge-aware
    weights, halved: (flow_x, weights_x / 2, flow_y, weights_y / 2), NHWC."""
    im1_2 = downsample(to_nchw(im1_0), is_flow=False, scale_factor=4.0)
    im1_gx, im1_gy = image_grads(im1_2.detach())
    weights_x = _edge_weight(im1_gx, edge_constant, edge_asymp)
    weights_y = _edge_weight(im1_gy, edge_constant, edge_asymp)
    flow12_x, flow12_y = image_grads(to_nchw(flow12_2))
    return (to_nhwc(flow12_x), to_nhwc(weights_x / 2.0),
            to_nhwc(flow12_y), to_nhwc(weights_y / 2.0))


def edge_weights(image, edge_constant, edge_asymp=0.0, stride=1):
    """Edge-aware smoothness weights (wx, wy) of an NHWC image, NHWC."""
    gx, gy = image_grads(to_nchw(image).detach(), stride=stride)
    return (to_nhwc(_edge_weight(gx, edge_constant, edge_asymp)),
            to_nhwc(_edge_weight(gy, edge_constant, edge_asymp)))
