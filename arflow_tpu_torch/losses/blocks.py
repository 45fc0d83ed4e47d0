"""Building blocks of the losses (port of ``arflow_tpu/losses/blocks.py``):
the ELBO loss's per-pixel data terms before their penalty (census and
ssim), for one direction and for both in one batch, and its edge-aware
smoothness weights; and the ARFlow losses' ternary distance and
first- and second-order edge-aware smoothness.

Tensors come and go NHWC, as in the JAX package; the port's ops run NCHW
inside. What the JAX package passes through ``stop_gradient`` is detached
here: the images as warp sources and smoothness weights, and the masks.

The bidirectional data term warps each Monte-Carlo sample exactly, or,
with the opt-in Taylor warp (``taylor_warp_enabled``), gathers once at the
posterior mean (per component of a mixture) and linearizes each sample
around it.

The ARFlow blocks (``ternary_loss``, ``smooth_grad_1st``,
``smooth_grad_2nd``) take and return NCHW tensors, as the losses that
call them work inside.
"""

from __future__ import annotations

import os

import torch

from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc
from arflow_tpu_torch.ops import (
    compute_range_map,
    downsample,
    flow_to_warp,
    image_grads,
    mask_invalid,
    resample,
    resample_with_grads,
    upsample,
)
from arflow_tpu_torch.ops.census import (
    census_loss_no_penalty,
    census_transform,
)
from arflow_tpu_torch.ops.ssim import ssim_loss
from arflow_tpu_torch.parallel.mesh import batch_mean


def _data_terms(data_loss, targets, recons, mask, num_groups=1, a_rep=1):
    """(pixel losses, pixel weights) per entry of ``data_loss``, NHWC. The
    census transform of ``targets`` runs once for its ``a_rep`` copies;
    ssim takes the targets tiled. An ssim pixel loss is the list of its
    two distances, each penalized and summed by the caller."""
    pixel_loss, pixel_weight = [], []
    for loss_type in data_loss:
        if loss_type == "census":
            loss, weight = census_loss_no_penalty(
                targets, recons, mask, num_groups=num_groups, a_rep=a_rep)
            loss = to_nhwc(loss)
        elif loss_type == "ssim":
            loss, weight = ssim_loss(_tile_groups(targets, a_rep, num_groups),
                                     recons, mask, num_groups=num_groups)
            loss = [to_nhwc(d) for d in loss]
        else:
            raise NotImplementedError(loss_type)
        pixel_loss.append(loss)
        pixel_weight.append(to_nhwc(weight))
    return pixel_loss, pixel_weight


def taylor_warp_enabled(default: bool = False) -> bool:
    """Whether the ELBO's Monte-Carlo samples take the Taylor warp: each
    sample reconstructed as

        resample(im, warp(mean)) + grad(im)|warp(mean) . (flow_s - mean)

    from one gather at the posterior mean, with the interpolant's exact
    within-cell partials (``ops.resample_with_grads``). First-order in the
    sample's offset from the mean, exact while both lie in one 2x2 cell.
    ``ARFLOW_TAYLOR_WARP=0/1`` overrides ``default`` (the loss's
    ``taylor_warp``); it is read at each call."""
    env = os.environ.get("ARFLOW_TAYLOR_WARP")
    if env is not None:
        return env == "1"
    return default


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
    pixel_loss, pixel_weight = _data_terms(data_loss, im1_0, im1_recons,
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


def _taylor_recons_mixture(src, mean_2, flow_0, z, n):
    """Taylor-warp reconstructions of one direction's samples: ``src``
    (B,C,H,W) the detached warp source, ``mean_2`` (B,h,w,2K) the means of
    the posterior's K components at 1/4 resolution, ``flow_0`` (n*B,2,H,W)
    the sampled flows at full resolution (sample-major), ``z`` (B,n) each
    sample's drawn component. One ``resample_with_grads`` per component at
    batch B; sample s of entry i reads the taps of component z[i, s] and
    is linearized around that component's mean. A unimodal posterior is
    its K = 1 case (2-channel means, ``z`` None): one gather at the
    mean."""
    bs, k = src.shape[0], mean_2.shape[-1] // 2
    if z is None:
        z = torch.zeros((bs, n), dtype=torch.long, device=src.device)
    mean_0 = upsample(to_nchw(mean_2), is_flow=True, scale_factor=4.0)
    means = mean_0.reshape((bs, k, 2) + mean_0.shape[2:])  # (B,K,2,H,W)
    taps = [resample_with_grads(src, flow_to_warp(means[:, i]))
            for i in range(k)]
    zi = z.long().t().reshape(-1)  # row s*B + i: component z[i, s]
    bi = torch.arange(bs, device=src.device).repeat(n)
    base, gx, gy = (torch.stack(t, dim=1)[bi, zi] for t in zip(*taps))
    delta = flow_0 - means[bi, zi]
    return base + gx * delta[:, 0:1] + gy * delta[:, 1:2]


def data_loss_no_penalty_bidir(im1_0, im2_0, flow12_2, flow21_2,
                               occ_type: str, data_loss, mean12_2=None,
                               mean21_2=None, n_rep: int = 1,
                               taylor_default: bool = False, z12=None,
                               z21=None):
    """Both directions of ``data_loss_no_penalty`` as one batch [fw; bw].

    Images and means come un-tiled (batch B), the sampled flows tiled
    (n_rep * B, sample-major). Each weight map is normalized over its own
    direction, so the sum of the penalized batch is the sum of the two
    directions' data terms. The target's census runs once per image, and
    for occ_type 'mean' the masks, which do not depend on the sample, are
    computed at B and tiled.

    The Taylor warp (``taylor_warp_enabled(taylor_default)``) takes over
    where there are several samples and means: 2-channel means, or a
    mixture's 2K-channel means with the drawn components ``z12`` / ``z21``
    ((B, n_rep) each). A mixture without them warps each sample exactly.
    Out-of-image zero fill then follows the mean's warp; the validity mask
    of occ_type 'sample' and 'none' still follows each sample's.

    Returns (pixel_loss_list, pixel_weight_list, occu_mask_2,
    valid_mask_0), each batched [fw; bw] at the flows' batch
    (``occu_mask_2`` None for 'none')."""
    n = n_rep
    im1_0, im2_0 = to_nchw(im1_0), to_nchw(im2_0)
    flow_2 = to_nchw(torch.cat([flow12_2, flow21_2], dim=0))
    flow_0 = upsample(flow_2, is_flow=True, scale_factor=4.0)
    warp_0 = flow_to_warp(flow_0)
    im1_sg, im2_sg = im1_0.detach(), im2_0.detach()
    taylor = (n > 1 and mean12_2 is not None
              and taylor_warp_enabled(taylor_default)
              and (mean12_2.shape[-1] == 2
                   or (z12 is not None and z21 is not None)))
    if taylor:
        b = flow12_2.shape[0]
        if mean12_2.shape[-1] == 2:  # one component: no draws to read
            z12 = z21 = None
        recons = torch.cat([
            _taylor_recons_mixture(im2_sg, mean12_2, flow_0[:b], z12, n),
            _taylor_recons_mixture(im1_sg, mean21_2, flow_0[b:], z21, n),
        ], dim=0)
    else:
        # One sampler call for every sample of both directions.
        sources = torch.cat([im2_sg.repeat(n, 1, 1, 1),
                             im1_sg.repeat(n, 1, 1, 1)], dim=0)
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

    pixel_loss, pixel_weight = _data_terms(data_loss, targets, recons, mask_0,
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


# -- the ARFlow blocks (NCHW) ----------------------------------------------

def ternary_loss(im, im_warp, max_distance: int = 1, sum_dist: bool = False):
    """The ternary (census) distance of two NCHW images over a
    ``2 max_distance + 1`` square, summed or averaged over its taps, and
    the mask that zeroes a ``max_distance`` border: (dist, mask), each
    (B,1,H,W)."""
    patch_size = 2 * max_distance + 1
    dist = (census_transform(im, patch_size)
            - census_transform(im_warp, patch_size)).square()
    dist_norm = dist / (0.1 + dist)
    if sum_dist:
        dist_mean = dist_norm.sum(dim=1, keepdim=True)
    else:
        dist_mean = dist_norm.mean(dim=1, keepdim=True)
    b, _, h, w = im.shape
    pad = max_distance
    inner = im.new_zeros((1, 1, h, w))
    inner[..., pad:h - pad, pad:w - pad] = 1.0
    return dist_mean, inner.expand(b, 1, h, w)


def penalty_uflow(x):
    """sqrt(x^2 + 0.001^2)."""
    return torch.sqrt(x.square() + 0.001**2)


def _smooth_weights(image, alpha):
    img_dx, img_dy = image_grads(image)
    return (torch.exp(-img_dx.abs().mean(dim=1, keepdim=True) * alpha),
            torch.exp(-img_dy.abs().mean(dim=1, keepdim=True) * alpha))


def smooth_grad_1st(flo, image, alpha, penalty: str = "abs"):
    """First-order edge-aware smoothness of an NCHW flow, weighted by
    ``exp(-alpha |image gradient|)``; ``penalty`` "abs" or "uflow"."""
    weights_x, weights_y = _smooth_weights(image, alpha)
    dx, dy = image_grads(flo)
    if penalty == "abs":
        pen = torch.abs
    elif penalty == "uflow":
        pen = penalty_uflow
    else:
        raise NotImplementedError(penalty)
    loss_x = weights_x * pen(dx) / 2.0
    loss_y = weights_y * pen(dy) / 2.0
    return batch_mean(loss_x) / 2.0 + batch_mean(loss_y) / 2.0


def smooth_grad_2nd(flo, image, alpha):
    """Second-order edge-aware smoothness of an NCHW flow (``|.|``)."""
    weights_x, weights_y = _smooth_weights(image, alpha)
    dx, dy = image_grads(flo)
    dx2, _ = image_grads(dx)
    _, dy2 = image_grads(dy)
    loss_x = weights_x[..., :, 1:] * dx2.abs()
    loss_y = weights_y[..., 1:, :] * dy2.abs()
    return batch_mean(loss_x) / 2.0 + batch_mean(loss_y) / 2.0
