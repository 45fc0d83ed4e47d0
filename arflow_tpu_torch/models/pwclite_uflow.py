"""PWCLiteUflow, the PWC-Lite / UFlow hybrid (port of
``arflow_tpu/models/pwclite_uflow.py``).

A thin 5-level pyramid (channels 16, 32, 32, 32, 32; three convs per level,
the input rescaled to [-1, 1]), one estimator per level fed the coarser
level's features through a transposed conv (``deconv_networks``), optional
joint feature normalization before the cost volume, whole-level dropout in
training, and a configurable ``align_corners`` and warp padding. Decoding
runs from 1/32 to 1/4 resolution, the context network refines the 1/4 flow,
and two 2x upsamples follow. Outputs finest first: [full, 1/2, 1/4, 1/8,
1/16, 1/32], float32, NHWC.

With ``train=True`` and ``level_dropout`` p > 0, each level's (flow
residual, features) and the context residual are kept or dropped whole:
one draw ``U[0,1) > p`` per level and one for the context, 5 per
direction, from the ``torch.Generator`` passed to ``forward``
(``models/uflow.py:level_dropout``). Under ``rematerialized()`` each
pyramid level, each level's estimate and the context network are
checkpointed ``remat_region``s; the draws stay outside them.

Only the gates-off math is ported: the JAX package turns its W-fold
pyramid on at inference by default (``arflow_tpu/models/pwclite_uflow.py:
63``), a relayout with the same numerics.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from arflow_tpu_torch.models.layers import conv_transpose2d, remat_region
from arflow_tpu_torch.models.pwclite import (
    CORR_CHANNELS,
    ContextNetwork,
    FeatureExtractor,
    correlate,
    estimator,
    to_nchw,
    to_nhwc,
    upscale,
)
from arflow_tpu_torch.models.uflow import level_dropout
from arflow_tpu_torch.ops import flow_warp

THIN_CHS = (3, 16, 32, 32, 32, 32)
CONVS_PER_LEVEL = 3
OUTPUT_LEVEL = 3  # decode levels 0 (1/32) .. 3 (1/4)
DECONV_CHANNELS = 32


def normalize_features_joint(features: list) -> list:
    """Standardize the maps of ``features`` together, per sample: one mean
    and one unbiased variance over all their channels and pixels, epsilon
    1e-16 (``arflow_tpu/models/pwclite_uflow.py:_normalize_features_joint``)."""
    x = torch.cat(features, dim=1)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    n = x.shape[1] * x.shape[2] * x.shape[3]
    var = (x - mean).square().sum(dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)
    std = torch.sqrt(var + 1e-16)
    return [(f - mean) / std for f in features]


class PWCLiteUflow(nn.Module):
    """The 2-frame PWC-Lite / UFlow hybrid."""

    pyramid_module = "feature_pyramid_extractor"

    def __init__(self, n_frames: int = 2, reduce_dense: bool = True,
                 level_dropout: float = 0.0, feature_norm: bool = False,
                 align_corners: bool = True, warp_pad: str = "zeros",
                 dtype: torch.dtype | None = None):
        super().__init__()
        if n_frames != 2:
            raise ValueError(f"PWCLiteUflow is a 2-frame network, got "
                             f"n_frames {n_frames}")
        if warp_pad not in ("zeros", "border"):
            raise ValueError(f"warp_pad {warp_pad!r}: 'zeros' or 'border'")
        self.n_frames = n_frames
        self.level_dropout = level_dropout
        self.feature_norm = feature_norm
        self.align_corners = align_corners
        self.warp_pad = warp_pad
        self.compute_dtype = dtype
        self.feature_pyramid_extractor = FeatureExtractor(
            THIN_CHS, CONVS_PER_LEVEL, rescale=True, dtype=dtype)
        feat = THIN_CHS[-1]
        self.flow_estimators = nn.ModuleList(
            estimator(reduce_dense,
                      CORR_CHANNELS + feat + 2 + (DECONV_CHANNELS if level else 0),
                      2, dtype)
            for level in range(OUTPUT_LEVEL + 1))
        self.deconv_networks = nn.ModuleList(
            conv_transpose2d(self.flow_estimators[level].feat_dim,
                             DECONV_CHANNELS, dtype=dtype)
            for level in range(OUTPUT_LEVEL))
        self.context_networks = ContextNetwork(
            self.flow_estimators[-1].feat_dim + 2, 2, dtype)

    def feature_pyramid(self, img: torch.Tensor) -> list:
        """NCHW image in [0, 1] -> per-level NCHW features, coarsest
        first."""
        return self.feature_pyramid_extractor(img)

    def feature_pyramids(self, img: torch.Tensor) -> list:
        """``[feature_pyramid(img)]``, the streaming engine's form."""
        return [self.feature_pyramid(img)]

    def decode(self, fps1: list, fps2: list) -> list:
        """Both frames' ``feature_pyramids`` -> NCHW flows, finest first,
        float32."""
        return self._f32(self.forward_2_frames(fps1[0], fps2[0]))

    def _f32(self, flows: list) -> list:
        if self.compute_dtype is None:
            return flows
        return [f.to(torch.float32) for f in flows]

    def _up2(self, flow):
        return upscale(flow, 2, scale=2.0, align_corners=self.align_corners)

    def _estimate(self, level: int, x1, x2, flow, act):
        """One level's (features, flow residual) before dropout: ``x2``
        warped by the upsampled ``flow`` (but at the coarsest level), the
        joint feature normalization, the correlation and the level's
        estimator, fed the coarser level's features ``act`` through its
        transposed conv."""
        x2_warp = x2 if level == 0 else flow_warp(
            x2, flow, pad=self.warp_pad, align_corners=self.align_corners)
        if self.feature_norm:
            x1, x2_warp = normalize_features_joint([x1, x2_warp])
        inputs = [correlate(x1, x2_warp), x1, flow]
        if level > 0:
            inputs.append(self.deconv_networks[level - 1](act))
        return self.flow_estimators[level](torch.cat(inputs, dim=1))

    def forward_2_frames(self, p1: list, p2: list, generator=None) -> list:
        """Coarse-to-fine flow between two pyramids; NCHW flows, finest
        first. With ``generator``, level dropout draws from it
        (training)."""
        b, _, h, w = p1[0].shape
        flow = p1[0].new_zeros((b, 2, h, w))
        flows = []
        act = None
        p = self.level_dropout
        for level in range(OUTPUT_LEVEL + 1):
            if level:
                flow = self._up2(flow)
            act, flow_res = remat_region(self._estimate, level, p1[level],
                                         p2[level], flow, act)
            flow_res, act = level_dropout([flow_res, act], p, generator)
            flow = flow + flow_res
            flows.append(flow)

        flow_fine = remat_region(self.context_networks,
                                 torch.cat([act, flow], dim=1))
        (flow_fine,) = level_dropout([flow_fine], p, generator)
        flow = flow + flow_fine
        flows[-1] = flow
        for _ in range(2):
            flow = self._up2(flow)
            flows.append(flow)
        return flows[::-1]

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                with_bk: bool = False, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """Images NHWC (B,H,W,3) in [0, 1] -> {'flows_fw'[, 'flows_bw']},
        each 6 NHWC flows (B,h,w,2), finest first, float32.

        ``train=True`` turns level dropout on; it draws from ``generator``,
        which it then needs unless ``level_dropout`` is 0. The backward
        flows take their own draws after the forward ones."""
        if train and self.level_dropout > 0:
            if generator is None:
                raise ValueError("PWCLiteUflow(train=True) with level_dropout "
                                 "> 0 needs a torch.Generator")
        else:
            generator = None
        fp1 = self.feature_pyramid(to_nchw(img1))
        fp2 = self.feature_pyramid(to_nchw(img2))
        res = {"flows_fw": [to_nhwc(f) for f in self._f32(
            self.forward_2_frames(fp1, fp2, generator))]}
        if with_bk:
            res["flows_bw"] = [to_nhwc(f) for f in self._f32(
                self.forward_2_frames(fp2, fp1, generator))]
        return res
