"""PWCLite, the original ARFlow network (port of
``arflow_tpu/models/pwclite.py``).

A 6-level feature pyramid (channels 16, 32, 64, 96, 128, 192; two convs per
level, the first with stride 2), one flow estimator and one dilated context
network shared by all levels, a 1x1 adapter per level, and the cost volume
at search range 4. Decoding runs from the coarsest level (1/64) down to 1/4
resolution: at each level the flow so far is upsampled 2x (bilinear,
``align_corners=True``), the second frame's features are warped by it
(``flow_warp``), correlated with the first frame's, and the estimator and
context network add their residuals.

- 2 frames: flows finest first, [1/4 ... 1/64], with ``upsample`` a 4x
  upsample of the 1/4 flow in front (6 flows).
- 3 frames: the bidirectional fusion centred on the middle frame, both
  flows (1 -> 0 and 1 -> 2) on one pass; with ``upsample`` every level is
  upsampled 4x. Two cost volumes per level.
- 5 frames: the 3-frame windows (0, 1, 2), (1, 2, 3) and, with
  ``with_bk``, (2, 3, 4) in sequence.

Only the gates-off math is ported: none of the JAX package's TPU relayouts
(W-fold pyramid, bidirectional and window batching). Module and
``state_dict`` keys are the reference's (``feature_pyramid_extractor.convs``,
``flow_estimators``, ``context_networks.convs``, ``conv_1x1``), so its
checkpoints and ``arflow-torch-to-torch`` output load with ``strict=True``.

With ``dtype=torch.bfloat16`` the convs compute in bfloat16 from float32
parameters (``models/layers.py``), the pyramid casts the images on entry,
the cost volume takes its float32 round trip (``ops/cost_volume.py``), and
the flows are returned in float32.

Inside the network tensors are NCHW; ``forward`` takes and returns NHWC.

Under ``models/layers.py:rematerialized()`` (``train.remat``) each pyramid
level and each decode level of the 2-frame networks is a checkpointed
``remat_region``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from arflow_tpu_torch.models.layers import conv_block, leaky_relu, remat_region
from arflow_tpu_torch.ops import compute_cost_volume, flow_warp, resize_bilinear

# The published PWC-Lite widths (models/pwclite.py of the JAX package).
NUM_CHS = (3, 16, 32, 64, 96, 128, 192)
SEARCH_RANGE = 4
OUTPUT_LEVEL = 4  # decode levels 0 (1/64) .. 4 (1/4)
ADAPTER_CHANNELS = 32
CONTEXT_SPECS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
CORR_CHANNELS = (2 * SEARCH_RANGE + 1) ** 2


class FeatureExtractor(nn.Module):
    """Per level a stride-2 conv and ``convs_per_level - 1`` more, each with
    a leaky ReLU. Takes an NCHW image, cast to ``dtype`` where given (after
    the rescale to [-1, 1] with ``rescale``); returns the pyramid coarsest
    first. Its convs are pyramid convs that quantize only under
    ``ARFLOW_INT8_PYRAMID=1`` (``models/layers.py:int8_pyramid_enabled``):
    the family has no ``model.dtype: "int8"``, in the JAX package
    either."""

    def __init__(self, num_chs=NUM_CHS, convs_per_level: int = 2,
                 rescale: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.rescale = rescale
        self.compute_dtype = dtype
        self.convs = nn.ModuleList(
            nn.Sequential(*[conv_block(cin if j == 0 else cout, cout,
                                       stride=2 if j == 0 else 1, dtype=dtype,
                                       int8=False)
                            for j in range(convs_per_level)])
            for cin, cout in zip(num_chs[:-1], num_chs[1:]))

    def forward(self, x: torch.Tensor) -> list:
        if self.rescale:
            x = x * 2.0 - 1.0
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        pyramid = []
        for level in self.convs:
            x = remat_region(level, x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """Dense-net estimator: each conv sees its input and every output before
    it; returns (features, flow residual)."""

    def __init__(self, ch_in: int, ch_out: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c = ch_in
        for i, f in enumerate((128, 128, 96, 64, 32), start=1):
            setattr(self, f"conv{i}", conv_block(c, f, dtype=dtype))
            c += f
        self.feat_dim = c
        self.conv_last = conv_block(c, ch_out, relu=False, dtype=dtype)

    def forward(self, x):
        for i in range(1, 6):
            x = torch.cat([getattr(self, f"conv{i}")(x), x], dim=1)
        return x, self.conv_last(x)


class FlowEstimatorReduce(nn.Module):
    """Reduced estimator: each conv sees the two outputs before it; returns
    (features, flow residual)."""

    def __init__(self, ch_in: int, ch_out: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = conv_block(ch_in, 128, dtype=dtype)
        self.conv2 = conv_block(128, 128, dtype=dtype)
        self.conv3 = conv_block(128 + 128, 96, dtype=dtype)
        self.conv4 = conv_block(128 + 96, 64, dtype=dtype)
        self.conv5 = conv_block(96 + 64, 32, dtype=dtype)
        self.feat_dim = 32
        self.predict_flow = conv_block(64 + 32, ch_out, relu=False,
                                       dtype=dtype)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(torch.cat([x1, x2], dim=1))
        x4 = self.conv4(torch.cat([x2, x3], dim=1))
        x5 = self.conv5(torch.cat([x3, x4], dim=1))
        return x5, self.predict_flow(torch.cat([x4, x5], dim=1))


def correlate(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The family's correlation: the cost volume at ``SEARCH_RANGE``, then
    a leaky ReLU."""
    return leaky_relu(compute_cost_volume(x1, x2, SEARCH_RANGE))


def estimator(reduce_dense: bool, ch_in: int, ch_out: int, dtype):
    cls = FlowEstimatorReduce if reduce_dense else FlowEstimatorDense
    return cls(ch_in, ch_out, dtype)


class ContextNetwork(nn.Module):
    """Dilated refinement: ``CONTEXT_SPECS`` (channels, dilation) with leaky
    ReLUs, then a conv to ``ch_out``."""

    def __init__(self, ch_in: int, ch_out: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        layers = []
        for c, d in CONTEXT_SPECS:
            layers.append(conv_block(ch_in, c, dilation=d, dtype=dtype))
            ch_in = c
        layers.append(conv_block(ch_in, ch_out, relu=False, dtype=dtype))
        self.convs = nn.Sequential(*layers)

    def forward(self, x):
        return self.convs(x)


def upscale(x: torch.Tensor, factor: int, scale: float = 1.0,
            bias: float = 0.0, align_corners: bool = True) -> torch.Tensor:
    """``x * scale + bias`` resized ``factor``x, bilinear (the family's
    flow and log-variance upsampling)."""
    h, w = x.shape[-2], x.shape[-1]
    return resize_bilinear(x * scale + bias, (h * factor, w * factor),
                           align_corners=align_corners)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class PWCLite(nn.Module):
    """The PWC-Lite network for ``n_frames`` 2, or 3 and 5 (which share the
    3-frame weights)."""

    pyramid_module = "feature_pyramid_extractor"
    out_channels = 2

    def __init__(self, n_frames: int = 2, upsample: bool = True,
                 reduce_dense: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        if n_frames not in (2, 3, 5):
            raise ValueError(f"PWCLite n_frames {n_frames}: 2, 3 or 5")
        self.n_frames = n_frames
        self.upsample = upsample
        self.compute_dtype = dtype
        self.feature_pyramid_extractor = FeatureExtractor(dtype=dtype)
        oc = self.out_channels
        if n_frames == 2:
            ch_in = CORR_CHANNELS + ADAPTER_CHANNELS + oc
        else:  # the adapter, both correlations, both flows
            ch_in = ADAPTER_CHANNELS + 2 * CORR_CHANNELS + 2 * oc
        self.flow_estimators = estimator(reduce_dense, ch_in, oc, dtype)
        feat = self.flow_estimators.feat_dim
        ctx_in = feat + oc if n_frames == 2 else 2 * (feat + oc)
        self.context_networks = ContextNetwork(ctx_in, oc, dtype)
        self.conv_1x1 = nn.ModuleList(
            conv_block(c, ADAPTER_CHANNELS, kernel_size=1, dtype=dtype)
            for c in NUM_CHS[::-1][:OUTPUT_LEVEL + 1])

    def _f32(self, flows: list) -> list:
        if self.compute_dtype is None:
            return flows
        return [f.to(torch.float32) for f in flows]

    def feature_pyramid(self, img: torch.Tensor) -> list:
        """NCHW image in [0, 1] -> per-level NCHW features, coarsest
        first."""
        return self.feature_pyramid_extractor(img)

    def feature_pyramids(self, img: torch.Tensor) -> list:
        """``[feature_pyramid(img)]``, the streaming engine's form."""
        return [self.feature_pyramid(img)]

    def decode(self, fps1: list, fps2: list) -> list:
        """Both frames' ``feature_pyramids`` -> NCHW flows, finest first,
        float32 (the 2-frame network)."""
        return self._f32(self.forward_2_frames(fps1[0], fps2[0]))

    def decode3(self, fps0: list, fps1: list, fps2: list):
        """Three frames' ``feature_pyramids`` -> (flows 1 -> 0, flows
        1 -> 2), each NCHW, finest first, float32 (the 3-frame network)."""
        flows_10, flows_12 = self.forward_3_frames(fps0[0], fps1[0], fps2[0])
        return self._f32(flows_10), self._f32(flows_12)

    def _decode_level(self, level: int, x1, x2, flow):
        """One decode level: ``x2`` warped by the upsampled ``flow`` (but
        at the coarsest level), the correlation, and the estimator's and
        the context network's residuals added to ``flow``."""
        x2_warp = x2 if level == 0 else flow_warp(x2, flow)
        corr = correlate(x1, x2_warp)
        x1_1by1 = self.conv_1x1[level](x1)
        x_intm, flow_res = self.flow_estimators(
            torch.cat([corr, x1_1by1, flow], dim=1))
        flow = flow + flow_res
        return flow + self.context_networks(torch.cat([x_intm, flow], dim=1))

    def forward_2_frames(self, p1: list, p2: list) -> list:
        b, _, h, w = p1[0].shape
        flow = p1[0].new_zeros((b, 2, h, w))
        flows = []
        for level in range(OUTPUT_LEVEL + 1):
            if level:
                flow = upscale(flow, 2, scale=2.0)
            flow = remat_region(self._decode_level, level, p1[level],
                                p2[level], flow)
            flows.append(flow)
        if self.upsample:
            flows.append(upscale(flow, 4, scale=4.0))
        return flows[::-1]

    def forward_3_frames(self, p0: list, p1: list, p2: list):
        """Bidirectional fusion centred on frame 1: (flows 1 -> 0, flows
        1 -> 2), NCHW, finest first."""
        b, _, h, w = p1[0].shape
        flow = p1[0].new_zeros((b, 4, h, w))  # [flow_10, flow_12]
        flows = []
        for level in range(OUTPUT_LEVEL + 1):
            x0, x1, x2 = p0[level], p1[level], p2[level]
            if level == 0:
                x0_warp, x2_warp = x0, x2
            else:
                flow = upscale(flow, 2, scale=2.0)
                x0_warp = flow_warp(x0, flow[:, :2])
                x2_warp = flow_warp(x2, flow[:, 2:])
            corr_10 = correlate(x1, x0_warp)
            corr_12 = correlate(x1, x2_warp)
            x1_1by1 = self.conv_1x1[level](x1)
            f10, f12 = flow[:, :2], flow[:, 2:]
            xi_10, res_10 = self.flow_estimators(
                torch.cat([x1_1by1, corr_10, corr_12, f10, -f12], dim=1))
            xi_12, res_12 = self.flow_estimators(
                torch.cat([x1_1by1, corr_12, corr_10, f12, -f10], dim=1))
            flow = flow + torch.cat([res_10, res_12], dim=1)
            f10, f12 = flow[:, :2], flow[:, 2:]
            fine_10 = self.context_networks(
                torch.cat([xi_10, xi_12, f10, -f12], dim=1))
            fine_12 = self.context_networks(
                torch.cat([xi_12, xi_10, f12, -f10], dim=1))
            flow = flow + torch.cat([fine_10, fine_12], dim=1)
            flows.append(flow)
        if self.upsample:
            flows = [upscale(f, 4, scale=4.0) for f in flows]
        flows = flows[::-1]
        return [f[:, :2] for f in flows], [f[:, 2:] for f in flows]

    def _nhwc(self, flows: list) -> list:
        return [to_nhwc(f) for f in self._f32(flows)]

    def forward(self, *imgs: torch.Tensor, with_bk: bool = False,
                train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """Images NHWC (B,H,W,3) in [0, 1], 2 for the 2-frame network, 3 or
        5 for the 3-frame one -> {'flows_fw'[, 'flows_bw']}, NHWC flows
        (B,h,w,2) finest first, float32. 3 frames: 'flows_fw' 1 -> 2 and
        'flows_bw' 1 -> 0. 5 frames: 'flows_fw' [1 -> 2, 2 -> 3] and with
        ``with_bk`` 'flows_bw' [2 -> 1, 3 -> 2], each a list of levels.

        ``train`` and ``generator`` are taken, as the trainers pass them,
        and change nothing: the network has no dropout (the JAX model's
        ``train`` gates only a TPU relayout)."""
        n = len(imgs)
        if (n == 2) != (self.n_frames == 2) or n not in (2, 3, 5):
            raise ValueError(
                f"PWCLite(n_frames={self.n_frames}) takes "
                f"{'2' if self.n_frames == 2 else '3 or 5'} frames, got {n}")
        pyramids = [self.feature_pyramid(to_nchw(img)) for img in imgs]
        res = {}
        if n == 2:
            res["flows_fw"] = self._nhwc(self.forward_2_frames(*pyramids))
            if with_bk:
                res["flows_bw"] = self._nhwc(
                    self.forward_2_frames(pyramids[1], pyramids[0]))
        elif n == 3:
            flows_10, flows_12 = self.forward_3_frames(*pyramids)
            res["flows_fw"] = self._nhwc(flows_12)
            res["flows_bw"] = self._nhwc(flows_10)
        else:
            _, flows_12 = self.forward_3_frames(*pyramids[0:3])
            flows_21, flows_23 = self.forward_3_frames(*pyramids[1:4])
            res["flows_fw"] = [self._nhwc(flows_12), self._nhwc(flows_23)]
            if with_bk:
                flows_32, _ = self.forward_3_frames(*pyramids[2:5])
                res["flows_bw"] = [self._nhwc(flows_21), self._nhwc(flows_32)]
        return res
