"""PWCFlow, the UFlow PWC network (port of ``arflow_tpu/models/uflow.py``).

A 5-level feature pyramid; at each level from the coarsest to level 1 a
feature warp, feature normalization, the cost volume, a dense-net flow
decoder and a deconv for context; a dilated refinement stack at 1/4
resolution; two bilinear 2x upsamples back to full resolution. Returns 6
flows, finest first: [full, 1/2, 1/4 (refined), 1/8, 1/16, 1/32].

Only the gates-off math is ported: none of the JAX package's TPU relayouts
(W-fold pyramid, H-fold decoder, pyramid and bidirectional batching,
subpixel deconv, split decoder). Module and ``state_dict`` keys are the
reference's, so a checkpoint written by ``arflow-to-torch`` loads with
``strict=True``.

With ``train=True`` and ``level_dropout`` p > 0, whole levels drop out as in
the JAX package: one scalar draw ``keep = U[0,1) > p`` per call, on the
level's ``[context, flow]`` after each decoder and on the refinement, so 5
draws per ``forward_2_frames``. The draws come from the ``torch.Generator``
passed to ``forward``, never from a global one.

With ``dtype=torch.bfloat16`` the network computes in bfloat16 as the JAX
package's does: the parameters stay float32, every conv casts its weight,
bias and input (``models/layers.py``), the pyramid casts the images on
entry, the warps, feature normalization and upsamples run on bfloat16
tensors, the cost volume takes a float32 round trip
(``ops/cost_volume.py``), and the flows are cast back to float32.

With ``int8_pyramid=True`` (``model.dtype: "int8"``, serving only) the
pyramid's convs compute ``models/layers.py:quantized_conv2d`` and hand on
``dtype``, as the JAX package's do; ``ARFLOW_INT8_PYRAMID=0/1`` overrides
that both ways.

Inside the network tensors are NCHW; ``forward`` takes and returns NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from arflow_tpu_torch.models.layers import (
    LEAKY_ALPHA,
    conv2d,
    conv_transpose2d,
    leaky_relu,
    remat_region,
)
from arflow_tpu_torch.ops import (
    compute_cost_volume,
    flow_to_warp,
    normalize_features,
    resample,
    upsample,
)

# The published UFlow widths (models/uflow.py of the JAX package).
NUM_LEVELS = 5
PYRAMID_FILTERS = ((3, 32),) * NUM_LEVELS  # per level (num_convs, channels)
FLOW_DECODER_FILTERS = (128, 128, 96, 64, 32)
REFINEMENT_FILTERS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
CONTEXT_CHANNELS = 32
MAX_DISPLACEMENT = 4

class PWCFeaturePyramid(nn.Module):
    """``PYRAMID_FILTERS`` convs per level; each level's first conv has
    stride 2. Input in [0, 1] is cast to ``dtype`` (where given) and
    rescaled to [-1, 1]. With ``int8`` the convs quantize
    (``models/layers.py:int8_pyramid_enabled``)."""

    def __init__(self, dtype: torch.dtype | None = None, int8: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self._convs = nn.ModuleList()
        c = 3
        for num_layers, num_filters in PYRAMID_FILTERS:
            level = nn.ModuleList()
            for i in range(num_layers):
                level.append(conv2d(c, num_filters, 3, stride=2 if i == 0 else 1,
                                    dtype=dtype, int8=int8))
                c = num_filters
            self._convs.append(level)

    def forward(self, x: torch.Tensor) -> list:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x * 2.0 - 1.0
        features = []
        for level in self._convs:
            x = remat_region(_conv_stack, level, x)
            features.append(x)
        return features


def _conv_stack(convs, x: torch.Tensor) -> torch.Tensor:
    for conv in convs:
        x = leaky_relu(conv(x))
    return x


class PWCFlow(nn.Module):
    """UFlow PWC optical-flow network."""

    pyramid_module = "_feature_pyramid_extractor"

    def __init__(self, feature_norm: bool = True, level_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, int8_pyramid: bool = False):
        super().__init__()
        self.feature_norm = feature_norm
        self.level_dropout = level_dropout
        self.compute_dtype = dtype
        self._feature_pyramid_extractor = PWCFeaturePyramid(dtype, int8_pyramid)

        feat = PYRAMID_FILTERS[-1][1]
        cv = (2 * MAX_DISPLACEMENT + 1) ** 2
        ctx = FLOW_DECODER_FILTERS[-1]
        # Level 0 never estimates flow: an empty entry keeps the reference's
        # _flow_layers.{level} indices.
        self._flow_layers = nn.ModuleList([nn.ModuleList()])
        for level in range(1, NUM_LEVELS):
            cin = cv + feat
            if level < NUM_LEVELS - 1:
                cin += CONTEXT_CHANNELS + 2  # context_up, flow_up
            layers = nn.ModuleList()
            for c in FLOW_DECODER_FILTERS:
                layers.append(nn.Sequential(conv2d(cin, c, dtype=dtype),
                                            nn.LeakyReLU(LEAKY_ALPHA)))
                cin += c
            layers.append(conv2d(ctx, 2, dtype=dtype))
            self._flow_layers.append(layers)

        # The reference builds a context deconv for every level, 0 included,
        # and never applies level 0's.
        self._context_up_layers = nn.ModuleList(
            conv_transpose2d(ctx, CONTEXT_CHANNELS, dtype=dtype)
            for _ in range(NUM_LEVELS))

        refine = []
        cin = ctx + 2
        for c, d in REFINEMENT_FILTERS:
            refine += [conv2d(cin, c, 3, dilation=d, dtype=dtype),
                       nn.LeakyReLU(LEAKY_ALPHA)]
            cin = c
        refine.append(conv2d(cin, 2, dtype=dtype))
        self._refine_model = nn.Sequential(*refine)

    def feature_pyramid(self, img: torch.Tensor) -> list:
        """NCHW image in [0, 1] -> per-level NCHW features, finest first."""
        return self._feature_pyramid_extractor(img)

    def feature_pyramids(self, img: torch.Tensor) -> list:
        """``[feature_pyramid(img)]``: the one pyramid, in the list form of
        ``PWCProbFlow.feature_pyramids``."""
        return [self.feature_pyramid(img)]

    def decode(self, fps1: list, fps2: list) -> list:
        """Both frames' ``feature_pyramids`` -> NCHW flows, finest first."""
        return self.forward_2_frames(fps1[0], fps2[0])

    def forward_2_frames(self, fp1: list, fp2: list, generator=None) -> list:
        """Coarse-to-fine flow between two feature pyramids; NCHW flows,
        float32. With ``generator``, level dropout draws from it
        (training)."""
        flow = flow_up = context = context_up = None
        flows = []
        for level in range(NUM_LEVELS - 1, 0, -1):
            context, flow = remat_region(self._estimate, level, fp1[level],
                                         fp2[level], flow_up, context_up)
            context, flow = level_dropout([context, flow], self.level_dropout,
                                          generator)

            if flow_up is not None:
                flow = flow + flow_up
            flow_up = upsample(flow, is_flow=True)
            context_up = self._context_up_layers[level](context)
            flows.insert(0, flow)

        refinement = remat_region(self._refine_model,
                                  torch.cat([context, flow], dim=1))
        (refinement,) = level_dropout([refinement], self.level_dropout,
                                      generator)
        flows[0] = flow + refinement
        flows.insert(0, upsample(flows[0], is_flow=True))
        flows.insert(0, upsample(flows[0], is_flow=True))
        if self.compute_dtype is not None:
            flows = [f.to(torch.float32) for f in flows]
        return flows

    def _estimate(self, level, features1, features2, flow_up, context_up):
        """One level's (context, flow) before dropout: the feature warp by
        ``flow_up`` (none at the coarsest level), feature normalization,
        the cost volume and the dense-net decoder."""
        if flow_up is None:
            warped2 = features2
        else:
            warped2 = resample(features2, flow_to_warp(flow_up))

        f1n, w2n = features1, warped2
        if self.feature_norm:
            f1n, w2n = normalize_features(features1, warped2)
        cost_volume = leaky_relu(
            compute_cost_volume(f1n, w2n, MAX_DISPLACEMENT))

        if flow_up is None:
            x = torch.cat([cost_volume, features1], dim=1)
        else:
            x = torch.cat([context_up, flow_up, cost_volume, features1], dim=1)
        # Dense-net connections: each hidden conv sees all before it.
        hidden = self._flow_layers[level][:-1]
        for i, layer in enumerate(hidden):
            context = layer(x)
            if i + 1 < len(hidden):
                x = torch.cat([x, context], dim=1)
        return context, self._flow_layers[level][-1](context)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                with_bk: bool = True, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """Images NHWC (B,H,W,3) in [0, 1] -> {'flows_fw'[, 'flows_bw']},
        each 6 NHWC flows (B,h,w,2), finest first.

        ``train=True`` turns level dropout on; it draws from ``generator``,
        which it then needs unless ``level_dropout`` is 0. The backward
        flows take their own draws after the forward ones."""
        if train and self.level_dropout > 0:
            if generator is None:
                raise ValueError("PWCFlow(train=True) with level_dropout > 0 "
                                 "needs a torch.Generator")
        else:
            generator = None
        fp1 = self.feature_pyramid(to_nchw(img1))
        fp2 = self.feature_pyramid(to_nchw(img2))
        res = {"flows_fw": [to_nhwc(f) for f in
                            self.forward_2_frames(fp1, fp2, generator)]}
        if with_bk:
            res["flows_bw"] = [to_nhwc(f) for f in
                               self.forward_2_frames(fp2, fp1, generator)]
        return res


def level_dropout(tensors, p: float, generator, num_groups: int = 1):
    """Multiply each of ``num_groups`` equal batch groups of all
    ``tensors`` by its own draw ``U[0,1) > p`` from ``generator`` (a whole
    level kept or dropped); the tensors as they are without a generator
    (not training)."""
    if generator is None:
        return tensors
    u = torch.rand((num_groups,), generator=generator, device=generator.device)
    keep = (u > p).to(tensors[0]).repeat_interleave(tensors[0].shape[0] // num_groups)
    return [t * keep.view(-1, 1, 1, 1) for t in tensors]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()
