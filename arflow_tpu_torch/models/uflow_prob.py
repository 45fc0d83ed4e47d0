"""Probabilistic UFlow: ``PWCProbFlow`` and ``ComponentNet`` (port of
``arflow_tpu/models/uflow_prob.py``, the eval forward).

``PWCProbFlow`` is ``PWCFlow`` with grouped output channels
``out_channels = [L, M, N]``: L flow channels, propagated and warped; M
log-diagonal channels, propagated with a bias of +-log 2 per upsample (-
with ``inv_cov``); N extras (off-diagonal bands, low-rank columns) that only
level 1 and the refinement output. Level 1's output conv has L+M+N
channels, the coarser ones L+M. With ``n_pyramids`` K > 1, K feature
pyramids share one decoder and their outputs are concatenated groupwise:
[K x L means, K x M log-diagonals, K x N extras].

``ComponentNet`` is two ``PWCProbFlow((2, 2, 0))`` nets whose outputs form a
2-component mixture.

With ``mixture_weights`` either model adds ``MixtureWeightsNet``: a
ResNet-18-shaped classifier over per-pixel census and smoothness maps of
the level-2 means that predicts per-image component weights,
``res["weights_fw"]`` from (fw, bw, img1, img2) and ``res["weights_bw"]``
from (bw, fw, img2, img1), in that order. It reads both directions, so
``with_bk=False`` raises. Its BatchNorm follows the forward's ``train=``
as flax's ``use_running_average=not train`` does, with flax's statistics
(``FlaxBatchNorm2d``).

Only the gates-off math is ported: none of the JAX package's TPU relayouts
(H-fold decoder, split decoder, subpixel deconv, refinement fold). The K
components and both directions ride the batch axis through one decoder
pass, which keeps each sample's math. ``forward(train=True)`` turns level
dropout on: at each level and at the refinement, each (component,
direction) group of that pass draws its own whole-level keep from the
``generator``, as the JAX model's ``num_groups`` draws do. Module and
``state_dict`` keys are the reference's.

``dtype=torch.bfloat16`` runs the flow network in bfloat16 as ``PWCFlow``
does (``models/uflow.py``), its outputs cast back to float32 after the
log-diagonal clamp; ``ComponentNet`` passes it to both nets, and
``MixtureWeightsNet`` stays float32, as in the JAX package.

Inside the network tensors are NCHW; ``forward`` takes and returns NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from arflow_tpu_torch.models.layers import (
    LEAKY_ALPHA,
    conv2d,
    conv_transpose2d,
    leaky_relu,
    remat_region,
)
from arflow_tpu_torch.models.uflow import (
    CONTEXT_CHANNELS,
    FLOW_DECODER_FILTERS,
    MAX_DISPLACEMENT,
    NUM_LEVELS,
    PYRAMID_FILTERS,
    REFINEMENT_FILTERS,
    PWCFeaturePyramid,
    level_dropout,
    to_nchw,
    to_nhwc,
)
from arflow_tpu_torch.ops import (
    compute_cost_volume,
    downsample,
    flow_to_warp,
    normalize_features,
    resample,
    upsample,
)

RESNET_LEAKY_ALPHA = 0.01
MIXTURE_NEEDS_BK = ("mixture_weights needs with_bk=True: MixtureWeightsNet "
                    "reads the backward flows (the JAX model raises a KeyError "
                    "there)")


def _pad_channels(x: torch.Tensor, channels: int) -> torch.Tensor:
    """Zero channels appended up to ``channels`` (NCHW)."""
    return F.pad(x, (0, 0, 0, 0, 0, channels - x.shape[1]))


class PWCProbFlow(nn.Module):
    """UFlow PWC network with grouped probabilistic outputs."""

    def __init__(self, out_channels=(2, 2, 0), inv_cov: bool = False,
                 n_pyramids: int = 1, feature_norm: bool = True,
                 level_dropout: float = 0.0, mixture_weights: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.out_channels = tuple(int(c) for c in out_channels)
        self.inv_cov = inv_cov
        self.n_pyramids = n_pyramids
        self.feature_norm = feature_norm
        self.level_dropout = level_dropout
        self.diag_bias = -math.log(2) if inv_cov else math.log(2)
        l_ch, m_ch, n_ch = self.out_channels
        self._feature_pyramid_extractor = nn.ModuleList(
            PWCFeaturePyramid(dtype) for _ in range(n_pyramids))

        # Every level sees [context_up, out_up (L+M), one cost volume per
        # flow pair, features1]; the coarsest one zeros and the log-diagonal
        # start for the first two.
        cin0 = (CONTEXT_CHANNELS + l_ch + m_ch
                + (l_ch // 2) * (2 * MAX_DISPLACEMENT + 1) ** 2
                + PYRAMID_FILTERS[-1][1])
        ctx = FLOW_DECODER_FILTERS[-1]
        self._flow_layers = nn.ModuleList([nn.ModuleList()])
        for level in range(1, NUM_LEVELS):
            cin = cin0
            layers = nn.ModuleList()
            for c in FLOW_DECODER_FILTERS:
                layers.append(nn.Sequential(conv2d(cin, c, dtype=dtype),
                                            nn.LeakyReLU(LEAKY_ALPHA)))
                cin += c
            out = sum(self.out_channels) if level == 1 else l_ch + m_ch
            layers.append(conv2d(ctx, out, dtype=dtype))
            self._flow_layers.append(layers)
        # As in PWCFlow, level 0's deconv is built and never applied.
        self._context_up_layers = nn.ModuleList(
            conv_transpose2d(ctx, CONTEXT_CHANNELS, dtype=dtype)
            for _ in range(NUM_LEVELS))

        refine = []
        cin = ctx + sum(self.out_channels)
        for c, d in REFINEMENT_FILTERS:
            refine += [conv2d(cin, c, 3, dilation=d, dtype=dtype),
                       nn.LeakyReLU(LEAKY_ALPHA)]
            cin = c
        refine.append(conv2d(cin, sum(self.out_channels), dtype=dtype))
        self._refine_model = nn.Sequential(*refine)
        self.mixture_weights = mixture_weights
        if mixture_weights:
            self._mixture_weights_net = MixtureWeightsNet(l_ch // 2, n_pyramids)

    def feature_pyramids(self, img: torch.Tensor) -> list:
        """NCHW image in [0, 1] -> one per-level feature list per pyramid."""
        return [p(img) for p in self._feature_pyramid_extractor]

    def upsample_out(self, out: torch.Tensor) -> torch.Tensor:
        """Groupwise 2x upsample: the flows scaled, the log-diagonal biased
        by ``diag_bias`` first, the extras (where present) as they are."""
        l_ch, m_ch, n_ch = self.out_channels
        pieces = [upsample(out[:, :l_ch], is_flow=True)]
        if m_ch > 0:
            pieces.append(upsample(out[:, l_ch:l_ch + m_ch] + self.diag_bias,
                                   is_flow=False))
        if n_ch > 0 and out.shape[1] > l_ch + m_ch:
            pieces.append(upsample(out[:, l_ch + m_ch:], is_flow=False))
        return torch.cat(pieces, dim=1)

    def forward_2_frames(self, fp1: list, fp2: list, generator=None,
                         num_groups: int = 1) -> list:
        """Coarse-to-fine outputs between two feature pyramids, NCHW,
        float32, finest first: [full, 1/2, 1/4 (refined, clamped), 1/8,
        1/16, 1/32]. With
        ``generator``, level dropout draws from it, one keep per each of
        the batch's ``num_groups`` groups at each level and the refinement."""
        l_ch, m_ch, _ = self.out_channels
        out_up = context_up = None
        outs = []
        for level in range(NUM_LEVELS - 1, 0, -1):
            features1, features2 = fp1[level], fp2[level]
            first = out_up is None
            if first:
                b, _, h, w = features1.shape
                out_up = torch.cat([
                    features1.new_zeros((b, l_ch, h, w)),
                    features1.new_full((b, m_ch, h, w),
                                       -(NUM_LEVELS - 3) * self.diag_bias)], dim=1)
                context_up = features1.new_zeros((b, CONTEXT_CHANNELS, h, w))

            context, out = remat_region(self._estimate, level, first,
                                        features1, features2, out_up,
                                        context_up)
            context, out = level_dropout([context, out], self.level_dropout,
                                         generator, num_groups)
            # Level 1 adds the N extras: the propagated groups get zeros.
            out = out + _pad_channels(out_up, out.shape[1])
            outs.insert(0, out)
            if level > 1:
                out_up = self.upsample_out(out)
                context_up = self._context_up_layers[level](context)

        # Level 1's output already holds all L+M+N channels.
        (refinement,) = level_dropout(
            [remat_region(self._refine_model, torch.cat([context, out], dim=1))],
            self.level_dropout, generator, num_groups)
        refined = out + refinement
        log_diag = refined[:, l_ch:l_ch + m_ch]
        log_diag = (log_diag.clamp_min(-5.0) if self.inv_cov
                    else log_diag.clamp(-10.0, 10.0))
        outs[0] = torch.cat([refined[:, :l_ch], log_diag,
                             refined[:, l_ch + m_ch:]], dim=1)
        outs.insert(0, self.upsample_out(outs[0]))
        outs.insert(0, self.upsample_out(outs[0]))
        if self.compute_dtype is not None:
            outs = [o.to(torch.float32) for o in outs]
        return outs

    def _estimate(self, level, first, features1, features2, out_up,
                  context_up):
        """One level's (context, out) before dropout: one cost volume per
        flow pair of ``out_up`` (the first level's flow is zero, and warping
        by zero is the identity) and the dense-net decoder."""
        costs = []
        for k in range(self.out_channels[0] // 2):
            warped2 = (features2 if first else
                       resample(features2, flow_to_warp(out_up[:, 2 * k:2 * k + 2])))
            f1n, w2n = features1, warped2
            if self.feature_norm:
                f1n, w2n = normalize_features(features1, warped2)
            costs.append(leaky_relu(
                compute_cost_volume(f1n, w2n, MAX_DISPLACEMENT)))

        x = torch.cat([context_up, out_up, *costs, features1], dim=1)
        hidden = self._flow_layers[level][:-1]
        for i, layer in enumerate(hidden):
            context = layer(x)
            if i + 1 < len(hidden):
                x = torch.cat([x, context], dim=1)
        return context, self._flow_layers[level][-1](context)

    def flows_cat(self, groups: list) -> list:
        """Per-pyramid output lists -> one list, concatenated groupwise."""
        if len(groups) == 1:
            return groups[0]
        l_ch, m_ch, _ = self.out_channels
        out = []
        for level in zip(*groups):
            pieces = [torch.cat([f[:, :l_ch] for f in level], dim=1),
                      torch.cat([f[:, l_ch:l_ch + m_ch] for f in level], dim=1)]
            if level[0].shape[1] > l_ch + m_ch:
                pieces.append(torch.cat([f[:, l_ch + m_ch:] for f in level], dim=1))
            out.append(torch.cat(pieces, dim=1))
        return out

    def _decode_groups(self, srcs: list, tgts: list, generator=None) -> list:
        """Pyramid pairs (one per component and direction) -> each pair's
        outputs, from one decoder pass with the pairs on the batch axis;
        with ``generator``, each pair is a level-dropout group."""
        nb = srcs[0][0].shape[0]
        fa = [torch.cat(p, dim=0) for p in zip(*srcs)]
        fb = [torch.cat(p, dim=0) for p in zip(*tgts)]
        outs = self.forward_2_frames(fa, fb, generator, num_groups=len(srcs))
        return [[o[i * nb:(i + 1) * nb] for o in outs] for i in range(len(srcs))]

    def decode(self, fps1: list, fps2: list) -> list:
        """Both frames' pyramids (``feature_pyramids``) -> the outputs,
        NCHW, concatenated groupwise over the pyramids."""
        return self.flows_cat(self._decode_groups(fps1, fps2))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                with_bk: bool = True, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """Images NHWC (B,H,W,3) in [0, 1] -> {'flows_fw'[, 'flows_bw']},
        each 6 NHWC outputs, finest first; with ``mixture_weights`` also
        'weights_fw' and 'weights_bw', (B, K) each.

        ``train=True`` turns level dropout on; it draws from ``generator``,
        which it then needs unless ``level_dropout`` is 0: at each of the 4
        levels and the refinement, one draw per (component, direction).
        It also puts the mixture weights net's BatchNorm in training mode."""
        if self.mixture_weights and not with_bk:
            raise ValueError(MIXTURE_NEEDS_BK)
        if train and self.level_dropout > 0:
            if generator is None:
                raise ValueError("PWCProbFlow(train=True) with level_dropout "
                                 "> 0 needs a torch.Generator")
        else:
            generator = None
        nb = img1.shape[0]
        fps = self.feature_pyramids(torch.cat([to_nchw(img1), to_nchw(img2)]))
        fp1 = [[f[:nb] for f in fp] for fp in fps]
        fp2 = [[f[nb:] for f in fp] for fp in fps]
        k = self.n_pyramids
        if with_bk:
            groups = self._decode_groups(fp1 + fp2, fp2 + fp1, generator)
            res = {"flows_fw": self.flows_cat(groups[:k]),
                   "flows_bw": self.flows_cat(groups[k:])}
        else:
            res = {"flows_fw": self.flows_cat(
                self._decode_groups(fp1, fp2, generator))}
        res = {key: [to_nhwc(f) for f in flows] for key, flows in res.items()}
        if self.mixture_weights:
            add_mixture_weights(self._mixture_weights_net, res,
                                self.out_channels[0] * k, img1, img2, train)
        return res


class ComponentNet(nn.Module):
    """Two ``PWCProbFlow((2, 2, 0))`` nets -> a 2-component mixture: per
    level [mean 1, mean 2, log-diagonal 1, log-diagonal 2]."""

    def __init__(self, inv_cov: bool = False, feature_norm: bool = True,
                 level_dropout: float = 0.0, out_channels=(2, 2, 0),
                 n_pyramids: int = 1, mixture_weights: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        kwargs = dict(out_channels=(2, 2, 0), inv_cov=inv_cov,
                      feature_norm=feature_norm, level_dropout=level_dropout,
                      dtype=dtype)
        self.pwcnet1 = PWCProbFlow(**kwargs)
        self.pwcnet2 = PWCProbFlow(**kwargs)
        # As in the JAX model, ``out_channels`` and ``n_pyramids`` size only
        # the weights net (K = out_channels[0] // 2 * n_pyramids) and how
        # many mean channels of level 2 it reads; the two nets are fixed.
        self.mixture_weights = mixture_weights
        self._means = int(out_channels[0]) * n_pyramids
        if mixture_weights:
            self.mixture_weights_net = MixtureWeightsNet(
                int(out_channels[0]) // 2, n_pyramids)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                with_bk: bool = True, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """As ``PWCProbFlow.forward``; the second net draws its level
        dropout after the first."""
        if self.mixture_weights and not with_bk:
            raise ValueError(MIXTURE_NEEDS_BK)
        res1 = self.pwcnet1(img1, img2, with_bk=with_bk, train=train,
                            generator=generator)
        res2 = self.pwcnet2(img1, img2, with_bk=with_bk, train=train,
                            generator=generator)
        res = {key: [torch.cat([a[..., 0:2], b[..., 0:2], a[..., 2:4],
                                b[..., 2:4]], dim=-1)
                     for a, b in zip(res1[key], res2[key])]
               for key in res1}
        if self.mixture_weights:
            add_mixture_weights(self.mixture_weights_net, res, self._means,
                                img1, img2, train)
        return res


def add_mixture_weights(net, res: dict, means: int, img1, img2, train: bool):
    """``res["weights_fw"]`` from the first ``means`` channels of both
    directions' level-2 outputs and (img1, img2), then ``res["weights_bw"]``
    with the directions and images swapped: the JAX model's order, in which
    the BatchNorm's running statistics update."""
    mean12_2 = res["flows_fw"][2][..., :means]
    mean21_2 = res["flows_bw"][2][..., :means]
    res["weights_fw"] = net(mean12_2, mean21_2, img1, img2, train=train)
    res["weights_bw"] = net(mean21_2, mean12_2, img2, img1, train=train)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``flax.linen.BatchNorm(momentum=0.9)`` over NCHW channels, with the
    ``nn.BatchNorm2d`` parameters and buffers (the reference's keys).

    The mode is the ``train`` argument, not ``nn.Module.training``. In
    training it normalizes with the batch's mean and biased variance, and
    updates ``running_mean`` / ``running_var`` by 0.9 old + 0.1 batch with
    the *biased* variance, as flax does (``nn.BatchNorm2d`` takes the
    unbiased one there, n/(n-1) larger); otherwise it normalizes with the
    running statistics. ``num_batches_tracked`` counts as in torch and is
    read by nothing."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def conv_bn(pair: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A (conv, ``FlaxBatchNorm2d``) pair applied in ``train`` mode."""
    return pair[1](pair[0](x), train)


class ResidualBlock(nn.Module):
    """Conv-BN-leaky ReLU, conv-BN, plus the input (a strided 1x1 conv and
    BN where the shape changes), leaky ReLU 0.01."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(cin, features, 3, stride=stride, padding=1, bias=False),
            FlaxBatchNorm2d(features))
        self.conv2 = nn.Sequential(
            nn.Conv2d(features, features, 3, padding=1, bias=False),
            FlaxBatchNorm2d(features))
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, features, 1, stride=stride),
                FlaxBatchNorm2d(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.leaky_relu(conv_bn(self.conv1, x, train), RESNET_LEAKY_ALPHA)
        y = conv_bn(self.conv2, y, train)
        residual = x if self.downsample is None else conv_bn(self.downsample, x, train)
        return F.leaky_relu(y + residual, RESNET_LEAKY_ALPHA)


class ResNet(nn.Module):
    """ResNet-18-shaped classifier, NCHW in: a 7x7 stride-2 stem with BN and
    leaky ReLU, a 3x3 stride-2 max pool, four stages of ``layers`` residual
    blocks (64, 128, 256, 512 channels; stride 1, 2, 2, 2), the spatial
    mean and ``fc``."""

    def __init__(self, cin: int, num_classes: int, layers=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(cin, 64, 7, stride=2, padding=3, bias=False),
            FlaxBatchNorm2d(64))
        cin = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            setattr(self, f"layer{stage}", nn.ModuleList(
                ResidualBlock(cin if blk == 0 else planes, planes,
                              stride if blk == 0 else 1)
                for blk in range(blocks)))
            cin = planes
        self.num_stages = len(layers)
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.leaky_relu(conv_bn(self.conv1, x, train), RESNET_LEAKY_ALPHA)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return self.fc(x.mean(dim=(2, 3)))


class MixtureWeightsNet(nn.Module):
    """Per-image mixture weights (B, K), K = ``n_flows * n_pyramids``, from
    per-pixel loss maps of the K level-2 flows of each direction.

    Each flow pair becomes a batch entry, batch-major (image b's K flows
    side by side), with its images repeated to match; the census data loss
    and its weight (occlusion 'none', downsampled 4x to level 2) and the
    edge-aware smoothness terms (zero-padded back to the level-2 size)
    stack as 8 channels per flow into the ResNet, and a softmax over its K
    outputs gives the weights. Both are the JAX package's documented fixes
    of the reference: the first two of ``data_loss_no_penalty``'s four
    return values, and the batch-major pairing. Nothing is detached beyond
    what those blocks detach, so the gradient reaches the flow network
    through the flows."""

    def __init__(self, n_flows: int = 1, n_pyramids: int = 1):
        super().__init__()
        self.k = n_flows * n_pyramids
        self.resnet = ResNet(8 * self.k, self.k)

    def forward(self, flow12_2, flow21_2, im1_0, im2_0, train: bool = False):
        """Level-2 flows NHWC (B, h, w, 2K), images NHWC (B, H, W, 3)."""
        from arflow_tpu_torch.losses.blocks import (
            data_loss_no_penalty,
            smooth_loss_no_penalty,
        )
        k = self.k
        b, h, w, _ = flow12_2.shape

        def as_batch(f):  # (B, h, w, 2K) -> (B*K, h, w, 2), batch-major
            return f.reshape(b, h, w, k, 2).permute(0, 3, 1, 2, 4).reshape(
                b * k, h, w, 2)

        f12, f21 = as_batch(flow12_2), as_batch(flow21_2)
        im1 = im1_0.repeat_interleave(k, dim=0)
        im2 = im2_0.repeat_interleave(k, dim=0)
        data_loss, data_weight, _, _ = data_loss_no_penalty(
            im1, im2, f12, f21, "none", ["census"])
        data_loss, data_weight = (
            downsample(to_nchw(t[0]), is_flow=False, scale_factor=4)
            for t in (data_loss, data_weight))
        s_x, w_x, s_y, w_y = (to_nchw(t) for t in smooth_loss_no_penalty(
            im1, f12, 150.0, edge_asymp=0.01))
        s_x, w_x = F.pad(s_x, (1, 0)), F.pad(w_x, (1, 0))
        s_y, w_y = F.pad(s_y, (0, 0, 1, 0)), F.pad(w_y, (0, 0, 1, 0))

        def as_channels(t):  # (B*K, ch, h, w) -> (B, K*ch, h, w)
            return t.reshape(b, k * t.shape[1], h, w)

        x = torch.cat([as_channels(t) for t in
                       (data_loss, data_weight, s_x, s_y, w_x, w_y)], dim=1)
        return torch.softmax(self.resnet(x, train=train), dim=-1)
