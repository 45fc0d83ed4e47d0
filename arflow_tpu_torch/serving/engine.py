"""Streaming (video) optical-flow serving (port of
``arflow_tpu/serving/engine.py``, the 2-frame ``uflow`` family).

A stream of T frames needs T feature pyramids, not the 2(T-1) of running
the whole model per pair: each frame's pyramid is computed once, cached, and
the coarse-to-fine decoder runs on (pyramid of t-1, pyramid of t). The
pyramid and the decoder are the same modules the monolithic ``PWCFlow``
forward runs.

PyTorch's CUDA calls are asynchronous: ``push`` enqueues the device work
and returns tensors on the device; reading them waits for the card.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models.uflow import to_nchw, to_nhwc

_NOT_PORTED = (
    "streaming for model type {!r} is not ported yet: ROADMAP.md queue 1, "
    "'serving' (entropy outputs and the 3-frame PWC-Lite window)"
)


class StreamingFlowEngine:
    """Per-frame pyramid reuse for consecutive-pair flow on a video stream.

    model_cfg : the config's ``model`` section (``type: "uflow"``).
    state_dict : the model's weights (e.g. from ``uflow_state_dict_from_jax``
        or a reference checkpoint), loaded with ``strict=True``.
    with_bw : also return the backward flow (cur -> prev): one more decoder
        pass, no more pyramids.
    device : ``"cuda"`` unless asked otherwise; raises without a card.
    """

    def __init__(self, model_cfg, state_dict, with_bw: bool = False,
                 device="cuda"):
        if model_cfg.type != "uflow":
            raise NotImplementedError(_NOT_PORTED.format(model_cfg.type))
        self.device = resolve_device(device)
        self._model = get_model(model_cfg, device="cpu")
        self._model.load_state_dict(state_dict, strict=True)
        self._model.to(self.device)
        self._with_bw = with_bw
        self._prev = None
        self.pyramids_computed = 0

    def reset(self):
        """Drop the cached pyramid (call at a video or scene boundary)."""
        self._prev = None

    @torch.inference_mode()
    def push(self, frame) -> dict | None:
        """Feed the next frame, (B,H,W,3) or (H,W,3) float32 in [0, 1].

        Returns None for the first frame after construction or ``reset``;
        then ``{'flow'}`` (B,H,W,2), the flow prev -> cur, and with
        ``with_bw`` also ``'flow_bw'`` (cur -> prev).
        """
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        if frame.dim() == 3:
            frame = frame[None]
        fp = self._model.feature_pyramid(to_nchw(frame))
        self.pyramids_computed += 1
        prev, self._prev = self._prev, fp
        if prev is None:
            return None
        out = {"flow": to_nhwc(self._model.forward_2_frames(prev, fp)[0])}
        if self._with_bw:
            out["flow_bw"] = to_nhwc(self._model.forward_2_frames(fp, prev)[0])
        return out
