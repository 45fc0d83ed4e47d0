"""Streaming (video) optical-flow serving (port of
``arflow_tpu/serving/engine.py``, the 2-frame ``uflow`` and ``uflow_prob``
families).

A stream of T frames needs T feature pyramids (K per frame for a
``uflow_prob`` model with ``n_pyramids`` K), not the 2(T-1) of running the
whole model per pair: each frame's pyramids are computed once, cached, and
the coarse-to-fine decoder runs on (pyramids of t-1, pyramids of t), the K
components in one batched pass. The pyramids and the decoder are the same
modules the monolithic forward runs. With a ``loss_cfg`` that has
``approx``, each push also returns the entropy map of that approximation.

PyTorch's CUDA calls are asynchronous: ``push`` enqueues the device work
and returns tensors on the device; reading them waits for the card.
"""

from __future__ import annotations

import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models.uflow import to_nchw
from arflow_tpu_torch.training.entropy import extract_uv_entropy

_NOT_PORTED = (
    "streaming for model type {!r} is not ported yet: ROADMAP.md queue 1, "
    "'serving' (the 3-frame PWC-Lite window)"
)


class StreamingFlowEngine:
    """Per-frame pyramid reuse for consecutive-pair flow on a video stream.

    model_cfg : the config's ``model`` section (``type`` "uflow" or
        "uflow_prob").
    state_dict : the model's weights (e.g. from ``uflow_state_dict_from_jax``
        or a reference checkpoint), loaded with ``strict=True``.
    with_bw : also return the backward flow (cur -> prev): one more decoder
        pass, no more pyramids.
    device : ``"cuda"`` unless asked otherwise; raises without a card.
    loss_cfg : the config's ``loss`` section; with ``approx``, each push
        also returns ``'entropy'`` (``extract_uv_entropy``, the ``mixture``
        approximation's draws from a generator seeded 0 per push).
    """

    def __init__(self, model_cfg, state_dict, with_bw: bool = False,
                 device="cuda", loss_cfg=None):
        if model_cfg.type not in ("uflow", "uflow_prob"):
            raise NotImplementedError(_NOT_PORTED.format(model_cfg.type))
        if model_cfg.get("mixture_weights"):
            raise ValueError(
                "mixture_weights inference is bidirectional over raw images "
                "(MixtureWeightsNet); use the monolithic forward.")
        self.device = resolve_device(device)
        self._model = get_model(model_cfg, device="cpu")
        self._model.load_state_dict(state_dict, strict=True)
        self._model.to(self.device)
        self._loss_cfg = loss_cfg if loss_cfg and "approx" in loss_cfg else None
        self._with_bw = with_bw
        self._prev = None
        self.pyramids_computed = 0  # frames whose pyramids were computed

    def reset(self):
        """Drop the cached pyramids (call at a video or scene boundary)."""
        self._prev = None

    def _flows(self, fps1, fps2) -> list:
        """The pair's outputs, NHWC views, finest first."""
        return [f.permute(0, 2, 3, 1) for f in self._model.decode(fps1, fps2)]

    @torch.inference_mode()
    def push(self, frame) -> dict | None:
        """Feed the next frame, (B,H,W,3) or (H,W,3) float32 in [0, 1].

        Returns None for the first frame after construction or ``reset``;
        then ``{'flow'}`` (B,H,W,2), the flow prev -> cur, with ``with_bw``
        also ``'flow_bw'`` (cur -> prev), and with an ``approx`` in
        ``loss_cfg`` also ``'entropy'`` (B,H,W,2) of the forward flow.
        """
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        if frame.dim() == 3:
            frame = frame[None]
        fp = self._model.feature_pyramids(to_nchw(frame))
        self.pyramids_computed += 1
        prev, self._prev = self._prev, fp
        if prev is None:
            return None
        flows = self._flows(prev, fp)
        out = {"flow": flows[0][..., :2].contiguous()}
        if self._loss_cfg is not None:
            out["entropy"] = extract_uv_entropy(
                flows, self._loss_cfg, {"flows_fw": flows},
                generator=torch.Generator(device=self.device).manual_seed(0))
        if self._with_bw:
            out["flow_bw"] = self._flows(fp, prev)[0][..., :2].contiguous()
        return out
