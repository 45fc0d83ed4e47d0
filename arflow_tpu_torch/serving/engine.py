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

``run_stream`` drives an engine (or a loaded streaming artifact,
``serving/export.py``) over an ordered list of frame files, decoding them
on a prefetch thread and writing one ``.flo`` per flow.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device

_NOT_PORTED = (
    "streaming for model type {!r} is not ported yet: ROADMAP.md queue 1, "
    "'serving' (the 3-frame PWC-Lite window)"
)
# The JAX engine has no streaming for ComponentNet either: two nets, each
# with its own pyramid, and no pyramid attribute to split at.
COMPONENT_NOT_STREAMED = (
    "streaming is not available for model type 'component' (two "
    "PWCProbFlow nets, each with its own pyramid), in this package as in the "
    "JAX one: use the monolithic forward or its export")


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
        from arflow_tpu_torch.models import get_model

        if model_cfg.type == "component":
            raise NotImplementedError(COMPONENT_NOT_STREAMED)
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
        fp = self._model.feature_pyramids(
            frame.permute(0, 3, 1, 2).contiguous())
        self.pyramids_computed += 1
        prev, self._prev = self._prev, fp
        if prev is None:
            return None
        flows = self._flows(prev, fp)
        out = {"flow": flows[0][..., :2].contiguous()}
        if self._loss_cfg is not None:
            from arflow_tpu_torch.training.entropy import extract_uv_entropy

            out["entropy"] = extract_uv_entropy(
                flows, self._loss_cfg, {"flows_fw": flows},
                generator=torch.Generator(device=self.device).manual_seed(0))
        if self._with_bw:
            out["flow_bw"] = self._flows(fp, prev)[0][..., :2].contiguous()
        return out


def _decode_frame(path, size_hw):
    """PNG, PPM or JPEG -> (H,W,3) float32 in [0, 1], resized with PIL's
    bilinear filter to ``size_hw`` where given and different (the JAX
    package's path without its native decoder)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size_hw is not None and (im.height, im.width) != tuple(size_hw):
            im = im.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.float32) / 255.0


def run_stream(engine, paths, *, size_hw=None, out_root: str | None = None,
               prefetch: int = 4, warmup: int = 2) -> dict:
    """Push the frames at ``paths``, in order, through ``engine``
    (``StreamingFlowEngine`` or ``StreamingArtifact``), decoding them on a
    thread that keeps at most ``prefetch`` frames ahead.

    With ``out_root``, writes ``<out_root>/<stem>.flo`` for each flow (the
    pair (t-1, t) named after frame t) and ``<stem>_bw.flo`` for a backward
    flow; one result is held in flight, so its copy to the host overlaps
    the next frame's device work. Without it no flow field is copied to the
    host.

    Returns ``{'frames', 'flows', 'elapsed_s', 'steady_flows',
    'flows_per_sec'}``: the rate over the flows after the first ``warmup``
    (first-call costs), its clock started and stopped on a scalar read of
    the newest flow, which waits for all earlier device work; the overall
    rate where the stream is no longer than ``warmup``. Also
    ``'queue_wait_s'``, the loop's time blocked on the decode queue, and
    ``'decode_s'``, the decode thread's time in ``_decode_frame``.
    """
    from arflow_tpu_torch.utils.flow_io import write_flo

    paths = list(paths)
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    decode_s = [0.0]

    def producer():
        try:
            for p in paths:
                t = time.perf_counter()
                frame = _decode_frame(p, size_hw)
                decode_s[0] += time.perf_counter() - t
                q.put((p, frame))
        except Exception as e:  # raised again by the loop below
            q.put(e)
            return
        q.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    def drain(item):
        if out_root is None:
            return
        path, out = item
        os.makedirs(out_root, exist_ok=True)
        stem = os.path.join(out_root,
                            os.path.splitext(os.path.basename(path))[0])
        write_flo(stem + ".flo", out["flow"][0].cpu().numpy())
        if "flow_bw" in out:
            write_flo(stem + "_bw.flo", out["flow_bw"][0].cpu().numpy())

    def sync(out):
        # In-order execution on the stream: a scalar of the newest flow
        # proves that every earlier launch has finished.
        return float(out["flow"].sum())

    engine.reset()
    n_frames = n_flows = 0
    pending = last = None
    t0 = None
    wait_s = 0.0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        item = q.get()
        wait_s += time.perf_counter() - t
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        path, frame = item
        n_frames += 1
        out = engine.push(frame)
        if out is None:
            continue
        n_flows += 1
        if pending is not None:
            drain(pending)
        pending = last = (path, out)
        if n_flows == warmup:
            sync(out)
            t0 = time.perf_counter()
    thread.join()
    if pending is not None:
        drain(pending)
    if last is not None:
        sync(last[1])
    now = time.perf_counter()
    steady = max(n_flows - warmup, 0) if t0 is not None else 0
    if steady > 0:
        elapsed = now - t0
        rate = steady / elapsed if elapsed > 0 else 0.0
    else:
        elapsed = now - start
        rate = n_flows / elapsed if elapsed > 0 and n_flows else 0.0
    return {"frames": n_frames, "flows": n_flows, "elapsed_s": elapsed,
            "steady_flows": steady, "flows_per_sec": rate,
            "queue_wait_s": wait_s, "decode_s": decode_s[0]}
