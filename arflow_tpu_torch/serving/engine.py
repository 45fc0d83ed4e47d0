"""Streaming (video) optical-flow serving (port of
``arflow_tpu/serving/engine.py``: ``uflow``, ``uflow_prob``, ``pwclite``
with 2 or 3 frames, ``pwclite_prob`` and ``pwclite_uflow``).

A stream of T frames needs T feature pyramids (K per frame for a
``uflow_prob`` model with ``n_pyramids`` K), not the 2(T-1) of running the
whole model per pair: each frame's pyramids are computed once, cached, and
the coarse-to-fine decoder runs on (pyramids of t-1, pyramids of t), the K
components in one batched pass. The pyramids and the decoder are the same
modules the monolithic forward runs. With a ``loss_cfg`` that has
``approx``, each push also returns the entropy map of that approximation.

The 3-frame ``pwclite`` runs a window of three cached pyramids centred on
the previous frame: each push from the third frame on returns the flow
(t-1) -> t and, with ``with_bw``, (t-1) -> (t-2), both from one fused
decoder pass over (t-2, t-1, t), as the JAX engine does.

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

STREAMED = ("uflow", "uflow_prob", "pwclite", "pwclite_prob", "pwclite_uflow")
# The 5-frame PWCLite chains 3-frame windows inside one model call; the JAX
# engine refuses it with this error.
FIVE_FRAMES_NOT_STREAMED = (
    "StreamingFlowEngine supports the 2-frame and 3-frame PWCLite; the "
    "5-frame variant chains multiple 3-frame windows inside one model call "
    "(use the monolithic forward).")
# The JAX engine has no streaming for ComponentNet either: two nets, each
# with its own pyramid, and no pyramid attribute to split at.
COMPONENT_NOT_STREAMED = (
    "streaming is not available for model type 'component' (two "
    "PWCProbFlow nets, each with its own pyramid), in this package as in the "
    "JAX one: use the monolithic forward or its export")


class StreamingFlowEngine:
    """Per-frame pyramid reuse for consecutive-pair flow on a video stream.

    model_cfg : the config's ``model`` section (``type`` one of
        ``STREAMED``; a ``pwclite`` with ``n_frames`` 2 or 3).
    state_dict : the model's weights (e.g. from ``uflow_state_dict_from_jax``
        or a reference checkpoint), loaded with ``strict=True``.
    with_bw : also return the backward flow (cur -> prev; for the 3-frame
        window (t-1) -> (t-2)): one more decoder pass (none for the 3-frame
        window, whose pass computes it anyway), no more pyramids.
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
        if model_cfg.type not in STREAMED:
            raise NotImplementedError(
                f"streaming for model type {model_cfg.type!r}")
        if model_cfg.type == "pwclite" and model_cfg.n_frames not in (2, 3):
            raise ValueError(FIVE_FRAMES_NOT_STREAMED)
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
        # Frames per output: 3 for the 3-frame PWCLite, else 2.
        self.window = 3 if getattr(self._model, "n_frames", 2) == 3 else 2
        self._prev = []  # pyramids of the last window - 1 frames, oldest first
        self.pyramids_computed = 0  # frames whose pyramids were computed

    def reset(self):
        """Drop the cached pyramids (call at a video or scene boundary)."""
        self._prev = []

    def _flows(self, fps1, fps2) -> list:
        """The pair's outputs, NHWC views, finest first."""
        return [f.permute(0, 2, 3, 1) for f in self._model.decode(fps1, fps2)]

    @torch.inference_mode()
    def push(self, frame) -> dict | None:
        """Feed the next frame, (B,H,W,3) or (H,W,3) float32 in [0, 1].

        Returns None until the window is full (the first frame after
        construction or ``reset``; the first two for the 3-frame window);
        then ``{'flow'}`` (B,H,W,2), the flow prev -> cur, with ``with_bw``
        also ``'flow_bw'`` (cur -> prev), and with an ``approx`` in
        ``loss_cfg`` also ``'entropy'`` (B,H,W,2) of the forward flow. The
        3-frame window is centred on the previous frame: ``'flow'`` is
        (t-1) -> t and ``'flow_bw'`` (t-1) -> (t-2), so the outputs trail
        the stream by one frame; it returns no ``'entropy'`` (the PWCLite
        has no variance output).
        """
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        if frame.dim() == 3:
            frame = frame[None]
        fp = self._model.feature_pyramids(
            frame.permute(0, 3, 1, 2).contiguous())
        self.pyramids_computed += 1
        prev = slide_window(self, fp)
        if prev is None:
            return None
        if self.window == 3:
            return window_outputs(decode_window(self._model, *prev, fp),
                                  self._with_bw)
        flows = self._flows(prev[0], fp)
        out = {"flow": flows[0][..., :2].contiguous()}
        if self._loss_cfg is not None:
            from arflow_tpu_torch.training.entropy import extract_uv_entropy

            out["entropy"] = extract_uv_entropy(
                flows, self._loss_cfg, {"flows_fw": flows},
                generator=torch.Generator(device=self.device).manual_seed(0))
        if self._with_bw:
            out["flow_bw"] = self._flows(fp, prev[0])[0][..., :2].contiguous()
        return out


def slide_window(stream, fp) -> list | None:
    """Append the newest frame's pyramids ``fp`` to ``stream._prev``, which
    keeps the last ``stream.window - 1``; the earlier frames of the window
    that ``fp`` completes, oldest first, or None while it is not full. The
    window policy of ``StreamingFlowEngine`` and ``StreamingArtifact``."""
    prev = stream._prev
    stream._prev = (prev + [fp])[-(stream.window - 1):]
    return prev if len(prev) == stream.window - 1 else None


def decode_window(model, fp0, fp1, fp2):
    """The 3-frame window centred on frame 1, finest level, (B,H,W,2):
    ``(flow 1 -> 2, flow 1 -> 0)``, one fused decoder pass; the pair that
    the streaming artifact's ``decode`` exports."""
    flows_10, flows_12 = model.decode3(fp0, fp1, fp2)
    return (flows_12[0].permute(0, 2, 3, 1).contiguous(),
            flows_10[0].permute(0, 2, 3, 1).contiguous())


def window_outputs(flows, with_bw: bool) -> dict:
    """``push``'s result for a 3-frame window's ``(flow, flow_bw)``."""
    flow, flow_bw = flows
    return {"flow": flow, "flow_bw": flow_bw} if with_bw else {"flow": flow}


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
