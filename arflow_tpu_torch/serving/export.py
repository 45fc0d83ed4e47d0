"""Ahead-of-time export of the serving programs with ``torch.export`` (port
of ``arflow_tpu/serving/export.py``).

The forward is traced once at a static ``(batch, H, W)`` on one device, its
weights kept as the program's state, and saved with ``torch.export.save``.
The artifact runs without the model's source: a loader imports the op
registration (``ops/cuda/cost_volume.py``) and not ``arflow_tpu_torch.models``.
Its graph holds ``arflow::cost_volume``, so on a CUDA device it launches the
hand-written kernel, as the JAX artifact keeps its Pallas kernel. An artifact
runs on the device it was exported for (``device``, in the header; JAX's
``platforms``): the program's weights and constants live there.

Artifact layout (single file), as the JAX package's::

    AFX1 | u32 header_len | header JSON (utf-8) | payloads

Format 1 is monolithic: one ``torch.export.save`` payload of
``(img1, img2) -> (flow, entropy)``. Format 2 is streaming: a ``sections``
table of ``[name, bytes]`` and the payloads ``pyramid(img) -> fp`` and
``decode(fp_prev, fp_cur) -> (flow, entropy)``, the split programs of
``StreamingFlowEngine`` (one pyramid per frame). The header holds the JAX
keys, with ``device`` in place of ``platforms`` and ``torch_version`` in
place of ``jax_version``.

The export is non-strict (``strict=False``): the model code is plain Python
over static shapes, and its host-side parts (the numpy resize weights, the
shape arithmetic, the Python loop over anti-diagonals of
``inverse_diagonal``) run once while tracing and leave their results in the
graph. Strict export would trace the same code through TorchDynamo's
bytecode analysis, which adds nothing for such code but its failure modes.

The ``mixture`` entropy's Monte-Carlo samples are drawn inside the
program, at run time, from a counter-based hash of seed 0
(``utils/gmm.py:hash_draws``): ``torch.export`` cannot trace a
``torch.Generator``, and draws kept as constants would hold
100 × B × H × W × 2 floats. The artifact holds the weights and its graph,
whatever H × W. Its entropy equals ``extract_uv_entropy`` of the eager
outputs with ``mixture_hash_draws(k, B, (H, W))`` injected; the eager
entry points draw from a generator seeded 0.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from dataclasses import dataclass, field

import torch

# Registers arflow::cost_volume, which a program's graph calls.
import arflow_tpu_torch.ops.cuda.cost_volume  # noqa: F401
from arflow_tpu_torch.serving.engine import _NOT_PORTED

_MAGIC = b"AFX1"


# The seed of the mixture entropy's hashed draws in a program.
DRAW_SEED = 0


class _Entropy(torch.nn.Module):
    """``extract_uv_entropy`` of the forward flows, or zeros without an
    ``approx``; the ``mixture`` draws hashed in the program
    (``DRAW_SEED``)."""

    def __init__(self, loss_cfg):
        super().__init__()
        self.loss_cfg = loss_cfg if loss_cfg and "approx" in loss_cfg else None

    def forward(self, flows, res):
        from arflow_tpu_torch.training.entropy import extract_uv_entropy

        pred = flows[0][..., 0:2]
        if self.loss_cfg is None:
            return torch.zeros_like(pred)
        return extract_uv_entropy(flows, self.loss_cfg, res,
                                  draws={"hash_seed": DRAW_SEED})


class InferenceModule(torch.nn.Module):
    """The serving forward: NHWC ``(img1, img2)`` -> ``(flow, entropy)``,
    both (B,H,W,2), as ``inference_main`` computes them."""

    def __init__(self, model, loss_cfg):
        super().__init__()
        self.model = model
        self.entropy = _Entropy(loss_cfg)

    def forward(self, img1, img2):
        res = self.model(img1, img2, with_bk=False)
        flows = res["flows_fw"]
        return flows[0][..., 0:2].contiguous(), self.entropy(flows, res)


_PYRAMID = "_feature_pyramid_extractor"


def _part(model, keep):
    """A shallow copy of ``model`` with only the submodules whose names
    ``keep`` accepts: an exported program keeps every parameter of its
    module, and the pyramid and the decoder each need only their own."""
    part = copy.copy(model)
    part._modules = {k: v for k, v in model._modules.items() if keep(k)}
    return part


class PyramidModule(torch.nn.Module):
    """``pyramid(img)``: a frame's feature pyramids, the engine's cache."""

    def __init__(self, model):
        super().__init__()
        self.model = _part(model, lambda name: name == _PYRAMID)

    def forward(self, img):
        return self.model.feature_pyramids(
            img.permute(0, 3, 1, 2).contiguous())


class DecodeModule(torch.nn.Module):
    """``decode(fp_prev, fp_cur)`` -> ``(flow, entropy)`` of the pair."""

    def __init__(self, model, loss_cfg):
        super().__init__()
        self.model = _part(model, lambda name: name != _PYRAMID)
        self.entropy = _Entropy(loss_cfg)

    def forward(self, fp_prev, fp_cur):
        flows = [f.permute(0, 2, 3, 1) for f in self.model.decode(fp_prev, fp_cur)]
        return (flows[0][..., 0:2].contiguous(),
                self.entropy(flows, {"flows_fw": flows}))


def _check_model(model_cfg):
    from arflow_tpu_torch.models.uflow_prob import MIXTURE_NEEDS_BK

    if model_cfg.type not in ("uflow", "uflow_prob", "component"):
        raise NotImplementedError(_NOT_PORTED.format(model_cfg.type))
    if model_cfg.get("mixture_weights"):
        raise ValueError(f"export: {MIXTURE_NEEDS_BK}")


def build_inference_fn(cfg, state_dict, device="cuda") -> InferenceModule:
    """The serving forward of ``cfg`` (its ``model`` and ``loss`` sections)
    with ``state_dict`` loaded strictly, on ``device``, in eval mode. The
    entropy is zeros where the loss section has no ``approx``."""
    from arflow_tpu_torch.device import resolve_device
    from arflow_tpu_torch.models import get_model

    _check_model(cfg.model)
    dev = resolve_device(device)
    model = get_model(cfg.model, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return InferenceModule(model, cfg.get("loss")).to(dev).eval()


def _frame(batch, h, w, device):
    """An example input of the exported shape (its values are not kept)."""
    return torch.zeros((int(batch), h, w, 3), device=device)


def _export(module, args):
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
    ep.example_inputs = None  # not kept in the artifact
    return ep


def _meta(cfg, has_entropy, batch, h, w, device) -> dict:
    return {"model_type": cfg.model.type, "has_entropy": bool(has_entropy),
            "batch": int(batch), "height": h, "width": w, "device": str(device)}


def export_inference(cfg, state_dict, batch: int, size_hw, *, device="cuda"):
    """Export the serving forward at static ``(batch, H, W)`` inputs, two
    ``(batch, H, W, 3)`` float32 images in [0, 1], on ``device``. Returns
    ``(ExportedProgram, meta)`` for ``save_artifact``."""
    h, w = int(size_hw[0]), int(size_hw[1])
    module = build_inference_fn(cfg, state_dict, device)
    dev = next(module.parameters()).device
    ep = _export(module, (_frame(batch, h, w, dev), _frame(batch, h, w, dev)))
    return ep, _meta(cfg, module.entropy.loss_cfg is not None, batch, h, w, dev)


def export_streaming(cfg, state_dict, batch: int, size_hw, *, device="cuda"):
    """Export ``StreamingFlowEngine``'s split programs at static
    ``(batch, H, W)`` frames on ``device``: ``pyramid(img) -> fp`` and
    ``decode(fp_prev, fp_cur) -> (flow, entropy)``. Returns
    ``({'pyramid', 'decode'}, meta)`` for ``save_streaming_artifact``."""
    from arflow_tpu_torch.serving.engine import StreamingFlowEngine

    engine = StreamingFlowEngine(cfg.model, state_dict, device=device,
                                 loss_cfg=cfg.get("loss"))
    dev, model = engine.device, engine._model.eval()
    h, w = int(size_hw[0]), int(size_hw[1])
    pyramid = PyramidModule(model)
    with torch.no_grad():
        fps = [pyramid(_frame(batch, h, w, dev)) for _ in range(2)]
    decode = DecodeModule(model, cfg.get("loss")).to(dev)
    exported = {"pyramid": _export(pyramid, (_frame(batch, h, w, dev),)),
                "decode": _export(decode, tuple(fps))}
    meta = _meta(cfg, decode.entropy.loss_cfg is not None, batch, h, w, dev)
    meta["window"] = 2
    return exported, meta


def _payload(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _write(path, header, payloads):
    header["torch_version"] = torch.__version__
    hbytes = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hbytes)))
        f.write(hbytes)
        for p in payloads:
            f.write(p)


def save_artifact(path: str, exported, meta: dict) -> None:
    """Write the monolithic (format 1) artifact."""
    header = dict(meta)
    header.setdefault("format", 1)
    _write(path, header, [_payload(exported)])


def save_streaming_artifact(path: str, exported: dict, meta: dict) -> None:
    """Write the streaming (format 2) artifact, its ``sections`` table in
    the header and the payloads after it in that order."""
    header = dict(meta)
    header["format"] = 2
    payloads = [(name, _payload(ep)) for name, ep in exported.items()]
    header["sections"] = [[name, len(p)] for name, p in payloads]
    _write(path, header, [p for _, p in payloads])


def _read(path):
    """(header, the rest of the file) of an artifact."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an arflow export artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(hlen).decode("utf-8")), f.read()


def _load(payload: bytes):
    return torch.export.load(io.BytesIO(payload)).module()


def _as_input(x, meta, what):
    """``x`` as a float32 (B,H,W,3) tensor on the artifact's device, or a
    ValueError if its shape is not the exported one."""
    x = torch.as_tensor(x, dtype=torch.float32, device=meta["device"])
    if x.dim() == 3:
        x = x[None]
    want = (int(meta["batch"]), int(meta["height"]), int(meta["width"]), 3)
    if tuple(x.shape) != want:
        raise ValueError(
            f"artifact exported for {what} {want}, got {tuple(x.shape)} "
            "(torch.export programs have static shapes; resize or re-batch "
            "the input, or re-export)")
    return x


@dataclass
class ServingArtifact:
    """A loaded monolithic artifact: ``artifact(img1, img2) -> (flow,
    entropy)`` on its device."""

    meta: dict
    program: torch.nn.Module

    def __call__(self, img1, img2):
        a = _as_input(img1, self.meta, "images")
        b = _as_input(img2, self.meta, "images")
        with torch.no_grad():
            return self.program(a, b)


def load_artifact(path: str) -> ServingArtifact:
    meta, payload = _read(path)
    if "sections" in meta:
        raise ValueError(f"{path}: streaming artifact (use load_streaming_artifact)")
    return ServingArtifact(meta=meta, program=_load(payload))


@dataclass
class StreamingArtifact:
    """A loaded streaming artifact: a source-free ``StreamingFlowEngine``.

    ``push(frame)`` returns None until the window holds the previous frame,
    then ``{'flow'}`` (prev -> cur), with ``with_bw`` also ``'flow_bw'``
    (the decoder run again on the swapped pyramids) and, when exported from
    a config with ``approx``, ``'entropy'``. Frames carry the exported
    batch and size.
    """

    meta: dict
    pyramid: torch.nn.Module
    decode: torch.nn.Module
    with_bw: bool = False
    _prev: list = field(default=None, repr=False)

    def reset(self):
        self._prev = None

    def push(self, frame):
        x = _as_input(frame, self.meta, "frames")
        with torch.no_grad():
            fp = self.pyramid(x)
            prev, self._prev = self._prev, fp
            if prev is None:
                return None
            flow, ent = self.decode(prev, fp)
            out = {"flow": flow}
            if self.with_bw:
                out["flow_bw"] = self.decode(fp, prev)[0]
        if self.meta.get("has_entropy"):
            out["entropy"] = ent
        return out


def load_streaming_artifact(path: str) -> StreamingArtifact:
    meta, rest = _read(path)
    if meta.get("format") != 2 or "sections" not in meta:
        raise ValueError(f"{path}: not a streaming artifact (use load_artifact)")
    programs, at = {}, 0
    for name, n in meta["sections"]:
        programs[name] = _load(rest[at:at + n])
        at += n
    return StreamingArtifact(meta=meta, pyramid=programs["pyramid"],
                             decode=programs["decode"])
