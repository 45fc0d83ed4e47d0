"""The port's ``torch.export`` artifacts (``serving/export.py``) for
``uflow`` at 64x96 b1 on the CPU: monolithic and streaming, each loaded
output equal to the eager port model (bit for bit: the same ops on the CPU)
and within the bounds of ``tests/test_torch_serving.py`` of the JAX
package's ``export_inference`` / ``export_streaming`` artifacts exported for
``cpu`` from the same weights; loading in a process that imports neither
the models nor JAX; the refusals. ``uflow_prob`` with its ``diag`` and
``mixture`` entropies: ``test_torch_serving_export_prob.py`` and
``test_torch_serving_export_mixture.py``."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.serving import export
from torch_export_util import (
    artifacts,
    check_monolithic,
    check_streaming,
    eager,
    engine,
    frames,
)
from torch_port_util import H, W, few_torch_threads  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    return artifacts("uflow", tmp_path_factory.mktemp("mono"), False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    return artifacts("uflow", tmp_path_factory.mktemp("stream"), True)


def test_monolithic_matches_eager_and_jax(mono):
    check_monolithic(*mono)


def test_streaming_matches_engine_and_jax(stream):
    check_streaming(*stream)


_SOURCE_FREE = r"""
import sys
import numpy as np
import torch
from arflow_tpu_torch.serving.export import load_artifact, load_streaming_artifact
torch.set_num_threads(1)  # as few_torch_threads: the eager run's rounding
d = np.load(sys.argv[1])
flow, ent = load_artifact(sys.argv[2])(d["img1"], d["img2"])
art = load_streaming_artifact(sys.argv[3])
art.push(d["img1"])
out = art.push(d["img2"])
ok = all(torch.equal(a, torch.from_numpy(d[k])) for a, k in (
    (flow, "flow"), (ent, "ent"), (out["flow"], "stream_flow")))
bad = sorted(m for m in sys.modules if m.startswith(("arflow_tpu_torch.models",
             "arflow_tpu_torch.training", "jax", "arflow_tpu.")))
print(ok, bad)
"""


def test_loads_without_the_model_source(mono, stream, tmp_path):
    """A fresh interpreter loads both artifacts importing only the op
    registration: no ``arflow_tpu_torch.models``, no trainer, no JAX; their
    outputs equal the eager model's and the eager engine's."""
    cfg, sd, mono_path, _ = mono
    stream_path = stream[2]
    img1, img2 = frames(2, seed=3)
    flow, ent, _ = eager(cfg, sd, img1, img2)
    eng = engine(cfg, sd)
    eng.push(img1)
    data = str(tmp_path / "io.npz")
    np.savez(data, img1=img1, img2=img2, flow=flow.numpy(), ent=ent.numpy(),
             stream_flow=eng.push(img2)["flow"].numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", _SOURCE_FREE, data, mono_path,
                           stream_path],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True []"


def test_refusals(mono, stream, tmp_path, monkeypatch):
    cfg, sd, mono, _ = mono
    stream = stream[2]
    with pytest.raises(ValueError, match="streaming artifact"):
        export.load_artifact(stream)
    with pytest.raises(ValueError, match="not a streaming artifact"):
        export.load_streaming_artifact(mono)
    bad = tmp_path / "bad.afx"
    bad.write_bytes(b"PK\x03\x04")
    with pytest.raises(ValueError, match="not an arflow export artifact"):
        export.load_artifact(str(bad))
    img = np.zeros((1, H // 2, W, 3), np.float32)
    with pytest.raises(ValueError, match="static shapes"):
        export.load_artifact(mono)(img, img)
    with pytest.raises(ValueError, match="static shapes"):
        export.load_streaming_artifact(stream).push(np.zeros((2, H, W, 3)))
    # The PWC-Lite family exports (tests/test_torch_pwclite_export.py);
    # what it refuses: a pair artifact of the 3-frame network, the 5-frame
    # one's stream, and a type neither package builds.
    with pytest.raises(ValueError, match="image pair"):
        export.export_inference(
            Config({"model": {"type": "pwclite", "n_frames": 3}}), {}, 1,
            (H, W), device="cpu")
    with pytest.raises(ValueError, match="5-frame variant"):
        export.export_streaming(
            Config({"model": {"type": "pwclite", "n_frames": 5}}), {}, 1,
            (H, W), device="cpu")
    for export_fn in (export.export_inference, export.export_streaming):
        with pytest.raises(NotImplementedError, match="flownet_prob"):
            export_fn(Config({"model": {"type": "flownet_prob"}}), {}, 1,
                      (H, W), device="cpu")
    mixture = Config({"model": {"type": "uflow_prob", "out_channels": [2, 2, 0],
                                "n_pyramids": 2, "mixture_weights": True}})
    with pytest.raises(ValueError, match="mixture_weights"):
        export.export_inference(mixture, {}, 1, (H, W), device="cpu")
    with pytest.raises(ValueError, match="mixture_weights"):
        export.export_streaming(mixture, {}, 1, (H, W), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        export.export_inference(cfg, sd, 1, (H, W))  # default: the card
    header = json.loads(open(mono, "rb").read()[8:8 + int.from_bytes(
        open(mono, "rb").read()[4:8], "little")])
    assert header["model_type"] == "uflow" and "sections" not in header


def test_component_is_not_streamed():
    """``component`` has no streaming in either package (the JAX engine
    fails on its missing pyramid attribute): the engine and the streaming
    export refuse it with a message of its own, not the PWC-Lite one."""
    from arflow_tpu_torch.serving import StreamingFlowEngine
    from arflow_tpu_torch.serving.engine import COMPONENT_NOT_STREAMED

    model = Config({"type": "component", "out_channels": [2, 2, 0]})
    with pytest.raises(NotImplementedError) as err:
        StreamingFlowEngine(model, {}, device="cpu")
    assert str(err.value) == COMPONENT_NOT_STREAMED
    assert "'component'" in str(err.value) and "PWC-Lite" not in str(err.value)
    with pytest.raises(NotImplementedError, match="'component'"):
        export.export_streaming(Config({"model": model}), {}, 1, (H, W),
                                device="cpu")
