"""``run_stream`` and ``arflow-torch-stream`` against the JAX package's
``run_stream`` and ``stream_cli`` on 5 PNG frames at 64x96: the same
``.flo`` names, values within the engine test's bound, a JAX ``.msgpack``
given with ``-m``, and ``--artifact`` (a streaming artifact of
``arflow-torch-export``) equal to the eager engine. Both packages decode
with PIL (``arflow_tpu.native`` off)."""

import json
import os

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import arflow_tpu.native
from arflow_tpu.cli import stream_cli as jax_stream_cli
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.serving import StreamingFlowEngine as JaxStreamingFlowEngine
from arflow_tpu.serving import run_stream as jax_run_stream
from arflow_tpu.training.checkpoint import save_checkpoint
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import export_cli, stream_cli
from arflow_tpu_torch.models import uflow_state_dict_from_jax
from arflow_tpu_torch.serving import StreamingFlowEngine, run_stream
from arflow_tpu_torch.utils.flow_io import read_flo
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    H,
    W,
    few_torch_threads,
    jax_params,
)

# float32 flows against the JAX engine: the bound of
# tests/test_torch_serving.py (measured here: at most 1.8e-5 px on flows
# of up to 18.5 px, random weights).
FLOW_ATOL = 1e-4
N_FRAMES = 5


@pytest.fixture(autouse=True)
def pil_on_both_sides(monkeypatch):
    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """5 PNG frames, a blocky texture moving (1, 2) px per frame."""
    from PIL import Image

    root = tmp_path_factory.mktemp("frames")
    rs = np.random.RandomState(7)
    tex = np.kron(rs.rand(H // 8 + 4, W // 8 + 4, 3), np.ones((8, 8, 1)))
    for t in range(N_FRAMES):
        img = tex[16 - t:16 - t + H, 16 - 2 * t:16 - 2 * t + W]
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            root / f"frame_{t:03d}.png")
    return root


def _paths(root):
    return sorted(str(p) for p in root.glob("*.png"))


def _flos(out_dir):
    return {p: read_flo(os.path.join(out_dir, p))
            for p in sorted(os.listdir(out_dir)) if p.endswith(".flo")}


def _assert_same_flows(ours, theirs, atol):
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].shape == theirs[name].shape == (H, W, 2)
        np.testing.assert_allclose(ours[name], theirs[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_run_stream_matches_jax(jax_params, frames_dir, tmp_path):
    engine = StreamingFlowEngine(Config(CFG), uflow_state_dict_from_jax(jax_params),
                                 with_bw=True, device="cpu")
    jengine = JaxStreamingFlowEngine(JaxConfig(CFG), {"params": jax_params},
                                     with_bw=True)
    stats = run_stream(engine, _paths(frames_dir), out_root=str(tmp_path / "port"),
                       warmup=1)
    jstats = jax_run_stream(jengine, _paths(frames_dir),
                            out_root=str(tmp_path / "jax"), warmup=1)
    for key in ("frames", "flows", "steady_flows"):
        assert stats[key] == jstats[key]
    assert (stats["frames"], stats["flows"], stats["steady_flows"]) == (5, 4, 3)
    assert stats["flows_per_sec"] > 0 and stats["decode_s"] > 0
    ours, theirs = _flos(tmp_path / "port"), _flos(tmp_path / "jax")
    assert sorted(ours) == [f"frame_{t:03d}{s}.flo" for t in range(1, 5)
                            for s in ("", "_bw")]
    _assert_same_flows(ours, theirs, FLOW_ATOL)


def test_run_stream_without_outputs_and_a_bad_frame(jax_params, frames_dir,
                                                    tmp_path):
    """No ``out_root``: nothing written, the statistics still counted; a
    frame that does not decode raises in the caller."""
    engine = StreamingFlowEngine(Config(CFG), uflow_state_dict_from_jax(jax_params),
                                 device="cpu")
    stats = run_stream(engine, _paths(frames_dir)[:3], warmup=5)
    assert (stats["frames"], stats["flows"], stats["steady_flows"]) == (3, 2, 0)
    assert stats["flows_per_sec"] > 0
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(Exception, match="bad.png|cannot identify"):
        run_stream(engine, _paths(frames_dir)[:2] + [str(bad)])


@pytest.fixture(scope="module")
def msgpack_ckpt(jax_params, tmp_path_factory):
    """A JAX ``.msgpack`` checkpoint and a config naming its model."""
    root = tmp_path_factory.mktemp("ckpt")
    ckpt = save_checkpoint(str(root), {"epoch": 1, "params": jax_params}, "model")
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps({"model": CFG, "loss": {}}))
    return str(cfg), ckpt


@pytest.mark.parametrize("bw", [False, True], ids=["fw", "bw"])
def test_stream_cli_matches_jax_with_a_msgpack(msgpack_ckpt, frames_dir,
                                               tmp_path, bw):
    cfg, ckpt = msgpack_ckpt
    extra = ["--bw"] if bw else []
    stats = stream_cli(["-c", cfg, "-m", ckpt, "--frames", str(frames_dir),
                        "--out", str(tmp_path / "port"), "--device", "cpu",
                        *extra])
    jax_stream_cli(["-c", cfg, "-m", ckpt, "--frames", str(frames_dir),
                    "--out", str(tmp_path / "jax"), *extra])
    assert stats["flows"] == N_FRAMES - 1
    ours, theirs = _flos(tmp_path / "port"), _flos(tmp_path / "jax")
    assert len(ours) == (N_FRAMES - 1) * (2 if bw else 1)
    _assert_same_flows(ours, theirs, FLOW_ATOL)


def test_stream_cli_artifact_equals_the_eager_stream(msgpack_ckpt, frames_dir,
                                                     tmp_path):
    """``arflow-torch-export --streaming`` from the ``.msgpack``, then
    ``arflow-torch-stream --artifact --bw``: every ``.flo`` equal, bit for
    bit on the CPU, to ``-c/-m``'s; ``--size`` resizes a frame of another
    size to the artifact's."""
    from PIL import Image

    cfg, ckpt = msgpack_ckpt
    art = str(tmp_path / "model.afx")
    meta = export_cli(["-c", cfg, "-m", ckpt, "-o", art, "--size", f"{H}x{W}",
                       "--device", "cpu", "--streaming"])
    assert meta["window"] == 2 and meta["device"] == "cpu"
    stream_cli(["--artifact", art, "--frames", str(frames_dir), "--bw",
                "--out", str(tmp_path / "artifact")])
    stream_cli(["-c", cfg, "-m", ckpt, "--frames", str(frames_dir), "--bw",
                "--out", str(tmp_path / "eager"), "--device", "cpu"])
    _assert_same_flows(_flos(tmp_path / "artifact"), _flos(tmp_path / "eager"), 0)
    # Frames of another size are resized to the exported one.
    big = tmp_path / "big"
    big.mkdir()
    for p in _paths(frames_dir)[:2]:
        Image.open(p).resize((2 * W, 2 * H)).save(big / os.path.basename(p))
    stats = stream_cli(["--artifact", art, "--frames", str(big / "*.png"),
                        "--out", str(tmp_path / "big_out")])
    assert stats["flows"] == 1
    assert read_flo(str(tmp_path / "big_out" / "frame_001.flo")).shape == (H, W, 2)


def test_stream_cli_refusals(frames_dir, monkeypatch):
    with pytest.raises(SystemExit):
        stream_cli(["--frames", str(frames_dir)])  # neither -c nor --artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        stream_cli(["-c", "cfg.json", "--frames", str(frames_dir)])
