"""The PWC-Lite family through the port's serving and tool entry points on
the CPU: the monolithic ``torch.export`` artifact of the 2-frame
``pwclite`` and the streaming artifact of the 3-frame window, each loaded
output equal to the eager model bit for bit (the same ops on the CPU),
loaded in a process that imports neither the models nor JAX; the
refusals; and ``inference_main`` for ``pwclite_prob`` with its ``diag``
entropy against the JAX ``inference_main``."""

import logging
import os
import subprocess
import sys

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.serving import StreamingFlowEngine, export
from arflow_tpu_torch.utils.flow_io import read_flo
from torch_data_util import make_chairs_dir
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import H, W, images, run_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
log = logging.getLogger("test")
LITE2 = Config({"model": {"type": "pwclite", "n_frames": 2}})
LITE3 = Config({"model": {"type": "pwclite", "n_frames": 3}})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(state_dicts, the monolithic 2-frame and the 3-frame streaming
    artifact), exported for the CPU at 1x64x128."""
    root = tmp_path_factory.mktemp("lite")
    sds = {n: get_model(cfg.model, device="cpu", seed=n).state_dict()
           for n, cfg in ((2, LITE2), (3, LITE3))}
    mono, stream = str(root / "mono.afx"), str(root / "stream3.afx")
    ep, meta = export.export_inference(LITE2, sds[2], 1, (H, W), device="cpu")
    export.save_artifact(mono, ep, meta)
    eps, meta = export.export_streaming(LITE3, sds[3], 1, (H, W), device="cpu")
    export.save_streaming_artifact(stream, eps, meta)
    return sds, mono, stream


def test_monolithic_artifact_matches_eager(artifacts):
    sds, mono, _ = artifacts
    art = export.load_artifact(mono)
    assert art.meta["model_type"] == "pwclite" and not art.meta["has_entropy"]
    img1, img2 = images(2, seed=1, b=1, dtype=np.float32)
    flow, ent = art(img1, img2)
    model = get_model(LITE2.model, device="cpu")
    model.load_state_dict(sds[2], strict=True)
    want = run_port(model, [img1, img2])["flows_fw"][0]
    assert tuple(flow.shape) == (1, H, W, 2)
    torch.testing.assert_close(flow, want, rtol=0, atol=0)
    assert not ent.any()


def test_3frame_streaming_artifact_matches_engine(artifacts):
    """``decode(fp0, fp1, fp2) -> (flow_12, flow_10)``: the artifact keeps
    the engine's window, nothing for the first two frames, then (t-1) -> t
    and (t-1) -> (t-2), over a reset."""
    sds, _, stream = artifacts
    art = export.load_streaming_artifact(stream)
    assert art.meta["window"] == 3 and not art.meta["has_entropy"]
    art.with_bw = True
    eng = StreamingFlowEngine(LITE3.model, sds[3], with_bw=True, device="cpu")
    seq = images(5, seed=2, b=1, dtype=np.float32)
    for _ in range(2):
        art.reset(), eng.reset()
        for t, frame in enumerate(seq):
            out, want = art.push(frame), eng.push(frame)
            if t < 2:
                assert out is None and want is None
                continue
            assert sorted(out) == sorted(want) == ["flow", "flow_bw"]
            for key in want:
                torch.testing.assert_close(out[key], want[key], rtol=0, atol=0)


_SOURCE_FREE = r"""
import sys
import numpy as np
import torch
from arflow_tpu_torch.serving.export import load_artifact, load_streaming_artifact
torch.set_num_threads(1)  # as few_torch_threads: the eager run's rounding
d = np.load(sys.argv[1])
flow, _ = load_artifact(sys.argv[2])(d["a"], d["b"])
art = load_streaming_artifact(sys.argv[3])
outs = [art.push(d[k]) for k in ("a", "b", "c")]
ok = (torch.equal(flow, torch.from_numpy(d["flow"])) and outs[1] is None
      and torch.equal(outs[2]["flow"], torch.from_numpy(d["flow3"])))
bad = sorted(m for m in sys.modules if m.startswith(("arflow_tpu_torch.models",
             "arflow_tpu_torch.training", "jax", "arflow_tpu.")))
print(ok, bad)
"""


def test_artifacts_load_without_the_model_source(artifacts, tmp_path):
    sds, mono, stream = artifacts
    a, b, c = images(3, seed=3, b=1, dtype=np.float32)
    flow = export.load_artifact(mono)(a, b)[0]
    eng = StreamingFlowEngine(LITE3.model, sds[3], device="cpu")
    flow3 = [eng.push(x) for x in (a, b, c)][2]["flow"]
    data = str(tmp_path / "d.npz")
    np.savez(data, a=a, b=b, c=c, flow=flow.numpy(), flow3=flow3.numpy())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _SOURCE_FREE, data, mono,
                          stream], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True []"


def test_refusals():
    """A 3- or 5-frame PWCLite has no monolithic pair artifact (the JAX
    export fails on it too); the 5-frame one has no streaming either."""
    with pytest.raises(ValueError, match="image pair"):
        export.export_inference(LITE3, {}, 1, (H, W), device="cpu")
    five = Config({"model": {"type": "pwclite", "n_frames": 5}})
    with pytest.raises(ValueError, match="5-frame variant"):
        export.export_streaming(five, {}, 1, (H, W), device="cpu")


# configs-style pwclite_prob with the diag entropy that inference_main
# writes beside each .flo
PROB_MODEL = {"type": "pwclite_prob", "n_frames": 2, "upsample": True,
              "reduce_dense": True}
PROB_LOSS = {"type": "uflow_elbo", "approx": "diag", "n_components": 1}
# The port's float32 flows against the JAX package's (its relayouts on),
# rescaled by up to 80/64 and resized to 80x144, the JAX side with cv2,
# the port's with the 2-tap numpy gather: measured at most 2.4e-5 px on
# .flo files of up to 18.8 px and 5.7e-6 on .npy entropies of up to 12.2.
# The bound of tests/test_torch_cli.py.
PROB_ATOL = 5e-5


def _inference_cfg(module_config, root, out_root, ckpt):
    return module_config({
        "seed": 0,
        "data": [{"root_chairs": str(root), "type": "valid", "name": "Chairs",
                  "n_frames": 2, "split": "trainval", "test_shape": [H, W],
                  "out_root": str(out_root)}],
        "model": PROB_MODEL, "loss": PROB_LOSS,
        "inference": {"pretrained_model": str(ckpt), "valid_batch_size": 2,
                      "workers": 2},
    })


def test_inference_main_pwclite_prob_matches_jax(tmp_path, monkeypatch):
    import arflow_tpu.native
    from arflow_tpu.cli import inference_main as jax_inference_main
    from arflow_tpu.config import Config as JaxConfig

    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(3),
                           3, 80, 144)
    model = get_model(Config(PROB_MODEL), device="cpu", seed=6)
    ckpt = tmp_path / "pwclite_prob.pth.tar"
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)
    written = cli.inference_main(_inference_cfg(Config, root, tmp_path / "port",
                                                ckpt), log, device="cpu")
    jax_inference_main(_inference_cfg(JaxConfig, root, tmp_path / "jax", ckpt),
                       log)
    assert len(written) == 3
    for path in written:
        name = os.path.basename(path)
        for ext in (".flo", ".npy"):
            ours = read_flo(path) if ext == ".flo" else np.load(path[:-4] + ext)
            jpath = str(tmp_path / "jax" / name)[:-4] + ext
            theirs = read_flo(jpath) if ext == ".flo" else np.load(jpath)
            assert ours.shape == theirs.shape == (80, 144, 2)
            assert np.isfinite(ours).all()
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=PROB_ATOL,
                                       err_msg=name + ext)


def test_export_and_stream_cli_3frame_window(tmp_path):
    """``arflow-torch-stream -c/-m --bw`` on the 3-frame PWCLite over 5
    PNG frames: a ``.flo`` (t-1) -> t and a ``_bw.flo`` (t-1) -> (t-2)
    named after each frame from the third on; ``arflow-torch-export
    --streaming`` then ``--artifact`` writes the same files, bit for bit on
    the CPU."""
    import json

    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    for t, img in enumerate(images(5, seed=4, b=1, dtype=np.float32)):
        Image.fromarray(np.round(img[0] * 255).astype(np.uint8)).save(
            frames / f"frame_{t:03d}.png")
    ckpt = tmp_path / "lite3.pth.tar"
    torch.save({"epoch": 0, "state_dict": get_model(
        LITE3.model, device="cpu", seed=7).state_dict()}, ckpt)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": dict(LITE3.model)}))
    common = ["-c", str(cfg), "-m", str(ckpt)]
    stats = cli.stream_cli([*common, "--frames", str(frames), "--bw",
                            "--out", str(tmp_path / "eager"), "--device", "cpu"])
    assert stats["frames"] == 5 and stats["flows"] == 3
    art = str(tmp_path / "lite3.afx")
    meta = cli.export_cli([*common, "-o", art, "--size", f"{H}x{W}",
                           "--device", "cpu", "--streaming"])
    assert meta["window"] == 3
    cli.stream_cli(["--artifact", art, "--frames", str(frames), "--bw",
                    "--out", str(tmp_path / "artifact")])
    names = sorted(os.listdir(tmp_path / "eager"))
    assert names == sorted(f"frame_{t:03d}{s}.flo" for t in (2, 3, 4)
                           for s in ("", "_bw"))
    assert sorted(os.listdir(tmp_path / "artifact")) == names
    for name in names:
        a = read_flo(str(tmp_path / "eager" / name))
        b = read_flo(str(tmp_path / "artifact" / name))
        assert a.shape == (H, W, 2) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b, err_msg=name)
