"""``model.dtype`` int8 through the port's serving entry points on the CPU,
port only: ``StreamingFlowEngine`` (each push's flows are the int8 model's
forward on that pair, bit for bit), a b1 ``torch.export`` artifact (equal
to the eager int8 model), and ``inference_main`` on a ``uflow_prob`` int8
config writing its ``.flo`` files and entropy ``.npy`` (finite, and within
the JAX test's sanity bound, scaled to the output size, of the float32
config's flows). The int8 models against the JAX ones:
``test_torch_int8_uflow.py`` and the files beside it."""

import logging

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.serving import StreamingFlowEngine
from arflow_tpu_torch.serving.export import (
    export_inference,
    load_artifact,
    save_artifact,
)
from arflow_tpu_torch.utils.flow_io import read_flo
from torch_data_util import make_shifted_chairs_dir
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

H, W = 64, 96
UFLOW8 = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0,
          "dtype": "int8"}
# sintel_uflow_elbo_inference.json's model in int8 and the loss keys
# inference reads.
PROB8 = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.1,
         "out_channels": [2, 2, 0], "inv_cov": False, "n_pyramids": 1,
         "mixture_weights": False, "dtype": "int8"}
PROB_LOSS = {"type": "uflow_elbo", "approx": "diag", "n_components": 1,
             "inv_cov": False}
# tests/test_int8_conv.py's sanity bound of the int8 flow at the network's
# resolution, in px; inference_main's flows at 80x112 from 64x96 are scaled
# by up to 80 / 64.
SANITY_MEAN = 0.1 * 80 / 64


@pytest.fixture(autouse=True)
def no_override(monkeypatch):
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)


@pytest.fixture(scope="module")
def uflow8():
    """The int8 ``uflow`` model with weights from a seed, and 4 b1 frames of
    a texture moving by (1, 2) px per frame."""
    model = get_model(Config(UFLOW8), device="cpu", seed=3)
    rs = np.random.RandomState(3)
    tex = np.kron(rs.rand(H // 8 + 2, W // 8 + 2, 3), np.ones((8, 8, 1)))
    frames = [torch.from_numpy(
        tex[None, 8 - t:8 - t + H, 8 - 2 * t:8 - 2 * t + W].astype(np.float32))
        for t in range(4)]
    return model, frames


def test_stream_int8_equals_the_forward_per_pair(uflow8):
    model, frames = uflow8
    eng = StreamingFlowEngine(Config(UFLOW8), model.state_dict(), with_bw=True,
                              device="cpu")
    outs = [eng.push(f) for f in frames]
    assert outs[0] is None and eng.pyramids_computed == len(frames)
    for t, out in enumerate(outs[1:]):
        with torch.no_grad():
            res = model(frames[t], frames[t + 1], with_bk=True)
        assert out["flow"].dtype == torch.float32
        assert torch.equal(out["flow"], res["flows_fw"][0])
        assert torch.equal(out["flow_bw"], res["flows_bw"][0])


def test_export_int8_b1_equals_eager(uflow8, tmp_path):
    model, frames = uflow8
    cfg = Config({"model": UFLOW8, "loss": {}})
    ep, meta = export_inference(cfg, model.state_dict(), 1, (H, W), device="cpu")
    path = str(tmp_path / "uflow_int8.afx")
    save_artifact(path, ep, meta)
    flow, ent = load_artifact(path)(frames[0], frames[1])
    with torch.no_grad():
        want = model(frames[0], frames[1], with_bk=False)["flows_fw"][0]
    assert flow.dtype == torch.float32 and torch.equal(flow, want)
    assert not ent.any()
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "aten._int_mm.default" in ops


def test_inference_main_prob_int8_writes_flows_and_entropy(tmp_path):
    """``inference_main`` with the int8 ``uflow_prob`` config and with the
    same config in float32, one checkpoint: flows and entropies of the
    int8 run finite and of the data's shape, the flows within
    ``SANITY_MEAN`` of the float32 run's on average (measured: 0.091 to
    0.107 px)."""
    root = make_shifted_chairs_dir(tmp_path / "chairs",
                                   np.random.RandomState(5), 3, 80, 112)
    ckpt = tmp_path / "prob.pth.tar"
    model = get_model(Config(dict(PROB8, dtype=None)), device="cpu", seed=4)
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)
    written = {}
    for name, dtype in (("int8", "int8"), ("f32", None)):
        written[name] = cli.inference_main(Config({
            "seed": 0,
            "data": [{"root_chairs": str(root), "type": "valid",
                      "name": "Chairs", "n_frames": 2, "split": "trainval",
                      "test_shape": [H, W], "out_root": str(tmp_path / name)}],
            "model": dict(PROB8, dtype=dtype), "loss": PROB_LOSS,
            "inference": {"pretrained_model": str(ckpt),
                          "valid_batch_size": 2, "workers": 2}}),
            logging.getLogger("test"), device="cpu")
    assert len(written["int8"]) == 3
    for p8, p32 in zip(written["int8"], written["f32"]):
        flow8, flow32 = read_flo(p8), read_flo(p32)
        ent8 = np.load(p8[:-4] + ".npy")
        for a in (flow8, ent8):
            assert a.shape == (80, 112, 2) and np.isfinite(a).all()
        assert np.abs(flow8 - flow32).mean() < SANITY_MEAN
