"""The port's streaming engine for the PWC-Lite family against the JAX
``StreamingFlowEngine`` and against the port's own monolithic forward, on
5 frames of 1x64x128, float32, the JAX package's TPU relayouts off: the
2-frame ``pwclite`` and ``pwclite_uflow``, the 3-frame ``pwclite`` window
with and without ``with_bw``, and the 5-frame refusal. The artifacts and
``inference_main`` are in ``test_torch_pwclite_export.py``."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.serving import StreamingFlowEngine as JaxStreamingFlowEngine
from arflow_tpu_torch import Config
from arflow_tpu_torch.serving import StreamingFlowEngine
from arflow_tpu_torch.serving.engine import FIVE_FRAMES_NOT_STREAMED
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import (  # noqa: F401  (fixture: lite_env)
    H,
    W,
    draw_params,
    images,
    lite_env,
    port_model,
    run_port,
)

# float32 port against float32 JAX: measured at most 9.5e-6 px on flows of
# up to 20.0 px (pwclite), 1.1e-5 on 10.1 (pwclite_uflow), 3.8e-6 on 7.7
# (the 3-frame window); the bound of tests/test_torch_serving.py.
JAX_ATOL = 1e-4
# float32 engine against the port's monolithic forward on the same frames:
# the same modules on the same inputs (measured: equal bit for bit).
MONO_ATOL = 1e-6


def _engines(cfg, with_bw, seed):
    params = draw_params(cfg, seed=seed)
    sd = port_model(cfg, params).state_dict()
    engine = StreamingFlowEngine(Config(cfg), sd, with_bw=with_bw,
                                 device="cpu")
    jengine = JaxStreamingFlowEngine(JaxConfig(cfg), {"params": params},
                                     with_bw=with_bw)
    return engine, jengine, port_model(cfg, params, torch.float32)


@pytest.mark.parametrize("cfg", [
    {"type": "pwclite", "n_frames": 2},
    {"type": "pwclite_uflow", "n_frames": 2, "feature_norm": True}],
    ids=["pwclite", "pwclite_uflow"])
def test_2frame_engine_matches_jax_and_monolithic(lite_env, cfg):
    seq = images(5, seed=7, b=1, dtype=np.float32)
    engine, jengine, model = _engines(cfg, True, seed=10)
    assert engine.window == 2
    assert engine.push(seq[0]) is None and jengine.push(seq[0]) is None
    for prev, cur in zip(seq, seq[1:]):
        out, jout = engine.push(cur), jengine.push(cur)
        mono = run_port(model, [prev, cur], with_bk=True)
        assert sorted(out) == sorted(jout) == ["flow", "flow_bw"]
        for key, mkey in (("flow", "flows_fw"), ("flow_bw", "flows_bw")):
            assert tuple(out[key].shape) == (1, H, W, 2)
            torch.testing.assert_close(out[key], mono[mkey][0], rtol=0,
                                       atol=MONO_ATOL)
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                       rtol=0, atol=JAX_ATOL)
    assert engine.pyramids_computed == 5


@pytest.mark.parametrize("with_bw", [False, True])
def test_3frame_window_matches_jax_and_monolithic(lite_env, with_bw):
    """The window centred on the previous frame: nothing for the first two
    frames, then 'flow' (t-1) -> t and with ``with_bw`` 'flow_bw'
    (t-1) -> (t-2), one pyramid per frame."""
    cfg = {"type": "pwclite", "n_frames": 3}
    seq = images(5, seed=8, b=1, dtype=np.float32)
    engine, jengine, model = _engines(cfg, with_bw, seed=11)
    assert engine.window == 3
    for t in range(2):
        assert engine.push(seq[t]) is None and jengine.push(seq[t]) is None
    keys = ["flow", "flow_bw"] if with_bw else ["flow"]
    for t in range(2, 5):
        out, jout = engine.push(seq[t]), jengine.push(seq[t])
        mono = run_port(model, seq[t - 2:t + 1])
        assert sorted(out) == sorted(jout) == keys
        for key, mkey in (("flow", "flows_fw"), ("flow_bw", "flows_bw")):
            if key not in keys:
                continue
            assert tuple(out[key].shape) == (1, H, W, 2)
            torch.testing.assert_close(out[key], mono[mkey][0], rtol=0,
                                       atol=MONO_ATOL)
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                       rtol=0, atol=JAX_ATOL)
    assert engine.pyramids_computed == 5
    engine.reset()
    assert engine.push(seq[0]) is None and engine.push(seq[1]) is None
    assert engine.push(seq[2]) is not None


def test_5frame_is_not_streamed_in_either_package():
    cfg = {"type": "pwclite", "n_frames": 5}
    with pytest.raises(ValueError) as ours:
        StreamingFlowEngine(Config(cfg), {}, device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxStreamingFlowEngine(JaxConfig(cfg), {"params": {}})
    assert str(ours.value) == str(theirs.value) == FIVE_FRAMES_NOT_STREAMED
