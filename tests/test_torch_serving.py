"""The port's streaming engine against the JAX ``StreamingFlowEngine`` and
against the port's own monolithic forward, on 4 frames of 1x64x96."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.serving import StreamingFlowEngine as JaxStreamingFlowEngine
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import uflow_state_dict_from_jax
from arflow_tpu_torch.serving import StreamingFlowEngine
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    H,
    W,
    frames,
    few_torch_threads,
    jax_params,
    port_model,
)


def test_streaming_engine_matches_jax_and_monolithic(jax_params):
    seq = frames(4, seed=3, dtype=np.float32)
    engine = StreamingFlowEngine(Config(CFG), uflow_state_dict_from_jax(jax_params),
                                 with_bw=True, device="cpu")
    jengine = JaxStreamingFlowEngine(JaxConfig(CFG), {"params": jax_params},
                                     with_bw=True)
    model = port_model(jax_params)
    assert engine.push(seq[0]) is None
    assert jengine.push(seq[0]) is None
    for prev, cur in zip(seq, seq[1:]):
        out = engine.push(cur)
        jout = jengine.push(cur)
        with torch.no_grad():
            mono = model(torch.from_numpy(prev), torch.from_numpy(cur),
                         with_bk=True)
        assert sorted(out) == ["flow", "flow_bw"]
        for key, mkey in (("flow", "flows_fw"), ("flow_bw", "flows_bw")):
            assert tuple(out[key].shape) == (1, H, W, 2)
            # The same modules on the same inputs as the monolithic forward.
            torch.testing.assert_close(out[key], mono[mkey][0], rtol=0,
                                       atol=1e-6)
            # float32 against the JAX engine (relayouts on there): the bound
            # of test_torch_uflow_f32.py.
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                       rtol=0, atol=1e-4)
    assert engine.pyramids_computed == 4
    engine.reset()
    assert engine.push(seq[0]) is None
    assert engine.pyramids_computed == 5
