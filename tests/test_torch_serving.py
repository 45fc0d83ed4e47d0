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


# float32 on the CPU: the stream's pyramid (B) and decoder (K*B) batches
# differ from the monolithic forward's (2B and 2K*B), and the convolutions
# round differently for them (measured: at most 1.05e-5 px on flows of up
# to 17.5 px, 3.4e-6 on entropies of up to 6.9).
PROB_ATOL = 1e-4


@pytest.mark.parametrize("model_cfg, loss_cfg", [
    ({"type": "uflow_prob", "out_channels": [2, 2, 0]}, {"approx": "diag"}),
    ({"type": "uflow_prob", "out_channels": [2, 2, 0], "n_pyramids": 2},
     {"approx": "mixture", "n_components": 2}),
], ids=["diag", "mixture_two_pyramids"])
def test_streaming_prob_engine_matches_monolithic(model_cfg, loss_cfg):
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.training.entropy import extract_uv_entropy

    seq = frames(4, seed=5, dtype=np.float32)
    model = get_model(Config(model_cfg), device="cpu", seed=2)
    engine = StreamingFlowEngine(Config(model_cfg), model.state_dict(),
                                 with_bw=True, device="cpu",
                                 loss_cfg=Config(loss_cfg))
    assert engine.push(seq[0]) is None
    for prev, cur in zip(seq, seq[1:]):
        out = engine.push(cur)
        assert sorted(out) == ["entropy", "flow", "flow_bw"]
        with torch.no_grad():
            mono = model(torch.from_numpy(prev), torch.from_numpy(cur),
                         with_bk=True)
        ent = extract_uv_entropy(mono["flows_fw"], Config(loss_cfg), mono,
                                 generator=torch.Generator().manual_seed(0))
        for got, want in ((out["flow"], mono["flows_fw"][0][..., :2]),
                          (out["flow_bw"], mono["flows_bw"][0][..., :2]),
                          (out["entropy"], ent)):
            assert tuple(got.shape) == (1, H, W, 2)
            torch.testing.assert_close(got, want, rtol=0, atol=PROB_ATOL)
    assert engine.pyramids_computed == 4
    # without an approx, no entropy
    plain = StreamingFlowEngine(Config(model_cfg), model.state_dict(),
                                device="cpu", loss_cfg=Config({"type": "uflow"}))
    plain.push(seq[0])
    assert sorted(plain.push(seq[1])) == ["flow"]
    with pytest.raises(ValueError, match="mixture_weights"):
        StreamingFlowEngine(Config(dict(model_cfg, mixture_weights=True)),
                            model.state_dict(), device="cpu")
