"""The port's PWCFlow, weight conversion and checkpoint loading against
``arflow_tpu`` at full default widths on a 1x64x96 pair, in float64 with the
JAX package's TPU relayouts off.

The float32 comparison with the JAX inference defaults is in
``test_torch_uflow_f32.py`` and the streaming engine in
``test_torch_serving.py``; each file compiles the JAX model anew, so they
are kept apart to keep each file short.
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models.torch_export import export_uflow, save_torch_checkpoint
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import (
    get_model,
    load_pretrained,
    uflow_state_dict_from_jax,
)
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    frames,
    few_torch_threads,
    jax_forward,
    jax_params,
    max_gap,
    port_model,
)

GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_PYR_BATCH": "0", "ARFLOW_HFOLD": "0"}


def test_state_dict_equals_export_uflow(jax_params):
    ours = uflow_state_dict_from_jax(jax_params)
    ref = export_uflow(jax_params)
    assert len(ours) == len(ref) == 102
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = get_model(Config(CFG), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert sorted(model.state_dict()) == sorted(ref)


@pytest.mark.parametrize("with_bk", [False, True])
def test_pwcflow_matches_jax_f64_gates_off(jax_params, monkeypatch, with_bk):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    img1, img2 = frames(2, seed=1)
    res_j = jax_forward(jax_params, img1, img2, with_bk, jnp.float64)
    with torch.no_grad():
        res_t = port_model(jax_params, torch.float64)(
            torch.from_numpy(img1), torch.from_numpy(img2), with_bk=with_bk)
    # Same float64 math on both sides; only summation orders differ
    # (measured: max 2.5e-14 px, on flows of up to 19 px).
    assert max_gap(res_t, res_j, with_bk) < 1e-10


def test_load_pretrained_strict_round_trip(jax_params, tmp_path):
    """A ``.pth.tar`` as ``arflow-to-torch`` writes it loads strictly."""
    path = str(tmp_path / "uflow.pth.tar")
    save_torch_checkpoint(path, jax_params, JaxConfig(CFG), epoch=3)
    model = load_pretrained(path, Config(CFG), device="cpu")
    expected = uflow_state_dict_from_jax(jax_params)
    got = model.state_dict()
    assert sorted(got) == sorted(expected)
    for k, v in expected.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # A JAX .msgpack loads too (tests/test_torch_to_torch.py); another
    # suffix raises.
    with pytest.raises(ValueError, match="not a .pth"):
        load_pretrained(str(tmp_path / "ckpt.bin"), Config(CFG),
                        device="cpu")
