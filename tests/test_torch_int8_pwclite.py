"""The PWC-Lite family under ``ARFLOW_INT8_PYRAMID=1``: its pyramid's convs
quantize (``model.dtype: "int8"`` is refused for the family, in both
packages, ``test_torch_int8_conv.py``). ``PWCLite`` in float32 with the
override against the JAX model with it and with ``ARFLOW_WFOLD_PYR=0`` (the
JAX W-fold returns before the int8 check; the port follows the gates-off
math), same weights, a 1x64x128 pair, the forward direction (one JAX
compile of half the graph), per output level:
the mean gap to JAX's quantized model at most twice JAX's own gap to
float32 plus 1e-3 px (``torch_int8_util.check_int8_levels``). The float32
side is the port's float32 model (one JAX compile), which equals JAX's
within 5.7e-6 px here (measured with the same weights and gates)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import state_dict_from_jax
from torch_bf16_util import jax_forwards, level_gaps, port_forwards
from torch_int8_util import check_int8_levels
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import GATES_OFF, draw_params, images

LITE = {"type": "pwclite", "n_frames": 2}


def test_pwclite_int8_override_matches_jax_per_level(monkeypatch):
    """Measured (mean |port - JAX| / mean |JAX quantized - port f32|), both
    in float32: level 0 to 5, 1.36e-6/2.02e-3, 3.01e-7/5.42e-4,
    1.29e-7/2.83e-4, 4.07e-8/1.08e-4, 1.30e-8/1.88e-5, 1.86e-9/1.08e-6:
    the same integers on both sides, the float32 convs around them part by
    rounding."""
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    params = draw_params(LITE, seed=12)
    im1, im2 = images(2, seed=13, b=1, dtype=np.float32)
    sd = state_dict_from_jax(params, Config(LITE))
    port = {}
    for name, env in (("float32", "0"), ("int8", "1")):
        monkeypatch.setenv("ARFLOW_INT8_PYRAMID", env)
        port[name] = port_forwards(LITE, sd, im1, im2, dtypes=("float32",),
                                   with_bk=False)["float32"]
    jax_out = {"int8": jax_forwards(LITE, {"params": params}, im1, im2,
                                    dtypes=("float32",), with_bk=False)["float32"],
               "float32": port["float32"]}
    gaps = level_gaps(port, jax_out, keys=("flows_fw",), low="int8")
    check_int8_levels(gaps)
