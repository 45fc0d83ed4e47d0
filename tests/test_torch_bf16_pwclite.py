"""``PWCLite`` with ``model.dtype`` bfloat16 against the JAX model in
bfloat16 with the same weights, on a 1x64x128 pair, both directions, per
output level, with the bounds of ``test_torch_bf16_uflow.py``
(``torch_bf16_util.check_levels``): the mean gap to JAX's bfloat16 at most
twice JAX's own bfloat16 gap plus 1e-3 px, and the port's bfloat16 within
0.05 mean relative of its float32. The JAX side runs its cost volume in
float32 on the bfloat16 features, as its TPU path does."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import arflow_tpu.models.pwclite as jax_pwclite
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import state_dict_from_jax
from torch_bf16_util import check_levels, jax_forwards, port_forwards, round_trip
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import GATES_OFF, draw_params, images

LITE = {"type": "pwclite", "n_frames": 2}


def test_pwclite_bf16_matches_jax_bf16_per_level(monkeypatch):
    """Measured (mean |port bf16 - JAX bf16| / mean |JAX bf16 - JAX f32|)
    in px, level 0 to 5, forward: 3.27e-2/4.40e-2, 8.53e-3/1.06e-2,
    3.45e-3/4.26e-3, 1.61e-3/1.86e-3, 4.16e-4/6.36e-4, 8.39e-5/6.88e-5;
    backward: 3.25e-2/4.31e-2, 8.68e-3/1.06e-2, 3.37e-3/3.94e-3,
    1.32e-3/1.57e-3, 5.19e-4/4.96e-4, 9.92e-5/8.57e-5. The port's bfloat16
    is 0.22-0.40% from its float32."""
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_pwclite, "compute_cost_volume", round_trip)
    params = draw_params(LITE, seed=12)
    im1, im2 = images(2, seed=13, b=1, dtype=np.float32)
    jax_out = jax_forwards(LITE, {"params": params}, im1, im2)
    port = port_forwards(LITE, state_dict_from_jax(params, Config(LITE)),
                         im1, im2)
    gaps = {}
    for key in ("flows_fw", "flows_bw"):
        assert len(port["bfloat16"][key]) == len(jax_out["bfloat16"][key]) == 6
        for lvl in range(6):
            p16, p32 = (port[dt][key][lvl].double().numpy()
                        for dt in ("bfloat16", "float32"))
            j16, j32 = (np.asarray(jax_out[dt][key][lvl], np.float64)
                        for dt in ("bfloat16", "float32"))
            assert port["bfloat16"][key][lvl].dtype == torch.float32
            assert p16.shape == j16.shape and np.isfinite(p16).all()
            gaps[key, lvl] = (np.abs(p16 - j16).mean(), np.abs(j16 - j32).mean(),
                              np.abs(p16 - p32).mean() / np.abs(p32).mean())
    check_levels(gaps)
