"""``PWCFlow`` with ``model.dtype`` bfloat16 against the JAX model in
bfloat16 with the same weights, on a 1x64x96 textured pair moved by (1, 2)
pixels, both directions, per output level: the mean gap to JAX's
bfloat16 at most twice JAX's own bfloat16 gap plus 1e-3 px, and the
port's bfloat16 within 0.05 mean relative of its float32
(``torch_bf16_util``)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import state_dict_from_jax
from torch_bf16_util import (  # noqa: F401  (fixture)
    check_levels,
    jax_cost_volume_round_trip,
    jax_forwards,
    level_gaps,
    port_forwards,
)
from torch_mixture_util import image_pair
from torch_port_util import draw_jax_params, few_torch_threads  # noqa: F401

UFLOW = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}


def test_pwcflow_bf16_matches_jax_bf16_per_level():
    """Measured (mean |port bf16 - JAX bf16| / mean |JAX bf16 - JAX f32|)
    in px, level 0 to 5, forward: 3.55e-2/5.78e-2, 1.77e-2/2.90e-2,
    1.05e-2/1.51e-2, 4.77e-3/7.97e-3, 2.18e-3/1.90e-3, 4.42e-4/3.05e-4;
    backward: 3.72e-2/4.95e-2, 1.84e-2/2.49e-2, 1.07e-2/1.30e-2,
    4.32e-3/6.28e-3, 2.11e-3/1.69e-3, 3.67e-4/3.73e-4. The port's bfloat16
    is 0.44-0.77% from its float32."""
    params = draw_jax_params(UFLOW, with_bk=True)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 2))
    jax_out = jax_forwards(UFLOW, {"params": params}, im1, im2)
    port = port_forwards(UFLOW, state_dict_from_jax(params, Config(UFLOW)),
                         im1, im2)
    gaps = level_gaps(port, jax_out)
    check_levels(gaps)
