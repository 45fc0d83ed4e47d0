"""``PWCProbFlow`` (``sintel_uflow_elbo*.json``'s ``[2, 2, 0]`` outputs:
flows and log-diagonals) with ``model.dtype`` bfloat16 against the JAX
model in bfloat16 with the same weights, on a 1x64x96 textured pair, both
directions, per output level: the mean gap to JAX's bfloat16 at most twice
JAX's own bfloat16 gap plus 1e-3, and the port's bfloat16 within 0.05 mean
relative of its float32 (``torch_bf16_util``)."""

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

PROB = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
        "out_channels": [2, 2, 0]}


def test_pwcprobflow_bf16_matches_jax_bf16_per_level():
    """Measured (mean |port bf16 - JAX bf16| / mean |JAX bf16 - JAX f32|),
    level 0 to 5, forward: 1.78e-2/2.98e-2, 9.58e-3/1.61e-2,
    6.32e-3/9.64e-3, 3.40e-3/4.38e-3, 1.51e-3/2.66e-3, 1.51e-3/2.01e-3;
    backward: 1.88e-2/2.64e-2, 1.01e-2/1.48e-2, 6.84e-3/9.65e-3,
    3.46e-3/4.38e-3, 1.60e-3/2.75e-3, 1.41e-3/1.92e-3. The port's bfloat16
    is 0.34-1.03% from its float32."""
    params = draw_jax_params(PROB, with_bk=True)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 4))
    jax_out = jax_forwards(PROB, {"params": params}, im1, im2)
    port = port_forwards(PROB, state_dict_from_jax(params, Config(PROB)),
                         im1, im2)
    gaps = level_gaps(port, jax_out)
    check_levels(gaps)
