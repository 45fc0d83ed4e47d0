"""``PWCProbFlow`` (``sintel_uflow_elbo*.json``'s ``[2, 2, 0]`` outputs:
flows and log-diagonals) with ``model.dtype`` int8 against the JAX model in
int8 with the same weights, on a 1x64x96 textured pair, both directions,
per output level: the mean gap to JAX's int8 at most twice JAX's own int8
gap to float32 plus 1e-3 (``torch_int8_util``), and the flows within the
JAX test's sanity bound of the port's float32."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import state_dict_from_jax
from torch_bf16_util import jax_cost_volume_round_trip  # noqa: F401  (fixture)
from torch_int8_util import check_int8_levels, int8_forwards, sanity_gaps
from torch_mixture_util import image_pair
from torch_port_util import draw_jax_params, few_torch_threads  # noqa: F401

PROB = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
        "out_channels": [2, 2, 0]}


def test_pwcprobflow_int8_matches_jax_int8_per_level(monkeypatch):
    """Measured (mean |port int8 - JAX int8| / mean |JAX int8 - port f32|),
    level 0 to 5, forward: 2.79e-2/3.46e-2, 1.51e-2/1.87e-2,
    9.64e-3/1.15e-2, 5.52e-3/5.81e-3, 2.26e-3/2.92e-3, 1.49e-3/2.01e-3;
    backward: 2.37e-2/3.38e-2, 1.33e-2/1.86e-2, 8.92e-3/1.16e-2,
    4.85e-3/5.36e-3, 3.03e-3/3.14e-3, 1.90e-3/2.06e-3 (ratios 0.70-0.97).
    The port's int8 full-resolution flow is at most 0.20 px and on average
    0.047 px from its float32 one."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    params = draw_jax_params(PROB, with_bk=True)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 4))
    port, gaps = int8_forwards(PROB, {"params": params},
                               state_dict_from_jax(params, Config(PROB)), im1, im2)
    check_int8_levels(gaps)
    sanity_gaps(port)
