"""``PWCFlow`` with ``model.dtype`` int8 against the JAX model in int8 with
the same weights, on a 1x64x96 textured pair moved by (1, 2) pixels, both
directions, per output level: the mean gap to JAX's int8 at most twice
JAX's own int8 gap to float32 plus 1e-3 px, and the port's int8 within the
JAX test's sanity bound of its float32 (``torch_int8_util``)."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import state_dict_from_jax
from torch_bf16_util import jax_cost_volume_round_trip  # noqa: F401  (fixture)
from torch_int8_util import check_int8_levels, int8_forwards, sanity_gaps
from torch_mixture_util import image_pair
from torch_port_util import draw_jax_params, few_torch_threads  # noqa: F401

UFLOW = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}


def test_pwcflow_int8_matches_jax_int8_per_level(monkeypatch):
    """Measured (mean |port int8 - JAX int8| / mean |JAX int8 - port f32|)
    in px, level 0 to 5, forward: 3.84e-2/4.99e-2, 1.93e-2/2.51e-2,
    1.15e-2/1.35e-2, 4.91e-3/6.95e-3, 1.52e-3/1.95e-3, 3.54e-4/5.08e-4;
    backward: 3.39e-2/4.99e-2, 1.72e-2/2.51e-2, 1.09e-2/1.35e-2,
    4.98e-3/6.66e-3, 1.70e-3/2.09e-3, 4.34e-4/4.82e-4 (ratios 0.68-0.90).
    The port's int8 full-resolution flow is at most 0.26 px and on
    average 0.048 px from its float32 one."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    params = draw_jax_params(UFLOW, with_bk=True)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 2))
    port, gaps = int8_forwards(UFLOW, {"params": params},
                               state_dict_from_jax(params, Config(UFLOW)), im1, im2)
    check_int8_levels(gaps)
    sanity_gaps(port)
