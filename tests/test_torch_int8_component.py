"""``ComponentNet`` with ``mixture_weights`` (two ``PWCProbFlow`` nets with
the int8 pyramid, the mixture weights net unquantized in float32) with
``model.dtype`` int8 against the JAX model in int8 with the same weights
and BatchNorm statistics, in eval mode on a 1x64x96 textured pair: both
directions' outputs per level as ``torch_int8_util`` holds them. The
float32 side of the bound is the port's float32 model, which equals JAX's
within 1.4e-5 px at this size (``test_torch_bf16_component.py``), so that
the file compiles one JAX model. With ``out_channels`` [2, 2, 0] the
weights net has one output, so the port's weights are 1."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import jax.numpy as jnp
import numpy as np

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch.models import component_state_dict_from_jax
from torch_bf16_util import jax_cost_volume_round_trip  # noqa: F401  (fixture)
from torch_int8_util import DTYPES, check_int8_levels, int8_forwards, sanity_gaps
from torch_mixture_util import COMPONENT_MIXTURE, draw_variables, image_pair
from torch_port_util import few_torch_threads  # noqa: F401


def test_component_mixture_int8_matches_jax_int8(monkeypatch):
    """Measured (mean |port int8 - JAX int8| / mean |JAX int8 - port
    f32|), level 0 to 5, forward: 2.04e-2/2.57e-2, 1.13e-2/1.44e-2,
    8.02e-3/9.84e-3, 3.95e-3/4.19e-3, 1.83e-3/2.30e-3, 9.30e-4/2.02e-3;
    backward: 2.99e-2/2.74e-2, 1.62e-2/1.53e-2, 1.06e-2/1.01e-2,
    5.17e-3/4.87e-3, 2.76e-3/2.56e-3, 9.45e-4/2.10e-3 (ratios 0.45-1.09).
    Both components' int8 full-resolution flows are at most 0.24 px and
    on average 0.039 px from the float32 ones."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 6))
    img = jnp.zeros(im1.shape, jnp.float32)
    variables = draw_variables(jax_get_model(JaxConfig(COMPONENT_MIXTURE)),
                               (img, img), seed=5, with_bk=True)
    port, gaps = int8_forwards(COMPONENT_MIXTURE, variables,
                               component_state_dict_from_jax(variables), im1,
                               im2)
    check_int8_levels(gaps)
    sanity_gaps(port, channels=slice(0, 4))
    for key in ("weights_fw", "weights_bw"):
        for dt in DTYPES:
            assert port[dt][key].shape == (1, 1)
            np.testing.assert_array_equal(port[dt][key].numpy(), 1.0)
