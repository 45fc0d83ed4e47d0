"""``ComponentNet`` with ``mixture_weights`` (two ``PWCProbFlow`` nets in
bfloat16, the mixture weights net in float32) with ``model.dtype``
bfloat16 against the JAX model in bfloat16 with the same weights and
BatchNorm statistics, in eval mode on a 1x64x96 textured pair: both
directions' outputs per level as ``torch_bf16_util`` holds them. The
float32 side of the bound is the port's float32 model, which equals JAX's
within 1.4e-5 px at this size (``test_torch_mixture_weights.py`` holds the
two in float64), so that the file compiles one JAX model. With
``out_channels`` [2, 2, 0] the weights net has one output, so both
packages' weights are 1."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import jax.numpy as jnp
import numpy as np

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch.models import component_state_dict_from_jax
from torch_bf16_util import (  # noqa: F401  (fixture)
    check_levels,
    jax_cost_volume_round_trip,
    jax_forwards,
    level_gaps,
    port_forwards,
)
from torch_mixture_util import COMPONENT_MIXTURE, draw_variables, image_pair
from torch_port_util import few_torch_threads  # noqa: F401


def test_component_mixture_bf16_matches_jax_bf16():
    """Measured (mean |port bf16 - JAX bf16| / mean |JAX bf16 - port
    f32|), level 0 to 5, forward: 2.58e-2/2.48e-2, 1.43e-2/1.39e-2,
    9.33e-3/9.50e-3, 4.84e-3/4.34e-3, 2.70e-3/2.45e-3, 1.19e-3/1.82e-3;
    backward: 2.44e-2/2.57e-2, 1.32e-2/1.43e-2, 8.65e-3/9.34e-3,
    4.55e-3/4.24e-3, 2.02e-3/2.29e-3, 1.18e-3/1.81e-3. The port's bfloat16
    is 0.28-0.64% from its float32."""
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, 6))
    img = jnp.zeros(im1.shape, jnp.float32)
    variables = draw_variables(jax_get_model(JaxConfig(COMPONENT_MIXTURE)),
                               (img, img), seed=5, with_bk=True)
    port = port_forwards(COMPONENT_MIXTURE,
                         component_state_dict_from_jax(variables), im1, im2)
    jax_out = jax_forwards(COMPONENT_MIXTURE, variables, im1, im2,
                           dtypes=("bfloat16",))
    jax_out["float32"] = port["float32"]
    gaps = level_gaps(port, jax_out)
    check_levels(gaps)
    for key in ("weights_fw", "weights_bw"):
        for dt in ("bfloat16", "float32"):
            assert port[dt][key].shape == (1, 1)
            np.testing.assert_array_equal(port[dt][key].numpy(), 1.0)
        np.testing.assert_array_equal(np.asarray(jax_out["bfloat16"][key]), 1.0)
