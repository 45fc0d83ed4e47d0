"""The port's PWCFlow against ``arflow_tpu`` in float32 with the JAX
package's inference defaults (its TPU relayouts on), full default widths,
1x64x96 pair."""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax.numpy as jnp

from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    frames,
    few_torch_threads,
    jax_forward,
    jax_params,
    max_gap,
    port_model,
)


@pytest.mark.parametrize("with_bk", [False, True])
def test_pwcflow_matches_jax_f32_defaults(jax_params, with_bk):
    img1, img2 = frames(2, seed=2, dtype=np.float32)
    res_j = jax_forward(jax_params, img1, img2, with_bk, jnp.float32)
    with torch.no_grad():
        res_t = port_model(jax_params)(
            torch.from_numpy(img1), torch.from_numpy(img2), with_bk=with_bk)
    # float32 through 4 decoder levels, with the W-fold pyramid, pyramid
    # batching and the H-fold decoder on the JAX side: other summation
    # orders (measured: max 1.5e-5 px).
    assert max_gap(res_t, res_j, with_bk) < 1e-4
