"""Shared set-up of the tests that hold the port's ``model.dtype`` int8
models to ``arflow_tpu``'s: the JAX int8 forward and the port's float32
and int8 forwards from one set of JAX weights, with the JAX cost volume's
float32 round trip and its relayouts off (``torch_bf16_util``), and the
per-level bounds.

The float32 side of the bound is the port's float32 forward, so that a
file compiles one JAX model: at these inputs it equals JAX's float32
within 1.7e-5 px (``uflow``) and 1.6e-5 (``uflow_prob``), measured with
the relayouts off and the same cost volume (``test_torch_uflow_f32.py``
holds it to 1.5e-5 with them on), against int8 gaps of 5e-4 px and more."""

import numpy as np

from torch_bf16_util import KEYS, jax_forwards, level_gaps, port_forwards

DTYPES = ("float32", "int8")
# The JAX package's sanity bound of its int8 UFlow against the exact one at
# random weights (tests/test_int8_conv.py:test_uflow_forward_int8_pyramid),
# on the full-resolution flow, in px.
SANITY_MAX, SANITY_MEAN = 1.0, 0.1


def int8_forwards(cfg, variables, state_dict, im1, im2):
    """(port, gaps): {dtype: the port's eval forward, ``with_bk=True``} for
    float32 and int8 from ``state_dict``, and ``level_gaps`` of the port's
    int8 against JAX's int8 forward from ``variables``, JAX's float32 side
    being the port's float32 forward."""
    port = port_forwards(cfg, state_dict, im1, im2, dtypes=DTYPES)
    jax_out = jax_forwards(cfg, variables, im1, im2, dtypes=("int8",))
    jax_out["float32"] = port["float32"]
    return port, level_gaps(port, jax_out, low="int8")


def check_int8_levels(gaps):
    """At every key and level, the port's int8 within 2 x JAX's own int8
    gap to float32 + 1e-3 px of JAX's int8 (mean |.|), the form of
    ``torch_bf16_util.check_levels``."""
    bad = {k: v for k, v in gaps.items() if not v[0] <= 2 * v[1] + 1e-3}
    assert not bad, bad


def sanity_gaps(port, channels=slice(0, 2)):
    """Per direction, (max, mean) |port int8 - port float32| of the
    full-resolution output's flow ``channels``, checked against
    ``SANITY_MAX`` / ``SANITY_MEAN``."""
    out = {}
    for key in KEYS:
        d = np.abs((port["int8"][key][0] - port["float32"][key][0])
                   [..., channels].double().numpy())
        out[key] = (float(d.max()), float(d.mean()))
        assert out[key][0] < SANITY_MAX and out[key][1] < SANITY_MEAN, out
    return out
