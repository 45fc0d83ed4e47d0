"""The port's loss ops (``image_grads``, census, the range map) against
``arflow_tpu.ops``: values, and gradients where the loss takes one.

Inputs come from ``np.random.RandomState`` and go to both packages as numpy
arrays, in float64 (x64 is on, ``tests/conftest.py``) and in float32. The
JAX ops are NHWC, the port's NCHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu import ops as jops
from arflow_tpu_torch import ops as tops
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


def _t(x_nhwc, grad=False):
    """numpy NHWC -> torch NCHW."""
    t = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    return t.requires_grad_(grad)


def _n(x_nchw):
    """torch NCHW -> numpy NHWC."""
    return x_nchw.detach().numpy().transpose(0, 2, 3, 1)


# float64: the same arithmetic, summation orders apart. float32: the JAX
# package's own float32 rounding against torch's, on values of order 1-10.
TOL = {np.float64: 1e-12, np.float32: 2e-5}
DTYPES = [np.float64, np.float32]


@pytest.mark.parametrize("stride", [1, 2])
def test_image_grads(stride):
    x = np.random.RandomState(0).randn(2, 7, 9, 3)
    for a, b in zip(tops.image_grads(_t(x), stride),
                    jops.image_grads(jnp.asarray(x), stride)):
        np.testing.assert_array_equal(_n(a), np.asarray(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 12, 17, 3), (1, 5, 4, 3)])
def test_census_transform(shape, dtype):
    """Maps narrower than the 7x7 patch included."""
    img = np.random.RandomState(1).rand(*shape).astype(dtype)
    ref = np.asarray(jops.census_transform(jnp.asarray(img)))
    ours = _n(tops.census_transform(_t(img)))
    assert ours.shape == ref.shape == shape[:3] + (49,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("num_groups", [1, 2])
def test_census_loss_and_grad(num_groups, dtype):
    """Loss and its gradient with respect to the reconstruction (the image
    the flow warps), with a random mask and a border."""
    rs = np.random.RandomState(2)
    a = rs.rand(4, 14, 19, 3).astype(dtype)
    b = np.clip(a + 0.1 * rs.randn(*a.shape), 0, 1).astype(dtype)
    mask = (rs.rand(4, 14, 19, 1) > 0.3).astype(dtype)

    def jloss(bb):
        return jnp.sum(jops.census_loss(jnp.asarray(a), bb, jnp.asarray(mask),
                                        num_groups=num_groups))

    ref, ref_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(b))
    tb = _t(b, grad=True)
    ours = tops.census_loss(_t(a), tb, _t(mask), num_groups=num_groups)
    assert tuple(ours.shape) == (() if num_groups == 1 else (num_groups,))
    ours.sum().backward()
    np.testing.assert_allclose(float(ours.detach().sum()), float(ref),
                               rtol=TOL[dtype])
    scale = float(np.abs(np.asarray(ref_grad)).max())
    np.testing.assert_allclose(_n(tb.grad), np.asarray(ref_grad), rtol=0,
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 11), (1, 1, 5), (1, 3, 1)])
def test_compute_range_map_and_grad(shape, dtype):
    """Flows that reach out of the image on every side, integer endpoints,
    and maps of one row or column; gradient of a weighted sum with respect
    to the flow."""
    rs = np.random.RandomState(3)
    b, h, w = shape
    flow = rs.uniform(-3, 3, (b, h, w, 2))
    flow[0, 0, 0] = (1.0, 0.0)  # an integer endpoint
    flow[0, -1, -1] = (-0.25, -0.5)  # an endpoint inside any map
    flow = flow.astype(dtype)
    weights = rs.rand(b, h, w, 1).astype(dtype)

    def jfn(f):
        return jnp.sum(jops.compute_range_map(f) * weights)

    ref_map = np.asarray(jops.compute_range_map(jnp.asarray(flow)))
    ref_grad = np.asarray(jax.jit(jax.grad(jfn))(jnp.asarray(flow)))
    tf = _t(flow, grad=True)
    ours = tops.compute_range_map(tf)
    (ours * _t(weights)).sum().backward()
    assert _n(ours).shape == ref_map.shape == (b, h, w, 1)
    np.testing.assert_allclose(_n(ours), ref_map, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(_n(tf.grad), ref_grad, rtol=0,
                               atol=TOL[dtype])
    assert ref_map.max() > 0


def test_compute_range_map_non_finite_flow():
    """A NaN or infinite flow (a diverged step) splats nothing, as in the
    JAX package, instead of indexing out of range, so that the trainer's
    NaN guard can report the step."""
    flow = np.random.RandomState(4).uniform(-1, 1, (2, 5, 6, 2))
    flow[0, 1, 2] = (np.nan, 0.5)
    flow[1, 3, 3] = (0.5, np.inf)
    flow[1, 0, 0] = (-np.inf, np.nan)
    ref = np.asarray(jops.compute_range_map(jnp.asarray(flow)))
    ours = _n(tops.compute_range_map(_t(flow)))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
