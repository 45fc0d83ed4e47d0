"""The port's warp, resize and normalization ops against ``arflow_tpu.ops``.

Inputs come from ``np.random.RandomState`` and go to both packages as numpy
arrays, in float64 (x64 is on, ``tests/conftest.py``). The JAX ops are NHWC,
the port's NCHW.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arflow_tpu import ops as jops
from arflow_tpu_torch import ops as tops
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


def _t(x_nhwc):
    """numpy NHWC -> torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _n(x_nchw):
    """torch NCHW -> numpy NHWC."""
    return x_nchw.detach().numpy().transpose(0, 2, 3, 1)


# Same float64 arithmetic on both sides, up to summation order and the
# port's round trip through grid_sample's normalized coordinates.
F64_TOL = 1e-12


def test_flow_to_warp_and_mask_invalid():
    rs = np.random.RandomState(1)
    flow = rs.uniform(-3, 3, (2, 5, 7, 2))
    coords_j = np.asarray(jops.flow_to_warp(jnp.asarray(flow)))
    coords_t = tops.flow_to_warp(_t(flow))
    np.testing.assert_allclose(_n(coords_t), coords_j, rtol=0, atol=F64_TOL)
    # Coordinates on, inside and outside each border: the mask is exact.
    coords = np.round(rs.uniform(-2, 9, (2, 5, 7, 2)) * 2) / 2
    coords[0, 0, 0] = (0.0, 0.0)
    coords[0, 0, 1] = (6.0, 4.0)
    coords[0, 0, 2] = (-1e-9, 4.0)
    np.testing.assert_array_equal(
        _n(tops.mask_invalid(_t(coords))),
        np.asarray(jops.mask_invalid(jnp.asarray(coords))))


@pytest.mark.parametrize("shape", [(2, 9, 11, 3), (1, 1, 5, 3), (1, 4, 1, 2),
                                   (1, 1, 1, 2)])
def test_resample_matches_jax(shape):
    """Includes coordinates outside the image (zeros per tap) and maps with
    a side of 1, where grid_sample's normalization needs the zero pad."""
    rs = np.random.RandomState(2)
    b, h, w, c = shape
    source = rs.randn(b, h, w, c)
    coords = np.stack([rs.uniform(-2.5, w + 1.5, (b, h, w)),
                       rs.uniform(-2.5, h + 1.5, (b, h, w))], axis=-1)
    coords[0, 0, 0] = (w - 1.0, h - 1.0)  # the last pixel exactly
    out_j = np.asarray(jops.resample(jnp.asarray(source), jnp.asarray(coords)))
    out_t = tops.resample(_t(source), _t(coords))
    np.testing.assert_allclose(_n(out_t), out_j, rtol=0, atol=F64_TOL)
    assert np.abs(out_j).max() > 0


@pytest.mark.parametrize("is_flow", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 10, 2), (1, 7, 11, 3)])
def test_upsample_downsample_match_jax(shape, is_flow):
    rs = np.random.RandomState(3)
    x = rs.randn(*shape)
    for jfn, tfn in ((jops.upsample, tops.upsample),
                     (jops.downsample, tops.downsample)):
        out_j = np.asarray(jfn(jnp.asarray(x), is_flow=is_flow))
        out_t = tfn(_t(x), is_flow=is_flow)
        assert _n(out_t).shape == out_j.shape
        # The JAX package stores interpolation weights in float32
        # (ops/resize.py:_resize_matrix); weights that are not dyadic (the
        # odd-size downsample) agree to float32 rounding only.
        np.testing.assert_allclose(_n(out_t), out_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 5, 6, 8), (1, 12, 20, 32),
                                   (1, 2, 3, 32), (3, 1, 1, 4)])
def test_normalize_features_matches_jax(shape):
    """The one setting UFlow uses (feature_norm): centre and scale, moments
    across channels and across the two images."""
    rs = np.random.RandomState(4)
    f1 = rs.randn(*shape) * 3 + 1
    f2 = rs.randn(*shape) * 0.5 - 2
    out_j = jops.normalize_features(
        [jnp.asarray(f1), jnp.asarray(f2)], normalize=True, center=True,
        moments_across_channels=True, moments_across_images=True)
    out_t = tops.normalize_features(_t(f1), _t(f2))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("pad", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 9, 11, 3), (1, 1, 5, 3), (1, 4, 1, 2)])
def test_flow_warp_matches_jax(shape, pad, align_corners):
    """The PWC-Lite family's warp: flows that carry samples outside the
    image (zeros per tap, or clamped to the border), both align_corners
    conventions, and maps with a side of 1."""
    rs = np.random.RandomState(4)
    b, h, w, c = shape
    x = rs.randn(b, h, w, c)
    flow = rs.uniform(-3.0, 3.0, (b, h, w, 2))
    out_j = np.asarray(jops.flow_warp(jnp.asarray(x), jnp.asarray(flow),
                                      pad=pad, align_corners=align_corners))
    out_t = tops.flow_warp(_t(x), _t(flow), pad=pad,
                           align_corners=align_corners)
    np.testing.assert_allclose(_n(out_t), out_j, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("what", ["flow", "log_var"])
def test_resize_bilinear_align_corners_matches_jax(factor, what):
    """``resize_bilinear(align_corners=True)`` as the PWC-Lite family
    upsamples: a flow scaled by the factor, a log-variance with the bias
    ``2 log factor``. The JAX package rounds its interpolation weights to
    float32 (``arflow_tpu/ops/resize.py:_resize_matrix``); the port's
    ``F.interpolate`` computes them in the input's float64, so the two part
    by that rounding: measured at most 5.7e-7 on values up to 11.7."""
    rs = np.random.RandomState(5)
    x = rs.uniform(-3.0, 3.0, (2, 6, 10, 2))
    scale, bias = ((float(factor), 0.0) if what == "flow"
                   else (1.0, 2 * np.log(factor)))
    size = (6 * factor, 10 * factor)
    out_j = np.asarray(jops.resize_bilinear(jnp.asarray(x) * scale + bias,
                                            size, align_corners=True))
    out_t = tops.resize_bilinear(_t(x) * scale + bias, size,
                                 align_corners=True)
    assert _n(out_t).shape == out_j.shape == (2, *size, 2)
    np.testing.assert_allclose(_n(out_t), out_j, rtol=0, atol=1e-6)
