"""The port's banded triangular solves and ``inverse_diagonal``
(``arflow_tpu_torch/ops/triag.py``) against ``arflow_tpu.ops.triag`` in
float64, and ``inverse_diagonal`` against diag((L L^T)^-1) built densely in
numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arflow_tpu.ops import triag as jax_triag
from arflow_tpu_torch.ops.triag import (
    backward_substitution,
    forward_substitution,
    inverse_diagonal,
)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

# (B, M, N, C): general, one row, one column, wider than tall.
SHAPES = [(2, 5, 7, 3), (1, 1, 6, 2), (1, 6, 1, 2), (1, 3, 9, 1)]
# Same float64 recurrence on both sides (measured: at most 4.4e-16 on
# solutions of up to 2.5, and 5.6e-16 on variances of up to 1.1, against
# JAX and the dense inverse).
ATOL = 1e-12


def bands(shape, seed, with_d=True):
    """A, B, C, D of a well-conditioned L (diagonal in [1, 2], couplings
    ~0.3) and a right-hand side, NHWC float64."""
    b, m, n, c = shape
    rs = np.random.RandomState(seed)
    out = [rs.rand(b, m, n, c) + 1.0, 0.3 * rs.randn(b, m, n - 1, c),
           0.3 * rs.randn(b, m - 1, n, c)]
    out.append(0.3 * rs.randn(b, m - 1, n - 1, c) if with_d
               else np.zeros((b, m - 1, n - 1, c)))
    return out, rs.randn(b, m, n, c)


def dense_lower(a, b, c, d, bi, ci):
    """The (M*N, M*N) lower-triangular L of one image and channel,
    raster order."""
    m, n = a.shape[1:3]
    L = np.zeros((m * n, m * n))
    for i in range(m):
        for j in range(n):
            p = i * n + j
            L[p, p] = a[bi, i, j, ci]
            if j > 0:
                L[p, p - 1] = b[bi, i, j - 1, ci]
            if i > 0:
                L[p, p - n] = c[bi, i - 1, j, ci]
            if i > 0 and j > 0:
                L[p, p - n - 1] = d[bi, i - 1, j - 1, ci]
    return L


@pytest.mark.parametrize("shape", SHAPES)
def test_substitutions_match_jax_f64(shape):
    abcd, x = bands(shape, seed=sum(shape))
    args_t = [torch.from_numpy(t) for t in abcd + [x]]
    args_j = [jnp.asarray(t) for t in abcd + [x]]
    for ours, theirs in ((forward_substitution, jax_triag.forward_substitution),
                         (backward_substitution, jax_triag.backward_substitution)):
        y = ours(*args_t)
        y_j = np.asarray(theirs(*args_j))
        assert tuple(y.shape) == y_j.shape == shape
        np.testing.assert_allclose(y.numpy(), y_j, rtol=0, atol=ATOL)


def test_substitutions_solve_the_dense_system():
    (a, b, c, d), x = bands((2, 4, 5, 2), seed=3)
    y = forward_substitution(*(torch.from_numpy(t) for t in (a, b, c, d, x)))
    yt = backward_substitution(*(torch.from_numpy(t) for t in (a, b, c, d, x)))
    for bi in range(2):
        for ci in range(2):
            L = dense_lower(a, b, c, d, bi, ci)
            rhs = x[bi, :, :, ci].ravel()
            np.testing.assert_allclose(y[bi, :, :, ci].numpy().ravel(),
                                       np.linalg.solve(L, rhs), rtol=0, atol=ATOL)
            np.testing.assert_allclose(yt[bi, :, :, ci].numpy().ravel(),
                                       np.linalg.solve(L.T, rhs), rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_d", [True, False])
def test_inverse_diagonal_matches_jax_and_dense(with_d):
    shape = (2, 4, 6, 2)
    (a, b, c, d), _ = bands(shape, seed=7, with_d=with_d)
    args = [torch.from_numpy(t) for t in (a, b, c)]
    var = inverse_diagonal(*args, torch.from_numpy(d) if with_d else None)
    # the result does not depend on the chunk size
    var_chunked = inverse_diagonal(*args, torch.from_numpy(d) if with_d else None,
                                   chunk=5)
    var_j = np.asarray(jax_triag.inverse_diagonal(
        *(jnp.asarray(t) for t in (a, b, c)),
        jnp.asarray(d) if with_d else None, chunk=7))
    assert tuple(var.shape) == var_j.shape == shape
    np.testing.assert_allclose(var.numpy(), var_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(var_chunked.numpy(), var.numpy(), rtol=0, atol=ATOL)
    for bi in range(shape[0]):
        for ci in range(shape[3]):
            L = dense_lower(a, b, c, d, bi, ci)
            want = np.diag(np.linalg.inv(L @ L.T))
            np.testing.assert_allclose(var[bi, :, :, ci].numpy().ravel(), want,
                                       rtol=0, atol=ATOL)
