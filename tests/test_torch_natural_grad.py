"""The natural-gradient machinery of ``arflow_tpu_torch.ops.triag``
(``natural_gradient``, the identities ``natural_gradient_identity_t`` /
``_c`` and ``inverse_l1norm``) and the penalties' derivatives of
``ops/penalties.py`` against ``arflow_tpu`` in float64, on well-conditioned
bands (``test_torch_triag.bands``: diagonal in [1, 2], couplings ~0.3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.ops import penalties as jax_penalties
from arflow_tpu.ops import triag as jax_triag
from arflow_tpu_torch.ops import penalties
from arflow_tpu_torch.ops.triag import (
    inverse_l1norm,
    natural_gradient,
    natural_gradient_identity_c,
    natural_gradient_identity_t,
)
from test_torch_triag import bands, dense_lower
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

SHAPES = [(2, 5, 6, 2), (1, 3, 4, 1)]
IDENTITIES = {"t": (natural_gradient_identity_t, jax_triag.natural_gradient_identity_t),
              "c": (natural_gradient_identity_c, jax_triag.natural_gradient_identity_c)}
# The same float64 products and solves on both sides, summation orders
# apart: measured at most 1.6e-16 of the largest element, and
# ``inverse_l1norm`` equal.
RTOL = 1e-9


def assert_close_rel(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=name)


def abc(shape, seed):
    (a, b, c, _), x = bands(shape, seed)
    return [a, b, c, x]


@pytest.mark.parametrize("kind", sorted(IDENTITIES))
@pytest.mark.parametrize("shape", SHAPES)
def test_identity_backward_matches_jax_vjp(kind, shape):
    """Forward: the inputs unchanged. Backward of seeded cotangents on all
    four outputs: the mean's gradient solved (``_t``) or multiplied
    (``_c``) through L and L^T, the bands' through ``natural_gradient``."""
    port, jax_fn = IDENTITIES[kind]
    args = abc(shape, seed=21)
    rs = np.random.RandomState(22)
    cots = [rs.randn(*t.shape) for t in args]
    outs_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in args))
    grads_j = vjp(tuple(jnp.asarray(g) for g in cots))
    leaves = [torch.tensor(t, requires_grad=True) for t in args]
    outs_t = port(*leaves)
    for o_t, o_j, t in zip(outs_t, outs_j, args):
        np.testing.assert_array_equal(o_t.detach().numpy(), np.asarray(o_j))
        np.testing.assert_array_equal(o_t.detach().numpy(), t)
    torch.autograd.backward(outs_t, [torch.from_numpy(g) for g in cots])
    for name, leaf, g_j in zip("abcx", leaves, grads_j):
        assert_close_rel(leaf.grad.numpy(), g_j, f"{kind}: d{name}")


@pytest.mark.parametrize("kind", sorted(IDENTITIES))
def test_identity_backward_with_unused_outputs(kind):
    """Only the mean ``x`` reaches the loss: the bands' gradients are
    ``natural_gradient`` of zeros (zeros), as JAX's with zero cotangents,
    and x's gradient is JAX's."""
    port, jax_fn = IDENTITIES[kind]
    args = abc(SHAPES[0], seed=23)
    dx = np.random.RandomState(24).randn(*args[3].shape)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in args))
    grads_j = vjp(tuple(jnp.zeros_like(jnp.asarray(t)) for t in args[:3])
                  + (jnp.asarray(dx),))
    leaves = [torch.tensor(t, requires_grad=True) for t in args]
    (port(*leaves)[3] * torch.from_numpy(dx)).sum().backward()
    for name, leaf, g_j in zip("abcx", leaves, grads_j):
        assert_close_rel(leaf.grad.numpy(), g_j, f"{kind}: d{name}")
    assert not leaves[0].grad.abs().max() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_natural_gradient_matches_jax(shape):
    ta, tb, tc, _ = abc(shape, seed=25)
    rs = np.random.RandomState(26)
    ga, gb, gc = (rs.randn(*t.shape) for t in (ta, tb, tc))
    want = jax_triag.natural_gradient(*(jnp.asarray(t) for t in (ga, gb, gc, ta, tb, tc)))
    got = natural_gradient(*(torch.from_numpy(t) for t in (ga, gb, gc, ta, tb, tc)))
    for name, g, w in zip(("q_ll", "q_l1l", "q_lnl"), got, want):
        assert_close_rel(g.numpy(), w, name)


@pytest.mark.parametrize("coupling", [0.3, 0.9])
def test_inverse_l1norm_matches_jax(coupling):
    """Higham's estimate on one 5x6 lattice equals JAX's, and lies at or
    below the dense ||L^-1||_1 (it is a lower bound) and within a factor
    of 3 of it (measured: both couplings settle in the second iteration,
    on the dense norm)."""
    (a, b, c, d), _ = bands((1, 5, 6, 1), seed=27, with_d=False)
    b, c = b * coupling / 0.3, c * coupling / 0.3
    a2, b2, c2 = a[0, ..., 0], b[0, ..., 0], c[0, ..., 0]
    want = jax_triag.inverse_l1norm(*(jnp.asarray(t) for t in (a2, b2, c2)))
    got = inverse_l1norm(*(torch.from_numpy(t) for t in (a2, b2, c2)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    exact = np.abs(np.linalg.inv(dense_lower(a, b, c, d, 0, 0))).sum(axis=0).max()
    assert got <= exact * (1 + 1e-12) and got >= exact / 3


def test_penalty_derivatives_match_jax():
    """``identity_prime`` and ``charbonnier_prime`` (default eps and a
    given one) on squared residuals, and ``get_penalty(name, True)``."""
    x = np.random.RandomState(28).rand(3, 7, 5) ** 2 * 4.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    cases = [(penalties.identity_prime(tx), jax_penalties.identity_prime(jx)),
             (penalties.charbonnier_prime(tx), jax_penalties.charbonnier_prime(jx)),
             (penalties.charbonnier_prime(tx, eps=0.1),
              jax_penalties.charbonnier_prime(jx, eps=0.1))]
    for name in ("identity", "charbonnier"):
        cases.append((penalties.get_penalty(name, True)(tx),
                      jax_penalties.get_penalty(name, True)(jx)))
        cases.append((penalties.get_penalty(name, derivative=False)(tx),
                      jax_penalties.get_penalty(name, derivative=False)(jx)))
    for got, want in cases:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15, atol=0)
    # the derivative is that of the penalty in its squared argument
    xs = tx.clone().requires_grad_(True)
    penalties.charbonnier(xs).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(),
                               penalties.charbonnier_prime(tx).numpy(), rtol=1e-14)


@pytest.mark.parametrize("name,kwargs", [
    ("abs_robust_loss", {}),
    ("gmm", {"pi": [0.5, 0.5], "beta": [1.0, 4.0]}),
])
def test_penalty_derivatives_refused_as_in_jax(name, kwargs):
    """No derivative of ``abs_robust_loss`` or ``gmm`` in either package;
    both raise the same message. Without ``derivative`` each is the
    penalty, with ``pi`` / ``beta`` by keyword as the ELBO loss passes
    them."""
    for get in (penalties.get_penalty, jax_penalties.get_penalty):
        with pytest.raises(NotImplementedError) as e:
            get(name, derivative=True, **kwargs)
        assert "derivative not implemented" in str(e.value)
    x = np.random.RandomState(29).rand(4, 5)
    np.testing.assert_allclose(
        penalties.get_penalty(name, **kwargs)(torch.from_numpy(x)).numpy(),
        np.asarray(jax_penalties.get_penalty(name, **kwargs)(jnp.asarray(x))),
        rtol=1e-13)


def test_unknown_penalty_raises_in_both():
    for get in (penalties.get_penalty, jax_penalties.get_penalty):
        for derivative in (False, True):
            with pytest.raises(NotImplementedError):
                get("huber", derivative)
