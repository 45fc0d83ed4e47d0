"""The analytic adjoints of the port's banded triangular solves
(``forward_substitution`` and ``backward_substitution`` as autograd
Functions) against ``jax.vjp`` of ``arflow_tpu.ops.triag``'s custom VJPs in
float64, against finite differences (``torch.autograd.gradcheck``), and on
a CUDA device against the CPU (``-m gpu``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.ops import triag as jax_triag
from arflow_tpu_torch.ops.triag import backward_substitution, forward_substitution
from test_torch_triag import SHAPES, bands
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

SOLVES = {"forward": (forward_substitution, jax_triag.forward_substitution),
          "backward": (backward_substitution, jax_triag.backward_substitution)}
# The same float64 solves and products on both sides: measured at most
# 3.3e-16 of the largest gradient element over every shape and solve.
RTOL = 1e-10


@pytest.mark.parametrize("solve", sorted(SOLVES))
@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_matches_jax_vjp_f64(solve, shape):
    """The gradients of A, B, C, D and x for a seeded output gradient: one
    solve of the other triangle, then -dx * y on each band's slices."""
    port, jax_fn = SOLVES[solve]
    args, _ = bands(shape, seed=11)
    rs = np.random.RandomState(12)
    x = rs.randn(*shape)
    dy = rs.randn(*shape)
    y_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in (*args, x)))
    grads_j = vjp(jnp.asarray(dy))
    leaves = [torch.tensor(t, requires_grad=True) for t in (*args, x)]
    y_t = port(*leaves)
    y_t.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=0,
                               atol=1e-12)
    for name, leaf, g_j in zip("abcdx", leaves, grads_j):
        g_j = np.asarray(g_j)
        assert tuple(leaf.grad.shape) == g_j.shape, name
        scale = np.abs(g_j).max() if g_j.size else 0.0  # a one-row band is empty
        np.testing.assert_allclose(leaf.grad.numpy(), g_j, rtol=0,
                                   atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_adjoint_gradcheck(solve):
    """Finite differences on a 3x4 lattice, two images, two channels."""
    port, _ = SOLVES[solve]
    args, x = bands((2, 3, 4, 2), seed=13)
    leaves = [torch.tensor(t, requires_grad=True) for t in (*args, x)]
    assert torch.autograd.gradcheck(port, leaves)


def test_adjoint_through_a_loss_of_the_mse_kind():
    """Bands that are functions of one tensor (the diagonally dominant
    precision factor of ``MseLoss``): the chain through the Function
    matches finite differences."""
    rs = np.random.RandomState(14)
    out = torch.tensor(0.3 * rs.randn(1, 4, 5, 6), requires_grad=True)
    eps = torch.from_numpy(rs.randn(1, 4, 5, 2))

    def f(o):
        left, over = o[..., 2:4][:, :, :-1], o[..., 4:6][:, :-1]
        diag = (torch.exp(o[..., 0:2])
                + torch.nn.functional.pad(left.abs(), (0, 0, 1, 0))
                + torch.nn.functional.pad(over.abs(), (0, 0, 0, 0, 1, 0)))
        zero = o.new_zeros((1, 3, 4, 2))
        return backward_substitution(diag, left, over, zero, eps).square().sum()

    assert torch.autograd.gradcheck(f, (out,))


@pytest.mark.gpu
@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_adjoint_on_cuda_matches_cpu(solve):
    """float32 on the card against float64 on the CPU, at the MSE step's
    level-2 lattice (96x128, b2 here), both solves and all gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port, _ = SOLVES[solve]
    args, x = bands((2, 96, 128, 2), seed=15)
    dy = np.random.RandomState(16).randn(*x.shape)
    results = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        leaves = [torch.tensor(t, dtype=dt, device=dev, requires_grad=True)
                  for t in (*args, x)]
        y = port(*leaves)
        y.backward(torch.tensor(dy, dtype=dt, device=dev))
        results[dev] = [y.detach()] + [leaf.grad for leaf in leaves]
    for got, want in zip(results["cuda"], results["cpu"]):
        # float32 recurrences over 223 anti-diagonals of a well-conditioned
        # factor: a few ulp of the largest value, times the chain's length.
        torch.testing.assert_close(got.cpu().double(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
