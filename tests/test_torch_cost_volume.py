"""The port's cost volume against the JAX reference and both Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
``tests/test_cost_volume_pallas.py`` runs them. The CUDA kernel itself runs
only on the card (``-m gpu``); here the dispatcher and the autograd Function
take their plain path, because the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.ops.cost_volume import compute_cost_volume_reference as jax_ref
from arflow_tpu.ops.pallas.cost_volume_pallas import (
    cost_volume_pallas,
    cost_volume_pallas_v2,
)
from arflow_tpu_torch.ops.cost_volume import (
    compute_cost_volume,
    compute_cost_volume_reference,
)
from arflow_tpu_torch.ops.cuda import COST_VOLUME
from arflow_tpu_torch.ops.cuda.cost_volume import CostVolume, cost_volume_kernel

# Shapes (B,H,W,C), md: those of tests/test_cost_volume_pallas.py, the
# UFlow level shape (C=32, md=4) and a map smaller than md.
SHAPES = [((2, 12, 16, 8), 4), ((1, 24, 20, 16), 2), ((1, 12, 20, 32), 4),
          ((1, 2, 3, 32), 4)]


def _pair(shape, seed, dtype):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(dtype), rs.randn(*shape).astype(dtype)


def _t(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _n(x_nchw):
    return x_nchw.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape,md", SHAPES)
def test_plain_matches_jax_reference_f64(shape, md):
    f1, f2 = _pair(shape, 0, np.float64)
    ref = np.asarray(jax_ref(jnp.asarray(f1), jnp.asarray(f2), md))
    ours = compute_cost_volume_reference(_t(f1), _t(f2), md)
    assert _n(ours).shape == ref.shape
    # Same float64 products; only the order of the channel sum differs.
    np.testing.assert_allclose(_n(ours), ref, rtol=0, atol=1e-13)
    # The dispatcher on CPU tensors is the plain version, bit for bit.
    torch.testing.assert_close(compute_cost_volume(_t(f1), _t(f2), md), ours,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["v2", "v1"])
@pytest.mark.parametrize("shape,md", SHAPES)
def test_plain_matches_pallas_interpret_f32(shape, md, kernel):
    f1, f2 = _pair(shape, 1, np.float32)
    fn = cost_volume_pallas_v2 if kernel == "v2" else cost_volume_pallas
    pallas = np.asarray(
        jax.jit(lambda a, b: fn(a, b, md))(jnp.asarray(f1), jnp.asarray(f2)))
    ours = compute_cost_volume_reference(_t(f1), _t(f2), md)
    # float32 channel sums in different orders; the Pallas tests' own bound.
    np.testing.assert_allclose(_n(ours), pallas, rtol=0, atol=1e-5)


def test_function_gradcheck_f64():
    f1, f2 = _pair((1, 5, 6, 3), 2, np.float64)
    a = _t(f1).requires_grad_()
    b = _t(f2).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, y: CostVolume.apply(x, y, 2),
                                    (a, b))


def test_function_grad_matches_jax_f64():
    shape, md = (1, 10, 12, 8), 3
    f1, f2 = _pair(shape, 3, np.float64)
    g_j = jax.grad(lambda x, y: jnp.sum(jax_ref(x, y, md) ** 2),
                   argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    a = _t(f1).requires_grad_()
    b = _t(f2).requires_grad_()
    (CostVolume.apply(a, b, md) ** 2).sum().backward()
    np.testing.assert_allclose(_n(a.grad), np.asarray(g_j[0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_n(b.grad), np.asarray(g_j[1]), rtol=0, atol=1e-12)


def test_kernel_wrapper_rejects_cpu_and_counts_only_launches():
    f1, f2 = _pair((1, 4, 5, 8), 4, np.float32)
    before = COST_VOLUME.launches
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_kernel(_t(f1), _t(f2), 4)
    compute_cost_volume(_t(f1), _t(f2), 4)  # CPU: plain version, no launch
    assert COST_VOLUME.launches == before


# (B,C,H,W), md, offset in floats of the inputs from a 16-byte aligned
# allocation. The UFlow levels of 384x640 at b8 and b1; md 1-4; C not a
# multiple of the kernel's 4-channel chunk; W not a multiple of 4 (4-byte
# copies) beside W=16 (16-byte copies); maps smaller than md; and an input
# at an offset of one float, which takes the 4-byte copies at W=20.
GPU_CASES = [
    ((8, 32, 96, 160), 4, 0), ((8, 32, 12, 20), 4, 0), ((3, 20, 13, 37), 4, 0),
    ((2, 8, 12, 16), 2, 0),
    ((1, 32, 96, 160), 4, 0), ((1, 32, 48, 80), 4, 0), ((1, 32, 24, 40), 4, 0),
    ((1, 32, 12, 20), 4, 0),
    ((2, 6, 17, 16), 1, 0), ((2, 6, 17, 37), 1, 0), ((1, 20, 9, 6), 3, 0),
    ((2, 3, 10, 3), 4, 0), ((1, 32, 2, 3), 4, 0), ((2, 32, 1, 1), 4, 0),
    ((1, 32, 2, 3), 1, 0), ((1, 32, 12, 20), 4, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,offset", GPU_CASES)
def test_cuda_kernel_matches_plain(shape, md, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = torch.Size(shape).numel()
    f1 = torch.randn(n + offset, device="cuda", generator=g)[offset:].view(shape)
    f2 = torch.randn(n + offset, device="cuda", generator=g)[offset:].view(shape)
    before = COST_VOLUME.launches
    out = compute_cost_volume(f1, f2, md)
    torch.cuda.synchronize()
    assert COST_VOLUME.launches == before + 1
    # float32 sums over C in another order than the plain version's mean.
    torch.testing.assert_close(out, compute_cost_volume_reference(f1, f2, md),
                               rtol=0, atol=2e-6)
