"""The port's cost volume, forward and backward, against the JAX reference
and both Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
``tests/test_cost_volume_pallas.py`` runs them. The CUDA kernels themselves
run only on the card (``-m gpu``); here the op ``arflow::cost_volume`` and
its backward take their plain path, because the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.ops.cost_volume import compute_cost_volume_reference as jax_ref
from arflow_tpu.ops.pallas.cost_volume_pallas import (
    _grad_shifted,
    cost_volume_pallas,
    cost_volume_pallas_v2,
)
from arflow_tpu_torch.ops.cost_volume import (
    compute_cost_volume,
    compute_cost_volume_reference,
    cost_volume_grad_reference,
)
from arflow_tpu_torch.ops.cuda import COST_VOLUME, COST_VOLUME_BWD
from arflow_tpu_torch.ops.cuda.cost_volume import (
    cost_volume_grad_kernel,
    cost_volume_kernel,
)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

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
    assert torch.autograd.gradcheck(lambda x, y: compute_cost_volume(x, y, 2),
                                    (a, b))


def test_function_grad_matches_jax_f64():
    shape, md = (1, 10, 12, 8), 3
    f1, f2 = _pair(shape, 3, np.float64)
    g_j = jax.grad(lambda x, y: jnp.sum(jax_ref(x, y, md) ** 2),
                   argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    a = _t(f1).requires_grad_()
    b = _t(f2).requires_grad_()
    (compute_cost_volume(a, b, md) ** 2).sum().backward()
    np.testing.assert_allclose(_n(a.grad), np.asarray(g_j[0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_n(b.grad), np.asarray(g_j[1]), rtol=0, atol=1e-12)


def _grad_case(shape, md, seed, dtype):
    f1, f2 = _pair(shape, seed, dtype)
    b, h, w, _ = shape
    g = np.random.RandomState(seed + 10).randn(b, h, w, (2 * md + 1) ** 2)
    return f1, f2, g.astype(dtype)


@pytest.mark.parametrize("md", [1, 4])
def test_grad_plain_matches_grad_shifted_f64(md):
    """The plain backward against the JAX package's ``_grad_shifted``, the
    Pallas kernels' custom VJP: W not a multiple of 4, a map smaller than
    the window at md=4."""
    for shape in ((2, 9, 11, 5), (1, 3, 4, 8)):
        f1, f2, g = _grad_case(shape, md, 5, np.float64)
        ref = _grad_shifted(jnp.asarray(g), jnp.asarray(f1), jnp.asarray(f2), md)
        ours = cost_volume_grad_reference(_t(g), _t(f1), _t(f2), md)
        for a, b in zip(ours, ref):
            # Same float64 products; only the order of the sum differs.
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=0, atol=1e-13)


def _one_gather(G, F, md):
    """out[b,c,p] = (1/C) sum_k G[b,k,p] F[b,c,p+d_k], F zero outside the
    image: the form in which the backward kernel computes both gradients."""
    n = 2 * md + 1
    c, h, w = F.shape[-3:]
    fp = torch.nn.functional.pad(F, (md, md, md, md))
    out = torch.zeros_like(F)
    for i in range(n):
        for j in range(n):
            out = out + G[:, i * n + j:i * n + j + 1] * fp[:, :, i:i + h, j:j + w]
    return out / c


def _mirrored_shifted(g, md):
    """G[b,k,p] = g[b,K-1-k,p+d_k], zero outside the image: gf2's G."""
    n = 2 * md + 1
    h, w = g.shape[-2:]
    gp = torch.nn.functional.pad(g, (md, md, md, md))
    return torch.stack([gp[:, n * n - 1 - (i * n + j), i:i + h, j:j + w]
                        for i in range(n) for j in range(n)], dim=1)


@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_grad_one_gather_form_matches_grad_shifted_f64(md):
    """Both gradients as one gather, as the backward kernel computes them:
    gf1 with G = g and F = f2, gf2 with g mirrored and shifted and F = f1,
    against the JAX package's ``_grad_shifted``; W not a multiple of 4 and
    a map smaller than the window."""
    for shape in ((2, 9, 11, 5), (1, 3, 4, 8)):
        f1, f2, g = _grad_case(shape, md, 8, np.float64)
        ref = _grad_shifted(jnp.asarray(g), jnp.asarray(f1), jnp.asarray(f2), md)
        gt, f1t, f2t = _t(g), _t(f1), _t(f2)
        ours = (_one_gather(gt, f2t, md),
                _one_gather(_mirrored_shifted(gt, md), f1t, md))
        for a, b in zip(ours, ref):
            # Same float64 products; the sums run in other orders.
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("md", [1, 4])
def test_grad_plain_matches_pallas_v2_vjp_f32(md):
    """``jax.vjp`` of the TPU default kernel (interpret mode) against the
    port's op backward on CPU tensors, float32."""
    f1, f2, g = _grad_case((2, 12, 16, 8), md, 6, np.float32)
    _, vjp = jax.vjp(lambda a, b: cost_volume_pallas_v2(a, b, md),
                     jnp.asarray(f1), jnp.asarray(f2))
    ref = vjp(jnp.asarray(g))
    a = _t(f1).requires_grad_()
    b = _t(f2).requires_grad_()
    compute_cost_volume(a, b, md).backward(_t(g))
    # The same float32 terms summed in the same order (measured: equal bit
    # for bit on gradients up to 4.1); the bound leaves room for a few ulp.
    for ours, theirs in ((a.grad, ref[0]), (b.grad, ref[1])):
        np.testing.assert_allclose(_n(ours), np.asarray(theirs), rtol=0,
                                   atol=1e-6)


def test_function_backward_honours_needs_input_grad():
    f1, f2 = _pair((1, 6, 7, 4), 7, np.float64)
    a = _t(f1).requires_grad_()
    b = _t(f2)
    before = COST_VOLUME_BWD.launches
    (compute_cost_volume(a, b, 2) ** 2).sum().backward()
    assert a.grad is not None and b.grad is None
    assert COST_VOLUME_BWD.launches == before  # CPU: plain version


def test_kernel_wrapper_rejects_cpu_and_counts_only_launches():
    f1, f2 = _pair((1, 4, 5, 8), 4, np.float32)
    before = (COST_VOLUME.launches, COST_VOLUME_BWD.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_kernel(_t(f1), _t(f2), 4)
    g = torch.zeros((1, 81, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_grad_kernel(g, _t(f1), _t(f2), 4)
    a = _t(f1).requires_grad_()
    compute_cost_volume(a, _t(f2), 4).sum().backward()  # CPU: no launch
    assert (COST_VOLUME.launches, COST_VOLUME_BWD.launches) == before


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
    # The kernel sums in the order of torch's mean at the model's shapes
    # (test_cuda_kernel_rounds_as_plain_at_level_shapes); at some tiny maps
    # torch's reduction splits C another way.
    torch.testing.assert_close(out, compute_cost_volume_reference(f1, f2, md),
                               rtol=0, atol=2e-6)


# Shapes that cross the backward kernel's tiles (64x4 px on large maps,
# 16x4 on small ones) and its 32-channel block: W = 65 and 63, H = 5, C = 33
# (two channel parts) and C = 9, md 1-3 at W % 4 != 0, W = 68 with the
# 16-byte copies, inputs two floats off 16-byte alignment (8-byte copies),
# and the 64x4 tiles with 4- and 8-byte copies.
GRAD_EDGE_CASES = [
    ((2, 33, 5, 65), 4, 0), ((1, 9, 5, 63), 4, 0), ((2, 33, 5, 68), 4, 0),
    ((1, 9, 5, 63), 1, 0), ((2, 33, 5, 65), 2, 0), ((1, 9, 6, 63), 3, 0),
    ((1, 32, 12, 20), 4, 2), ((8, 9, 9, 65), 4, 0), ((8, 33, 9, 66), 2, 0),
]


# The MSE train step's levels (configs/chairs_uflow_mse.json at 384x512,
# batch 16, the forward direction only).
MSE_LEVELS = [(16, 32, 384 >> lv, 512 >> lv) for lv in (2, 3, 4, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,offset", GPU_CASES + [
    ((8, 32, 64, 112), 4, 0), ((8, 32, 8, 14), 4, 0)] + GRAD_EDGE_CASES
    + [(shape, 4, 0) for shape in MSE_LEVELS])
def test_cuda_grad_kernel_matches_plain(shape, md, offset):
    """The backward kernel through the op, at the UFlow levels of
    384x640, 256x448 and the MSE step's 384x512 b16, the ragged cases above
    and the tile edges, both gradients and each alone."""
    check_grad_kernel(shape, md, offset)


def check_grad_kernel(shape, md, offset):
    """The backward kernel through the op against its plain version, both
    gradients and each alone; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, c, h, w = shape
    k = (2 * md + 1) ** 2

    def draw(n):
        return torch.randn(n + offset, device="cuda", generator=gen)[offset:]

    f1 = draw(b * c * h * w).view(shape)
    f2 = draw(b * c * h * w).view(shape)
    g = draw(b * k * h * w).view(b, k, h, w)
    r1, r2 = cost_volume_grad_reference(g, f1, f2, md)
    # float32 sums over k in another rounding than the plain version's
    # (each term divided by C before the sum): a few ulp of the largest.
    tol = 1e-5 * max(float(r1.abs().max()), float(r2.abs().max()), 1e-30)
    before = COST_VOLUME_BWD.launches
    a = f1.clone().requires_grad_()
    bb = f2.clone().requires_grad_()
    compute_cost_volume(a, bb, md).backward(g)
    torch.cuda.synchronize()
    assert COST_VOLUME_BWD.launches == before + 1
    torch.testing.assert_close(a.grad, r1, rtol=0, atol=tol)
    torch.testing.assert_close(bb.grad, r2, rtol=0, atol=tol)
    only1, none2 = cost_volume_grad_kernel(g, f1, f2, md, True, False)
    none1, only2 = cost_volume_grad_kernel(g, f1, f2, md, False, True)
    torch.cuda.synchronize()
    assert none1 is None and none2 is None
    torch.testing.assert_close(only1, a.grad, rtol=0, atol=0)
    torch.testing.assert_close(only2, bb.grad, rtol=0, atol=0)


# The ELBO train step's levels at 256x448 (configs/chairs_uflow_elbo.json's
# crop, b4): both directions on one decoder pass make batch 8, and two
# pyramids' components (chairs_uflow_elbo_mixture.json) batch 16.
ELBO_LEVELS = [(b, 32, 256 >> lv, 448 >> lv) for b in (8, 16) for lv in (2, 3, 4, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ELBO_LEVELS)
def test_cuda_kernels_at_elbo_level_shapes(shape):
    """Both kernels, launched through the op, against their plain
    versions at the ELBO step's level shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, c, h, w = shape
    f1 = torch.randn(shape, device="cuda", generator=gen)
    f2 = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn((b, 81, h, w), device="cuda", generator=gen)
    before = (COST_VOLUME.launches, COST_VOLUME_BWD.launches)
    a, bb = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = compute_cost_volume(a, bb, 4)
    out.backward(g)
    torch.cuda.synchronize()
    assert (COST_VOLUME.launches, COST_VOLUME_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.detach(), compute_cost_volume_reference(f1, f2, 4),
                               rtol=0, atol=2e-6)
    r1, r2 = cost_volume_grad_reference(g, f1, f2, 4)
    tol = 1e-5 * max(float(r1.abs().max()), float(r2.abs().max()))
    torch.testing.assert_close(a.grad, r1, rtol=0, atol=tol)
    torch.testing.assert_close(bb.grad, r2, rtol=0, atol=tol)


# The UFlow levels of 384x640 b8 and 448x1024 b1, besides the ELBO and
# MSE ones.
LEVELS = ELBO_LEVELS + [(8, 32, 384 >> lv, 640 >> lv) for lv in (2, 3, 4, 5)] + [
    (1, 32, 448 >> lv, 1024 >> lv) for lv in (2, 3, 4, 5)] + MSE_LEVELS


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LEVELS)
def test_cuda_kernel_rounds_as_plain_at_level_shapes(shape):
    """At the model's level shapes the forward kernel equals the plain
    version bit for bit: products rounded, channel c in running sum c mod 4,
    the four combined in order, times 1/C, as torch's mean reduces there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    f1 = torch.randn(shape, device="cuda", generator=gen)
    f2 = torch.randn(shape, device="cuda", generator=gen)
    out = cost_volume_kernel(f1, f2, 4)
    torch.testing.assert_close(out, compute_cost_volume_reference(f1, f2, 4),
                               rtol=0, atol=0)


# The PWC-Lite levels (C = 192, 128, 96, 64, 32 from 1/64 to 1/4): at
# 384x640 b8, whose coarsest map 6x10 has W % 4 != 0 (the 4-byte copies)
# and fills less than one tile row, at 384x640 b1 (the 3-frame stream and
# the 5-frame forward), and at 448x1024 b1 (7x16 coarsest).
PWCLITE_LEVELS = [
    (b, c, h >> lv, w >> lv)
    for b, h, w in ((8, 384, 640), (1, 384, 640), (1, 448, 1024))
    for lv, c in zip((6, 5, 4, 3, 2), (192, 128, 96, 64, 32))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PWCLITE_LEVELS)
def test_cuda_kernel_at_pwclite_level_shapes(shape):
    """The forward kernel, through the op, against its plain version at the
    PWC-Lite family's level shapes; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(4)
    f1 = torch.randn(shape, device="cuda", generator=gen)
    f2 = torch.randn(shape, device="cuda", generator=gen)
    before = COST_VOLUME.launches
    out = compute_cost_volume(f1, f2, 4)
    torch.cuda.synchronize()
    assert COST_VOLUME.launches == before + 1
    torch.testing.assert_close(out, compute_cost_volume_reference(f1, f2, 4),
                               rtol=0, atol=2e-6)


# The PWC-Lite family's training levels at 256x448 b8: pwclite's (C 192 ...
# 32 on 4x7 ... 64x112: the 4x7 map is narrower than one 16-pixel tile and
# has odd W, and C = 192 spreads over 6 channel parts of the backward
# kernel) and pwclite_uflow's (C 32 on 8x14 ... 32x56; its 64x112 level is
# pwclite's).
PWCLITE_TRAIN_LEVELS = (
    [(8, c, 256 >> lv, 448 >> lv)
     for lv, c in zip((6, 5, 4, 3, 2), (192, 128, 96, 64, 32))]
    + [(8, 32, 256 >> lv, 448 >> lv) for lv in (5, 4, 3)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PWCLITE_TRAIN_LEVELS)
def test_cuda_kernels_at_pwclite_train_level_shapes(shape):
    """Both kernels through the op against their plain versions at the
    PWC-Lite family's training level shapes; one launch each."""
    test_cuda_kernel_at_pwclite_level_shapes(shape)
    check_grad_kernel(shape, 4, 0)
