"""The ARFlow losses' ops and blocks of ``arflow_tpu_torch`` against
``arflow_tpu``'s, in float64 on 2x24x40 inputs drawn from a seed: values
and the gradients of a random weighting of every output with respect to
every input (``jax.grad`` against ``torch.autograd.grad``).

Covered: ``resize_area`` (divisible and non-divisible sizes),
``border_mask``, ``get_corresponding_map``, both occlusion masks
(``get_occu_mask_backward`` at th 0.2 and 0), ``ssim_dist``,
``ssim_loss``, ``ternary_loss`` (mean and sum over taps, two distances),
``smooth_grad_1st`` (both penalties) and ``smooth_grad_2nd``, and the ssim
data term of the ELBO loss's blocks in one direction and both.

The port's ops take NCHW, the JAX ones NHWC; the helpers convert.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import arflow_tpu.losses.blocks as jax_blocks
import arflow_tpu.ops as jax_ops
import arflow_tpu_torch.losses.blocks as blocks
import arflow_tpu_torch.ops as ops
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H, W = 2, 24, 40
# Same float64 math on both sides, summed in other orders.
ATOL = 1e-10


def nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def nhwc(t):
    t = t.detach()
    return t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy()


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def compare(jax_fn, port_fn, arrays, seed=0, grad=True):
    """``jax_fn`` on the NHWC ``arrays`` against ``port_fn`` on them as
    NCHW tensors: every output leaf within ATOL, then the gradients of
    ``sum(w_i * out_i)`` over the differentiable outputs (random ``w_i``)
    with respect to every input."""
    ts = [torch.from_numpy(nchw(a)).requires_grad_(grad) for a in arrays]
    t_out = _leaves(port_fn(*ts))
    j_out = jax.tree_util.tree_leaves(
        jax.jit(jax_fn)(*[jnp.asarray(a) for a in arrays]))
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        j = np.asarray(j)
        assert nhwc(t).shape == j.shape
        np.testing.assert_allclose(nhwc(t), j, rtol=0, atol=ATOL)
    if not grad:
        return
    rs = np.random.RandomState(seed + 1)
    weights = [np.asarray(rs.randn(*np.shape(j))) for j in j_out]
    live = [i for i, t in enumerate(t_out) if t.requires_grad]
    assert live

    def jax_scalar(*xs):
        outs = jax.tree_util.tree_leaves(jax_fn(*xs))
        return sum(jnp.sum(weights[i] * outs[i]) for i in live)

    j_grads = jax.jit(jax.grad(jax_scalar, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    t_scalar = sum((torch.from_numpy(nchw(weights[i]) if t_out[i].dim() == 4
                                     else weights[i].copy()) * t_out[i]).sum()
                   for i in live)
    t_grads = torch.autograd.grad(t_scalar, ts, allow_unused=True)
    for t, j in zip(t_grads, j_grads):
        t = np.zeros(np.shape(j)) if t is None else nhwc(t)
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=ATOL)


def image(seed, h=H, w=W, c=3):
    return np.random.RandomState(seed).rand(B, h, w, c)


def flow(seed, scale=3.0, h=H, w=W):
    return scale * np.random.RandomState(seed).randn(B, h, w, 2)


@pytest.mark.parametrize("out_hw", [(12, 20), (6, 10), (7, 13), (5, 9),
                                    (24, 40)])
def test_resize_area(out_hw):
    compare(lambda x: jax_ops.resize_area(x, out_hw),
            lambda x: ops.resize_area(x, out_hw), [image(0)])


def test_border_mask_and_corresponding_map():
    # endpoints on the border itself: the mask is strict there
    f = np.round(flow(1))
    f[:, 0, :, 1] = 0.0
    compare(jax_ops.border_mask, ops.border_mask, [f], grad=False)
    t = ops.border_mask(torch.from_numpy(nchw(f)))
    assert float(t[:, :, 0].sum()) == 0.0
    compare(lambda x: jax_ops.get_corresponding_map(jax_ops.flow_to_warp(x)),
            lambda x: ops.get_corresponding_map(ops.flow_to_warp(x)),
            [flow(2)])


@pytest.mark.parametrize("th", [0.2, 0.0])
def test_occu_mask_backward(th):
    compare(lambda f: jax_ops.get_occu_mask_backward(f, th=th),
            lambda f: ops.get_occu_mask_backward(f, th=th), [flow(3)],
            grad=False)


def test_occu_mask_bidirection():
    f12 = flow(4)
    f21 = -f12 + 0.8 * np.random.RandomState(5).randn(*f12.shape)
    out = ops.get_occu_mask_bidirection(torch.from_numpy(nchw(f12)),
                                        torch.from_numpy(nchw(f21)))
    assert 0.0 < float(out.mean()) < 1.0  # both kinds of pixel occur
    compare(jax_ops.get_occu_mask_bidirection, ops.get_occu_mask_bidirection,
            [f12, f21], grad=False)


def test_ssim_dist():
    a, b = image(6), image(7)
    compare(jax_ops.ssim_dist, ops.ssim_dist, [a, 0.7 * a + 0.3 * b])


@pytest.mark.parametrize("num_groups", [1, 2])
def test_ssim_loss(num_groups):
    a, b = image(8), image(9)
    mask = (np.random.RandomState(10).rand(B, H, W, 1) > 0.3).astype(np.float64)
    compare(lambda x, y, m: jax_ops.ssim_loss(x, y, m, num_groups=num_groups),
            lambda x, y, m: ops.ssim_loss(x, y, m, num_groups=num_groups),
            [a, 0.6 * a + 0.4 * b, mask])


@pytest.mark.parametrize("sum_dist", [False, True])
@pytest.mark.parametrize("max_distance", [1, 3])
def test_ternary_loss(max_distance, sum_dist):
    a, b = image(11), image(12)
    compare(lambda x, y: jax_blocks.ternary_loss(x, y, max_distance, sum_dist),
            lambda x, y: blocks.ternary_loss(x, y, max_distance, sum_dist),
            [a, 0.8 * a + 0.2 * b])


@pytest.mark.parametrize("kind", ["1st_abs", "1st_uflow", "2nd"])
def test_smooth_grad(kind):
    if kind == "2nd":
        j_fn = lambda f, im: jax_blocks.smooth_grad_2nd(f, im, 10.0)  # noqa: E731
        t_fn = lambda f, im: blocks.smooth_grad_2nd(f, im, 10.0)  # noqa: E731
    else:
        pen = kind.split("_")[1]
        j_fn = lambda f, im: jax_blocks.smooth_grad_1st(f, im, 10.0, pen)  # noqa: E731
        t_fn = lambda f, im: blocks.smooth_grad_1st(f, im, 10.0, pen)  # noqa: E731
    compare(j_fn, t_fn, [flow(13) / 30.0, image(14)])


@pytest.mark.parametrize("bidir", [False, True])
def test_elbo_ssim_data_term(bidir):
    """``data_loss`` ["census", "ssim"] of the ELBO loss's blocks: the ssim
    term's two distances and its weights beside the census one; both
    directions with 2 samples each. NHWC on both sides."""
    n = 2 if bidir else 1
    h2, w2 = H // 4, W // 4
    im1, im2 = image(15), image(16)
    f12 = flow(17, 1.0, h2, w2)
    f21 = flow(18, 1.0, h2, w2)
    if bidir:
        f12 = np.concatenate([f12, f12 + 0.1], axis=0)
        f21 = np.concatenate([f21, f21 - 0.1], axis=0)
    kinds = ["census", "ssim"]

    def run(fn, arrays, wrap):
        args = [wrap(a) for a in arrays]
        if bidir:
            return fn(*args, "sample", kinds, n_rep=n)
        return fn(*args, "sample", kinds)

    j_fn = (jax_blocks.data_loss_no_penalty_bidir if bidir
            else jax_blocks.data_loss_no_penalty)
    t_fn = (blocks.data_loss_no_penalty_bidir if bidir
            else blocks.data_loss_no_penalty)
    arrays = [im1, im2, f12, f21]
    j_loss, j_weight, j_occ, j_valid = jax.jit(
        lambda *xs: run(j_fn, xs, lambda a: a))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    t_loss, t_weight, t_occ, t_valid = run(t_fn, ts, lambda t: t)
    assert isinstance(t_loss[1], list) and len(t_loss[1]) == 2
    pairs = list(zip(_leaves([t_loss, t_weight, t_occ, t_valid]),
                     jax.tree_util.tree_leaves([j_loss, j_weight, j_occ,
                                                j_valid])))
    assert len(pairs) == 7
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=ATOL)

    # gradients of the ssim term's weighted sum, to the flows (the
    # backward flow reaches it only through the other direction's warp)
    def jax_ssim(*xs):
        pl, pw, _, _ = run(j_fn, xs, lambda a: a)
        return sum(jnp.sum(pw[1] * d) for d in pl[1])

    j_grads = jax.jit(jax.grad(jax_ssim, argnums=(2, 3)))(
        *map(jnp.asarray, arrays))
    t_total = sum((t_weight[1] * d).sum() for d in t_loss[1])
    t_grads = torch.autograd.grad(t_total, ts[2:], allow_unused=True)
    assert float(np.abs(np.asarray(j_grads[0])).max()) > 0
    for t, j in zip(t_grads, j_grads):
        t = np.zeros(np.shape(j)) if t is None else t.numpy()
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=ATOL)
