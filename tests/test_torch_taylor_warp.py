"""The port's Taylor warp against ``arflow_tpu``'s, in float64 on the CPU:
``resample_with_grads`` (the value, both partials and the gradient to the
coordinates) and the bidirectional data term with the gate on
(``data_loss_no_penalty_bidir``: census and ssim, every occlusion type,
four samples, 2-channel means), the environment variable's override,
and the convergence order that ``tests/test_taylor_warp.py`` pins for the
JAX path. The mixture's Taylor warp is in ``test_torch_taylor_mixture.py``,
the ELBO loss with ``taylor_warp`` in ``test_torch_taylor_elbo.py`` and
the ``taylor_compare`` tool in ``test_torch_taylor_compare.py``.

Tolerances: both sides compute the same float64 arithmetic. Measured
over every case here and in ``test_torch_taylor_mixture.py``: the
samples, partials and coordinates' gradients equal JAX's bit for bit; the
data terms and weights part by up to 1.6e-13 of their largest element
(the census's soft threshold amplifies the last bits of the
reconstructions) and the flow and mean gradients by 1.0e-12 of theirs.
The bounds: 1e-12 absolute on the sampler, 1e-10 relative on the data
term, as ``tests/torch_elbo_util.py`` holds the loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.losses import blocks as jax_blocks
from arflow_tpu.ops import resample_with_grads as jax_resample_with_grads
from arflow_tpu_torch.losses import blocks
from arflow_tpu_torch.ops import resample, resample_with_grads
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

ATOL, RTOL = 1e-12, 1e-10
B, H, W, N = 2, 32, 40, 4


def coords_of(rs, b, h, w, hq, wq):
    """Warp coordinates (B,Hq,Wq,2) over [-3, S + 2): points outside the
    image, in [-1, 0) and past S - 1, and a fifth of them integers."""
    c = rs.uniform(-3.0, [w + 2.0, h + 2.0], (b, hq, wq, 2))
    whole = rs.rand(b, hq, wq, 2) < 0.2
    c[whole] = np.floor(c[whole])
    c[0, 0, 0] = [-1.0, -0.5]  # on the zero padding's edge
    c[0, 0, 1] = [w - 1.0, h - 1.0]  # the last pixel
    return c


@pytest.mark.parametrize("h,w", [(7, 9), (1, 6), (5, 1)])
def test_resample_with_grads_equals_jax(h, w):
    """Value and partials against JAX at every kind of point, a side of 1
    included; the value against the port's ``resample``; the gradient to
    the coordinates against ``jax.vjp`` under random cotangents."""
    rs = np.random.RandomState(h * 10 + w)
    src = rs.rand(2, h, w, 3)
    coords = coords_of(rs, 2, h, w, 6, 8)
    cots = [rs.randn(2, 6, 8, 3) for _ in range(3)]
    outs_j, vjp = jax.vjp(lambda c: jax_resample_with_grads(jnp.asarray(src), c),
                          jnp.asarray(coords))
    (grad_j,) = vjp(tuple(jnp.asarray(t) for t in cots))

    c_t = torch.tensor(coords.transpose(0, 3, 1, 2), requires_grad=True)
    src_t = torch.from_numpy(src.transpose(0, 3, 1, 2))
    outs_t = resample_with_grads(src_t, c_t)
    torch.autograd.backward(outs_t, [torch.from_numpy(t.transpose(0, 3, 1, 2))
                                     for t in cots])
    for name, o_t, o_j in zip(("value", "gx", "gy"), outs_t, outs_j):
        np.testing.assert_allclose(o_t.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(o_j), rtol=0, atol=ATOL,
                                   err_msg=name)
    assert np.abs(np.asarray(outs_j[1])).max() > 0.1  # partials are exercised
    np.testing.assert_allclose(c_t.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(grad_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(outs_t[0].detach().numpy(),
                               resample(src_t, c_t.detach()).numpy(),
                               rtol=0, atol=ATOL)


def test_border_padding_equals_jax():
    """``padding='border'``: the point clamped into the image, the edge
    re-read past it; value and partials against JAX's."""
    from arflow_tpu.ops.warp import bilinear_gather_with_grads as jax_gather

    from arflow_tpu_torch.ops import bilinear_gather_with_grads

    rs = np.random.RandomState(5)
    src = rs.rand(2, 7, 9, 3)
    coords = coords_of(rs, 2, 7, 9, 6, 8)
    outs_j = jax_gather(jnp.asarray(src), jnp.asarray(coords[..., 0]),
                        jnp.asarray(coords[..., 1]), padding="border")
    outs_t = bilinear_gather_with_grads(
        torch.from_numpy(src.transpose(0, 3, 1, 2)),
        torch.from_numpy(coords[..., 0]), torch.from_numpy(coords[..., 1]),
        padding="border")
    for name, o_t, o_j in zip(("value", "gx", "gy"), outs_t, outs_j):
        np.testing.assert_allclose(o_t.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(o_j), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_bf16_source_samples_in_f32():
    """A bfloat16 source is sampled in float32 and cast back, as the
    port's ``resample`` does it."""
    rs = np.random.RandomState(3)
    src = torch.from_numpy(rs.rand(1, 3, 6, 7)).to(torch.bfloat16)
    coords = torch.from_numpy(coords_of(rs, 1, 6, 7, 4, 5).transpose(0, 3, 1, 2))
    outs = resample_with_grads(src, coords.to(torch.bfloat16))
    want = resample_with_grads(src.float(), coords.to(torch.bfloat16).float())
    for o, o32 in zip(outs, want):
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, o32.to(torch.bfloat16))


def bidir_inputs(rs, k):
    """Images (B,H,W,3), level-2 means (B,h,w,2K) of a few pixels (so
    warps leave the image), flows drawn around each sample's component
    (N*B, sample-major; a third of a pixel at level 2) and, for K > 1,
    the components z (B, N); numpy float64."""
    h2, w2 = H // 4, W // 4
    imgs = [rs.rand(B, H, W, 3) for _ in range(2)]
    means = [rs.randn(B, h2, w2, 2 * k) * 2.5 for _ in range(2)]
    zs = [rs.randint(0, k, (B, N)) for _ in range(2)] if k > 1 else [None, None]
    flows = []
    for mean, z in zip(means, zs):
        rows = [mean[b, ..., 2 * (0 if z is None else z[b, s]):][..., :2]
                for s in range(N) for b in range(B)]
        flows.append(np.stack(rows) + 0.35 * rs.randn(N * B, h2, w2, 2))
    return imgs, flows, means, zs


def jax_bidir(imgs, flows, means, zs, occ, data_loss, rs):
    """The JAX data term's terms, weights, masks, and the gradients to the
    flows and means under cotangents drawn from ``rs`` (returned)."""
    def terms(f12, f21, m12, m21):
        pl, pw, occu, valid = jax_blocks.data_loss_no_penalty_bidir(
            jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), f12, f21, occ,
            data_loss, m12, m21, n_rep=N, taylor_default=True,
            z12=None if zs[0] is None else jnp.asarray(zs[0]),
            z21=None if zs[1] is None else jnp.asarray(zs[1]))
        return pl, (pw, occu, valid)

    args = [jnp.asarray(a) for a in flows + means]
    shapes = jax.eval_shape(terms, *args)[0]
    cots = [rs.randn(*t.shape) for t in jax.tree_util.tree_leaves(shapes)]

    @jax.jit
    def run(args, cots):
        pl, vjp, aux = jax.vjp(terms, *args, has_aux=True)
        tree = jax.tree_util.tree_structure(pl)
        return pl, aux, vjp(jax.tree_util.tree_unflatten(tree, cots))

    pl, (pw, occu, valid), grads = run(args, [jnp.asarray(c) for c in cots])
    return (jax.tree_util.tree_leaves(pl), jax.tree_util.tree_leaves(pw), occu,
            valid, grads, cots)


def port_bidir(imgs, flows, means, zs, occ, data_loss, cots):
    leaves = [torch.tensor(a, requires_grad=True) for a in flows + means]
    pl, pw, occu, valid = blocks.data_loss_no_penalty_bidir(
        torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]), *leaves[:2], occ,
        data_loss, *leaves[2:], n_rep=N, taylor_default=True,
        z12=None if zs[0] is None else torch.from_numpy(zs[0]),
        z21=None if zs[1] is None else torch.from_numpy(zs[1]))
    pl = [t for x in pl for t in (x if isinstance(x, list) else [x])]
    if cots is None:
        return pl
    grads = torch.autograd.grad(pl, leaves, [torch.from_numpy(c) for c in cots])
    return pl, pw, occu, valid, grads


def assert_close(got, want, what):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def check_bidir(k, occ, monkeypatch):
    """The data term with the Taylor warp on (the loss's default, no
    environment variable) against JAX: census and ssim, each distance,
    weight and mask, and the gradients to both directions' flows and
    means, for ``k``-component means (k = 1: 2 channels) with the
    components injected."""
    monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
    rs = np.random.RandomState(20 + k + len(occ))
    imgs, flows, means, zs = bidir_inputs(rs, k)
    data_loss = ["census", "ssim"]
    pl_j, pw_j, occu_j, valid_j, grads_j, cots = jax_bidir(
        imgs, flows, means, zs, occ, data_loss, rs)
    pl_t, pw_t, occu_t, valid_t, grads_t = port_bidir(imgs, flows, means, zs,
                                                      occ, data_loss, cots)
    assert len(pl_t) == len(pl_j) == 3 and len(pw_t) == len(pw_j) == 2
    for i, (t, j) in enumerate(zip(pl_t + pw_t, pl_j + pw_j)):
        assert_close(t, j, f"term {i}")
    assert (occu_t is None) == (occu_j is None) == (occ == "none")
    if occu_t is not None:
        assert_close(occu_t, occu_j, "occu_mask_2")
    assert_close(valid_t, valid_j, "valid_mask_0")
    assert 0 < float(np.asarray(valid_j).mean()) < 1  # warps leave the image
    for name, g_t, g_j in zip(("flow12", "flow21", "mean12", "mean21"),
                              grads_t, grads_j):
        assert_close(g_t, g_j, name)
        assert np.abs(np.asarray(g_j)).max() > 0, name
    # the Taylor path ran: the exact warp gives another census term
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    exact = port_bidir(imgs, flows, means, zs, occ, data_loss, None)
    assert float((exact[0] - pl_t[0]).detach().abs().max()) > 1e-3


@pytest.mark.parametrize("occ", ["mean", "sample", "none"])
def test_bidir_taylor_equals_jax(occ, monkeypatch):
    """2-channel means: one gather per direction at the posterior mean."""
    check_bidir(1, occ, monkeypatch)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_environment_overrides_the_default(env, monkeypatch):
    """``ARFLOW_TAYLOR_WARP=0/1`` overrides the loss's default both ways,
    and without it the default holds, as the JAX gate reads it."""
    if env is None:
        monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
    else:
        monkeypatch.setenv("ARFLOW_TAYLOR_WARP", env)
    for default in (False, True):
        want = default if env is None else env == "1"
        assert blocks.taylor_warp_enabled(default) is want
        assert jax_blocks.taylor_warp_enabled(default) is want


def smooth_images(rs, b, h, w):
    """Band-limited images, as the JAX test makes them: 1/8-resolution
    noise upsampled bilinearly (align_corners=False, half-pixel centres,
    which is ``jax.image.resize``'s bilinear)."""
    low = torch.from_numpy(rs.rand(b, 3, h // 8, w // 8))
    up = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1)


def data_terms(monkeypatch, gate, *args, **kw):
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", gate)
    return blocks.data_loss_no_penalty_bidir(*args, data_loss=["census"], **kw)[0][0]


def test_taylor_converges_to_exact(monkeypatch):
    """``tests/test_taylor_warp.py:test_taylor_converges_to_exact`` on the
    port: each 10x smaller perturbation shrinks the gap to the exact warp's
    census term at least 5x, and at 0.03 px it is under 1% of the term
    (the JAX test's bounds; measured here 16x and 49x, and 0.39%)."""
    rs = np.random.RandomState(0)
    b, h, w, n = 2, 32, 40, 4
    im1, im2 = smooth_images(rs, b, h, w), smooth_images(rs, b, h, w)
    mean12 = torch.from_numpy(rs.randn(b, h // 4, w // 4, 2) * 0.5)
    mean21 = torch.from_numpy(rs.randn(b, h // 4, w // 4, 2) * 0.5)
    noise = torch.from_numpy(rs.randn(n * b, h // 4, w // 4, 2))
    errs = []
    for eps in (0.3, 0.03, 0.003):
        flows = (mean12.repeat(n, 1, 1, 1) + eps * noise,
                 mean21.repeat(n, 1, 1, 1) - eps * noise)
        args = (im1, im2, *flows, "mean")
        exact = data_terms(monkeypatch, "0", *args, mean12_2=mean12,
                           mean21_2=mean21, n_rep=n)
        taylor = data_terms(monkeypatch, "1", *args, mean12_2=mean12,
                            mean21_2=mean21, n_rep=n)
        errs.append(float((taylor - exact).abs().mean()))
        scale = float(exact.abs().mean())
    assert errs[1] < errs[0] * 0.2 and errs[2] < errs[1] * 0.2, errs
    assert errs[1] < 0.01 * scale, (errs, scale)
