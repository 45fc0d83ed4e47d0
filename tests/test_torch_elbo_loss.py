"""The port's ``UFlowElboLoss`` against ``arflow_tpu.losses.UFlowElboLoss``
in float64, with the same injected draws (``noise=``): every returned term
and map, and the gradient of the total with respect to the level-2 outputs
of both directions (``tests/torch_elbo_util.py:check_case``).

This file: the ``diag`` posterior (with and without ``inv_cov``), both
smoothness forms (closed form of orders 1 and 2, isotropic with and
without ``fix_isotropic_broadcast``, sampled), the occlusion types
``sample``, ``mean`` and ``none``, ``with_bk`` on and off, the
out-of-frame and occlusion penalties, the penalties (``charbonnier``,
``abs_robust_loss``, ``gmm``), the banded products,
``census_loss_no_penalty`` with two groups, the ssim data term and the
refusals. The other
posteriors are in ``test_torch_elbo_loss_posteriors.py``.

The JAX side runs with its Taylor-warp gate pinned off
(``ARFLOW_TAYLOR_WARP=0``), the exact per-sample warp the port has.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.ops import census_loss_no_penalty as jax_census_no_penalty
from arflow_tpu.ops import triag as jax_triag
from arflow_tpu.ops.penalties import get_penalty as jax_get_penalty
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowElboLoss, get_loss
from arflow_tpu_torch.ops import triag
from arflow_tpu_torch.ops.census import census_loss_no_penalty
from arflow_tpu_torch.ops.penalties import get_penalty
from torch_elbo_util import (
    BASE,
    GMM,
    check_case,
    inputs,
    jax_loss,
    model_outputs,
    port_loss,
)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

CASES = {
    # chairs_uflow_elbo.json: closed form of order 1 with the isotropic
    # (B, B, H, W') broadcast
    "diag_closed_isotropic": {"closed_form_smooth": True, "order_smooth": 1,
                              "isotropic_smooth": True},
    # inv_cov, closed form of order 2, occlusion from the means, both
    # penalties on the samples
    "diag_inv_cov_closed_order2": {"inv_cov": True, "closed_form_smooth": True,
                                   "order_smooth": 2, "occ_type": "mean",
                                   "w_occ": 0.3, "w_oof": 0.2},
    # one direction, two samples, the approximate entropy, the isotropic
    # per-entry pairing, the gmm data penalty, no occlusion
    "diag_one_direction": {"with_bk": False, "n_samples": 2,
                           "approx_entropy": True, "closed_form_smooth": True,
                           "isotropic_smooth": True,
                           "fix_isotropic_broadcast": True,
                           "occ_type": "none", "w_oof": 0.5,
                           "data_penalty": ["gmm"],
                           "penalty_census_pi": GMM["pi"],
                           "penalty_census_beta": GMM["beta"]},
    # the sampled smoothness, two samples, occlusion from the samples
    "diag_sampled_n2": {"n_samples": 2, "w_occ": 0.3},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_elbo_loss_terms_and_gradients_f64(name, monkeypatch):
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    check_case(dict(BASE, **CASES[name]), seed=sorted(CASES).index(name))


def test_noise_from_a_generator():
    """Without ``noise=`` the draws come from the generator: the same seed
    gives the same loss, another seed another; without a generator the
    loss refuses to draw."""
    cfg = dict(BASE, approx="mixture", n_components=2, n_samples=3)
    outs, imgs, _, _ = inputs(cfg, seed=0)
    res = model_outputs({k: torch.from_numpy(v) for k, v in outs.items()}, {},
                        torch.from_numpy)
    a, b = torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1])
    loss = get_loss(Config(cfg))
    runs = [float(loss(res, a, b, generator=torch.Generator().manual_seed(s))
                  ["total"]) for s in (0, 0, 1)]
    assert runs[0] == runs[1] != runs[2]
    with pytest.raises(ValueError, match="Generator"):
        loss(res, a, b)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_banded_products_and_their_gradients(k):
    """``matrix_vector_product(_T)`` and the k-support ``_general`` ones
    against the JAX functions in float64: values, and the gradients of the
    general ones (autograd against ``jax.vjp``)."""
    rs = np.random.RandomState(k)
    m, n = 7, 9
    a = rs.randn(2, m, n, 2 * (k + 1) ** 2)
    x = rs.randn(2, m, n, 2)
    g = rs.randn(2, m, n, 2)
    for name in ("matrix_vector_product_general",
                 "matrix_vector_product_T_general"):
        fj = getattr(jax_triag, name)
        y_j, vjp = jax.vjp(lambda a_, x_: fj(a_, x_, k=k), jnp.asarray(a),
                           jnp.asarray(x))
        da_j, dx_j = vjp(jnp.asarray(g))
        at, xt = (torch.tensor(v, requires_grad=True) for v in (a, x))
        y_t = getattr(triag, name)(at, xt, k=k)
        y_t.backward(torch.from_numpy(g))
        for got, want in ((y_t, y_j), (at.grad, da_j), (xt.grad, dx_j)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    # <L x, y> = <x, L^T y>
    y = rs.randn(2, m, n, 2)
    at, xt, yt = (torch.from_numpy(v) for v in (a, x, y))
    np.testing.assert_allclose(
        float((triag.matrix_vector_product_general(at, xt, k) * yt).sum()),
        float((xt * triag.matrix_vector_product_T_general(at, yt, k)).sum()),
        rtol=1e-12)
    bands = [rs.randn(2, m, n, 2), rs.randn(2, m, n - 1, 2),
             rs.randn(2, m - 1, n, 2), rs.randn(2, m - 1, n - 1, 2)]
    for name in ("matrix_vector_product", "matrix_vector_product_T"):
        want = getattr(jax_triag, name)(*map(jnp.asarray, bands), jnp.asarray(x))
        got = getattr(triag, name)(*map(torch.from_numpy, bands), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("a_rep", [1, 3])
def test_census_loss_no_penalty_two_groups(a_rep):
    """Both directions in one batch, each weight map normalized by its own
    direction's mask sum; with ``a_rep`` sample copies of each direction."""
    rs = np.random.RandomState(a_rep)
    nb = 2
    imgs_a = rs.rand(2 * nb, 24, 32, 3)
    imgs_b = rs.rand(2 * a_rep * nb, 24, 32, 3)
    mask = (rs.rand(2 * a_rep * nb, 24, 32, 1) > 0.3).astype(np.float64)
    mask[:a_rep * nb] *= 0.5  # the two groups' sums differ
    want = jax_census_no_penalty(jnp.asarray(imgs_a), jnp.asarray(imgs_b),
                                 jnp.asarray(mask), num_groups=2, a_rep=a_rep)
    nchw = lambda v: torch.from_numpy(v).permute(0, 3, 1, 2)  # noqa: E731
    got = census_loss_no_penalty(nchw(imgs_a), nchw(imgs_b), nchw(mask),
                                 num_groups=2, a_rep=a_rep)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[1].reshape(2, -1).sum(dim=1).numpy(),
                               [1.0, 1.0], rtol=1e-6)


@pytest.mark.parametrize("name", ["identity", "charbonnier", "abs_robust_loss", "gmm"])
def test_penalties(name):
    x = np.abs(np.random.RandomState(0).randn(50)) * 3
    kwargs = GMM if name == "gmm" else {}
    want = jax_get_penalty(name, **kwargs)(jnp.asarray(x))
    got = get_penalty(name, **kwargs)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


@pytest.mark.parametrize("overrides, match", [
    ({"approx": "sparse", "cov_supp": 1, "inv_cov": True}, "Sparse precision"),
    ({"approx": "mixture", "n_components": 2, "inv_cov": True}, "Inverse covariance"),
    ({"natural_grad": True}, "Natural gradient"),
    ({"approx": "lowrank", "columns": 3, "closed_form_smooth": True},
     "closed_form_smooth requires diag"),
])
def test_refusals_as_the_jax_loss(overrides, match, monkeypatch):
    """Where the JAX loss raises, the port raises the same way."""
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    cfg = dict(BASE, **overrides)
    args = inputs(cfg, seed=0)
    with pytest.raises(NotImplementedError, match=match):
        jax_loss(cfg, *args)
    with pytest.raises(NotImplementedError, match=match):
        port_loss(cfg, *args)


def test_refusals_of_what_is_not_ported(monkeypatch):
    """What was refused before it was ported now runs. The Taylor warp
    (``taylor_warp``, ported since) builds and runs: with two samples it
    moves the loss off the exact warp's, and ``ARFLOW_TAYLOR_WARP=0``
    brings the exact warp back (``test_torch_taylor_*.py`` hold it to the
    JAX loss). The ssim data term computes as the JAX one does (beside
    census, each with its penalty); a config that names its loss with
    ``name`` (chairs_uflow_elbo.json) builds."""
    monkeypatch.delenv("ARFLOW_TAYLOR_WARP", raising=False)
    cfg = dict(BASE, n_samples=2, occ_type="mean")
    args = inputs(cfg, seed=4)
    exact = float(port_loss(cfg, *args)[0]["total"])
    taylor = port_loss(dict(cfg, taylor_warp=True), *args)[0]
    assert np.isfinite(float(taylor["total"])) and float(taylor["total"]) != exact
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    assert float(port_loss(dict(cfg, taylor_warp=True), *args)[0]["total"]) == exact
    check_case(dict(BASE, data_loss=["census", "ssim"], data_weight=[1.0, 0.5],
                    data_penalty=["abs_robust_loss", "charbonnier"]), seed=5)
    named = {k: v for k, v in BASE.items() if k != "type"}
    assert isinstance(get_loss(Config(dict(named, name="uflow_elbo"))),
                      UFlowElboLoss)
