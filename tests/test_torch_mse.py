"""The port's ``resize_flow`` and ``MseLoss`` against ``arflow_tpu``'s in
float64: the resize in both ``align_corners`` modes, and the loss in every
parametrization (``diag`` x ``inv_cov``, with and without
``diag_dominant``, ``approx_entropy``, ``offdiag_reg``, ``align_corners``,
two samples) with the same injected draws: its four terms and the gradient
of its total with respect to the network's level-2 output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses.mse import MseLoss as JaxMseLoss
from arflow_tpu.ops import resize_flow as jax_resize_flow
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import MseLoss, get_loss
from arflow_tpu_torch.ops import resize_flow
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H, W = 2, 32, 48
TERMS = ("total", "l_mse", "entropy", "l_offdiag")
# configs/chairs_uflow_mse.json's loss, but for the keys each case sets.
BASE = {"type": "mse", "w_mse": 1.0, "w_entropy": 0.1, "diag": False,
        "diag_dominant": True, "inv_cov": True, "approx_entropy": False,
        "offdiag_reg": 1000.0, "n_samples": 1}
CASES = {
    "diag_cov": {"diag": True, "inv_cov": False},
    "diag_prec": {"diag": True, "inv_cov": True},
    "band_cov": {"inv_cov": False, "diag_dominant": False, "offdiag_reg": 10.0},
    "band_cov_dominant": {"inv_cov": False},
    "band_prec": {"diag_dominant": False, "offdiag_reg": 0.0},
    "band_prec_dominant": {},  # the shipped config
    "band_prec_approx_entropy": {"approx_entropy": True},
    "band_prec_align_corners_two_samples": {"align_corners": True, "n_samples": 2},
}
# The same float64 arithmetic in other orders: measured at most 4.0e-16
# relative on the terms and 3.9e-16 of the largest output gradient. The
# JAX package keeps its interpolation weights in float32
# (arflow_tpu/ops/resize.py:_resize_matrix), F.interpolate computes them in
# the tensor's dtype: where a weight is no dyadic fraction (align_corners,
# or a ratio like 32 -> 13), the resized flows part by up to 5.3e-8 of the
# largest value (measured), the loss terms that read them by 1.6e-9 and
# the output gradient by 1.0e-10.
RTOL, RESIZE_RTOL = 1e-12, 1e-7


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("new_shape", [(8, 12), (13, 7), (64, 96)])
def test_resize_flow_matches_jax(align_corners, new_shape):
    """Down, to odd sizes and up; u scales by the width's ratio, v by the
    height's."""
    flow = np.random.RandomState(1).randn(B, H, W, 2) * 3.0
    want = np.asarray(jax_resize_flow(jnp.asarray(flow), new_shape,
                                      align_corners=align_corners))
    got = resize_flow(torch.from_numpy(flow).permute(0, 3, 1, 2), new_shape,
                      align_corners=align_corners).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == (B, *new_shape, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())


def _inputs(cfg, seed):
    """A level-2 output (mean, log-diagonal near 0.5, small bands), the
    full-resolution ground truth and the draws, numpy float64."""
    rs = np.random.RandomState(seed)
    h, w = H // 4, W // 4
    out = rs.randn(B, h, w, 8)
    out[..., 0:2] *= 2.0
    out[..., 2:4] = 0.3 * out[..., 2:4] + 0.5
    out[..., 4:8] *= 0.3
    gt = np.kron(rs.randn(B, h + 1, w + 1, 2), np.ones((1, 4, 4, 1)))[:, :H, :W]
    eps = rs.randn(cfg["n_samples"] * B, h, w, 2)
    return out, gt, eps


def _levels(out2, array):
    """The six outputs the loss reads, level 2 at index 2."""
    zero = array(np.zeros((B, 1, 1, 8)))
    return [zero, zero, out2, zero, zero, zero]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mse_loss_matches_jax(case):
    cfg = dict(BASE, **CASES[case])
    out, gt, eps = _inputs(cfg, seed=2)
    jloss = JaxMseLoss(JaxConfig(cfg))

    def total(o):
        res = jloss({"flows_fw": _levels(o, jnp.asarray)}, jnp.asarray(gt),
                    noise={"eps": jnp.asarray(eps)})
        return res["total"], res

    (_, out_j), grad_j = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(out))

    loss = get_loss(Config(cfg))
    assert isinstance(loss, MseLoss)
    leaf = torch.tensor(out, requires_grad=True)
    out_t = loss({"flows_fw": _levels(leaf, torch.from_numpy)},
                 torch.from_numpy(gt), noise={"eps": torch.from_numpy(eps)})
    out_t["total"].backward()
    out_t = {k: v.detach() for k, v in out_t.items()}
    rtol = RESIZE_RTOL if cfg.get("align_corners") else RTOL
    for key in TERMS:
        want = float(out_j[key])
        np.testing.assert_allclose(float(out_t[key]), want, rtol=rtol,
                                   atol=1e-14, err_msg=key)
    if not cfg["diag"] and cfg["offdiag_reg"] > 0:
        assert float(out_t["l_offdiag"]) > 0
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(leaf.grad.numpy(), grad_j, rtol=0,
                               atol=rtol * np.abs(grad_j).max())
    # the bands get a gradient wherever the posterior uses them
    assert (np.abs(grad_j[..., 4:8]).max() > 0) == (not cfg["diag"])


def test_mse_loss_draws_from_a_generator():
    """Without injected noise the loss draws eps from ``generator``:
    n_samples x B entries, sample-major, as ``torch.randn`` gives them."""
    cfg = dict(BASE, n_samples=2)
    out, gt, _ = _inputs(cfg, seed=3)
    loss = MseLoss(Config(cfg))
    res = {"flows_fw": _levels(torch.from_numpy(out), torch.from_numpy)}
    gen = torch.Generator().manual_seed(4)
    drawn = loss(res, torch.from_numpy(gt), generator=gen)
    eps = torch.randn((2 * B, H // 4, W // 4, 2), generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64)
    injected = loss(res, torch.from_numpy(gt), noise={"eps": eps})
    for key in TERMS:
        assert float(drawn[key]) == float(injected[key]), key
    with pytest.raises(ValueError, match="Generator"):
        loss(res, torch.from_numpy(gt))
