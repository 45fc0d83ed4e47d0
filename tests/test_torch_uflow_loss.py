"""The port's ``UFlowLoss`` against ``arflow_tpu.losses.UFlowLoss``: both
paths (``with_bk`` batched and single-direction), smoothness of order 1 and
2, in float64 and float32. The loss terms and the gradient of the total
with respect to all 12 flows (``jax.grad`` against autograd).

Flows are random, large enough that the warps leave the image and the
range maps hold holes and overlaps; images are smooth random textures.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowLoss as JaxUFlowLoss
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowLoss, get_loss
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H, W = 2, 32, 48
LOSS_CFG = {"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
            "w_census": 1.0}
KEYS = ("total", "l_ph", "l_sm", "flow_mean")


def _inputs(dtype):
    rs = np.random.RandomState(0)
    flows = {key: [(rs.randn(B, H >> i, W >> i, 2) * (3.0 / 2**i)).astype(dtype)
                   for i in range(6)]
             for key in ("flows_fw", "flows_bw")}
    base = rs.rand(B, H // 8 + 1, W // 8 + 1, 3)
    imgs = [np.clip(np.kron(base, np.ones((1, 8, 8, 1)))[:, :H, :W]
                    + 0.05 * rs.randn(B, H, W, 3), 0, 1).astype(dtype)
            for _ in range(2)]
    return flows, imgs


def _jax(cfg, flows, imgs):
    loss = JaxUFlowLoss(JaxConfig(cfg))

    def total(fl):
        out = loss(fl, jnp.asarray(imgs[0]), jnp.asarray(imgs[1]))
        return out["total"], out

    fl = jax.tree_util.tree_map(jnp.asarray, flows)
    (_, out), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(fl)
    return out, grads


# (loss terms relative, flow gradients relative to their largest element).
# float64: the same arithmetic in other summation orders (measured: loss
# terms within 5.1e-15, gradients within 2.7e-13 of the largest). float32:
# torch's and XLA's roundings of the census, whose neighbour differences of
# 255-scaled intensities lose digits to cancellation, and of the second
# differences of smooth order 2 (measured: 5.4e-6 and 9.4e-4).
TOL = {np.float64: (1e-10, 1e-10), np.float32: (5e-5, 5e-3)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("smooth_order", [1, 2])
@pytest.mark.parametrize("with_bk", [True, False])
def test_uflow_loss_and_flow_grads(with_bk, smooth_order, dtype):
    cfg = dict(LOSS_CFG, smooth_order=smooth_order, with_bk=with_bk)
    flows, imgs = _inputs(dtype)
    out_j, grads_j = _jax(cfg, flows, imgs)

    res = {k: [torch.from_numpy(f).requires_grad_() for f in v]
           for k, v in flows.items()}
    out_t = get_loss(Config(cfg))(res, torch.from_numpy(imgs[0]),
                                  torch.from_numpy(imgs[1]))
    out_t["total"].backward()

    tol, grad_tol = TOL[dtype]
    for key in KEYS:
        np.testing.assert_allclose(float(out_t[key].detach()),
                                   float(out_j[key]), rtol=tol, err_msg=key)
    # The mask's 4x upsample: the JAX package keeps its interpolation
    # weights in float32 (ops/resize.py:_resize_matrix) in either dtype.
    np.testing.assert_allclose(out_t["mask1"].numpy(),
                               np.asarray(out_j["mask1"]), rtol=0, atol=1e-6)
    assert 0 < float(out_t["mask1"].mean()) < 1
    # The flows the total reads; the backward level-2 flow only through the
    # (detached) occlusion mask unless with_bk.
    used = {("flows_fw", 0), ("flows_fw", 2)}
    if with_bk:
        used |= {("flows_bw", 0), ("flows_bw", 2)}
    for key in ("flows_fw", "flows_bw"):
        for i, (ft, gj) in enumerate(zip(res[key], grads_j[key])):
            gj = np.asarray(gj)
            scale = float(np.abs(gj).max())
            if (key, i) not in used:  # no gradient in torch, zeros in JAX
                assert ft.grad is None and scale == 0, (key, i)
                continue
            assert scale > 0, (key, i)
            np.testing.assert_allclose(ft.grad.numpy(), gj, rtol=0,
                                       atol=grad_tol * scale,
                                       err_msg=f"{key}[{i}]")


def test_smooth_order_has_no_default():
    """Like the JAX loss, a config without smooth_order raises."""
    flows, imgs = _inputs(np.float64)
    res = {k: [torch.from_numpy(f) for f in v] for k, v in flows.items()}
    with pytest.raises(AttributeError, match="smooth_order"):
        UFlowLoss(Config(dict(LOSS_CFG, with_bk=True)))(
            res, torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]))
