"""Shared set-up of the tests that hold the port's ``UFlowElboLoss`` to
``arflow_tpu``'s: the loss configs, seeded level-2 outputs, images and
draws, and one call of each loss with the gradient of its total."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowElboLoss as JaxElboLoss
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowElboLoss, get_loss

B, H, W = 2, 64, 96
H2, W2 = H // 4, W // 4

# configs/chairs_uflow_elbo.json's loss, but for the keys each case sets.
BASE = {
    "type": "uflow_elbo", "edge_constant": 150.0, "edge_asymp": 0.01,
    "w_smooth": 4.0, "penalty_smooth": "charbonnier",
    "data_loss": ["census"], "data_weight": [1.0],
    "data_penalty": ["abs_robust_loss"], "w_entropy": 0.1, "w_oof": 0.0,
    "w_occ": 0.0, "with_bk": True, "approx": "diag", "n_components": 1,
    "inv_cov": False, "approx_entropy": False, "occ_type": "sample",
    "n_samples": 1, "offdiag_reg": 0.0, "natural_grad": False,
}
GMM = {"pi": [0.6, 0.4], "beta": [4.0, 0.25]}
TERMS = ("total", "l_ph", "l_sm", "entropy", "l_oof")
MAPS = ("flow12_2", "occu_mask12", "valid_mask12")
# float64 on both sides, the same arithmetic in other summation orders:
# measured over all cases of both test files at most 1.8e-15 relative on
# the terms, 3.6e-15 on the maps and 8.0e-12 of the largest gradient
# element.
RTOL, GRAD_RTOL = 1e-10, 1e-10


def channels(cfg):
    if cfg["approx"] == "diag":
        return 4
    if cfg["approx"] == "sparse":
        return 4 + 2 * ((cfg["cov_supp"] + 1) ** 2 - 1)
    if cfg["approx"] == "mixture":
        return 4 * cfg["n_components"]
    return 2 + 2 * cfg["columns"]


def inputs(cfg, seed):
    """Level-2 outputs of both directions (means of a few pixels, so that
    warps leave the image and the range maps hold holes; log-diagonals
    near -1; small bands), images, draws and, where the case sets
    ``given_weights``, mixture weights; numpy float64."""
    rs = np.random.RandomState(seed)
    c, n = channels(cfg), cfg["n_samples"]
    outs = {}
    for key in ("flows_fw", "flows_bw"):
        out = rs.randn(B, H2, W2, c)
        if cfg["approx"] == "lowrank":
            out[..., 2:] = 0.3 * out[..., 2:]
        else:
            k = cfg.get("n_components", 1)
            out[..., :2 * k] *= 2.5
            out[..., 2 * k:4 * k] = 0.3 * out[..., 2 * k:4 * k] - 1.0
            out[..., 4 * k:] *= 0.2
        outs[key] = out
    base = rs.rand(B, H // 8 + 1, W // 8 + 1, 3)
    imgs = [np.clip(np.kron(base, np.ones((1, 8, 8, 1)))[:, :H, :W]
                    + 0.05 * rs.randn(B, H, W, 3), 0, 1) for _ in range(2)]
    if cfg["approx"] == "lowrank":
        shape = (n * B, 1, 1, 2 * cfg["columns"])
    else:
        shape = (n * B, H2, W2, 2)
    noise = {"eps12": rs.randn(*shape), "eps21": rs.randn(*shape)}
    extra = {}
    if cfg["approx"] == "mixture":
        k = cfg["n_components"]
        noise["z12"] = rs.randint(0, k, (B, n))
        noise["z21"] = rs.randint(0, k, (B, n))
        if cfg.get("given_weights"):
            w = rs.rand(B, k) + 0.2
            extra = {"weights_fw": w / w.sum(1, keepdims=True),
                     "weights_bw": w[::-1] / w[::-1].sum(1, keepdims=True)}
    return outs, imgs, noise, extra


def model_outputs(outs, extra, array):
    """The dict the losses read: 6 outputs per direction, the level-2 one
    at index 2 (the others are not read), and any mixture weights."""
    res = {key: [array(np.zeros((B, 1, 1, 1)))] * 2 + [out]
           + [array(np.zeros((B, 1, 1, 1)))] * 3 for key, out in outs.items()}
    res.update({k: array(v) for k, v in extra.items()})
    return res


def jax_loss(cfg, outs, imgs, noise, extra):
    """The JAX loss and the gradient of its total with respect to both
    directions' level-2 outputs, jitted (a refusal raises while tracing)."""
    loss = JaxElboLoss(JaxConfig(cfg))

    def total(fw, bw, a, b, jnoise):
        res = model_outputs({"flows_fw": fw, "flows_bw": bw}, extra, jnp.asarray)
        out = loss(res, a, b, noise=jnoise)
        return out["total"], out

    fn = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))
    (_, out), grads = fn(jnp.asarray(outs["flows_fw"]), jnp.asarray(outs["flows_bw"]),
                         jnp.asarray(imgs[0]), jnp.asarray(imgs[1]),
                         {k: jnp.asarray(v) for k, v in noise.items()})
    return out, grads


def port_loss(cfg, outs, imgs, noise, extra):
    """The port's loss and, by autograd, the same gradients."""
    loss = get_loss(Config(cfg))
    assert isinstance(loss, UFlowElboLoss)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    res = model_outputs(leaves, extra, lambda v: torch.from_numpy(np.array(v)))
    out = loss(res, torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]),
               noise={k: torch.from_numpy(v) for k, v in noise.items()})
    out["total"].backward()
    return out, (leaves["flows_fw"].grad, leaves["flows_bw"].grad)


def check_case(cfg, seed):
    """Every term, map and output gradient of the port against JAX."""
    args = inputs(cfg, seed)
    out_j, grads_j = jax_loss(cfg, *args)
    out_t, grads_t = port_loss(cfg, *args)
    for key in TERMS:
        np.testing.assert_allclose(float(out_t[key].detach()), float(out_j[key]),
                                   rtol=RTOL, atol=1e-13, err_msg=key)
    assert float(out_t["l_ph"].detach()) > 0 and float(out_t["l_sm"].detach()) > 0
    if cfg["w_oof"] > 0:
        assert float(out_t["l_oof"].detach()) > 0  # the sampled flows leave the frame
    for key in MAPS:
        if out_j[key] is None:
            assert out_t[key] is None, key
            continue
        want = np.asarray(out_j[key])
        assert tuple(out_t[key].shape) == want.shape, key
        np.testing.assert_allclose(out_t[key].detach().numpy(), want, rtol=0,
                                   atol=RTOL * max(np.abs(want).max(), 1),
                                   err_msg=key)
    for g_t, g_j in zip(grads_t, grads_j):
        g_j = np.asarray(g_j)
        if g_t is None:  # no path from the total (one direction, no occlusion)
            assert not cfg["with_bk"] and not np.any(g_j)
            continue
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(g_j).max())
    # the forward direction always has a gradient
    assert np.abs(np.asarray(grads_j[0])).max() > 0
