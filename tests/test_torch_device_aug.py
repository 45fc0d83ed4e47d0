"""The port's photometric augmentation on the device
(``arflow_tpu_torch/data/device_aug.py``) against the JAX package's
``make_photometric`` on the same injected parameters, and against the
port's own host transforms driven by scripted draws (the mirror of
``tests/test_device_aug.py``). float32 throughout; the bound is 1e-6
absolute against JAX (the two order float32 rounding alike but for the
contrast mean's reduction order) and 2e-6 against the host transforms, as
the JAX file holds its pair.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.data.device_aug import make_photometric as jax_make_photometric
from arflow_tpu_torch.data import transforms as T
from arflow_tpu_torch.data.device_aug import (
    device_photometric_cfg,
    make_photometric,
)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

FULL_CFG = {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
            "hue": 0.5, "gamma": 1, "swap_channels": True}
HUE_CFG = {"hue": 0.5, "swap_channels": True}
PERMS = list(itertools.permutations(range(4)))
ORDERS = [(0, 1, 2, 3), (3, 1, 0, 2), (2, 3, 1, 0)]
FACTORS = [0.85, 1.12, 0.94, -0.21, 1.3]  # b, c, s, h; gamma
CHAN_PERM = (2, 0, 1)


class ScriptedRng:
    """A RandomState stand-in returning scripted uniform draws and a fixed
    shuffle/permutation."""

    def __init__(self, uniforms, perm=None):
        self.uniforms = list(uniforms)
        self.perm = perm

    def uniform(self, lo, hi):
        v = self.uniforms.pop(0)
        assert lo - 1e-6 <= v <= hi + 1e-6, (v, lo, hi)
        return v

    def shuffle(self, x):
        if self.perm is not None:
            x[:] = [x[i] for i in self.perm]

    def permutation(self, n):
        return np.asarray(self.perm if self.perm is not None else range(n))


def _images(seed, shape):
    imgs = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    # grey and tied pixels through the HSV round trip
    imgs[0, 0, 0, 0] = 0.5
    imgs[0, 0, 0, 1] = [0.7, 0.7, 0.2]
    imgs[0, 0, 0, 2] = [0.0, 0.0, 0.0]
    return imgs


def _params(b, orders, factors=FACTORS, chan_perm=CHAN_PERM):
    """Injected params, one order per sample: numpy, for both packages."""
    names = ("brightness", "contrast", "saturation", "hue", "gamma")
    p = {k: np.full((b,), v, np.float32) for k, v in zip(names, factors)}
    p["order"] = np.asarray([PERMS.index(tuple(o)) for o in orders], np.int32)
    p["channel_perm"] = np.tile(np.asarray(chan_perm, np.int32), (b, 1))
    return p


def _port_apply(cfg, imgs, params, device="cpu"):
    _, apply = make_photometric(cfg)
    tp = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    return apply(torch.from_numpy(imgs).to(device), tp).cpu().numpy()


def _jax_apply(cfg, imgs, params):
    _, apply = jax_make_photometric(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jax.jit(apply)(jnp.asarray(imgs), jp))


@pytest.mark.parametrize("order", ORDERS)
def test_full_photometric_matches_jax(order):
    """Every op in one of the orders ``tests/test_device_aug.py`` uses."""
    imgs = _images(0, (2, 2, 24, 32, 3))  # (B, F, H, W, 3)
    params = _params(2, [order] * 2)
    got = _port_apply(FULL_CFG, imgs, params)
    want = _jax_apply(FULL_CFG, imgs, params)
    assert got.dtype == np.float32 and got.shape == imgs.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mixed_orders_in_one_batch_match_jax():
    """Each sample its own order and factors: the per-position select."""
    imgs = _images(1, (4, 2, 16, 24, 3))
    params = _params(4, ORDERS + [(1, 0, 3, 2)])
    rs = np.random.RandomState(2)
    for k, (lo, hi) in (("brightness", (0.7, 1.3)), ("contrast", (0.7, 1.3)),
                        ("saturation", (0.7, 1.3)), ("hue", (-0.5, 0.5)),
                        ("gamma", (0.7, 1.5))):
        params[k] = rs.uniform(lo, hi, 4).astype(np.float32)
    params["channel_perm"] = np.stack(
        [rs.permutation(3) for _ in range(4)]).astype(np.int32)
    np.testing.assert_allclose(_port_apply(FULL_CFG, imgs, params),
                               _jax_apply(FULL_CFG, imgs, params),
                               rtol=0, atol=1e-6)


def test_hue_only_matches_jax():
    imgs = _images(3, (3, 2, 16, 16, 3))
    params = {"hue": np.full((3,), -0.37, np.float32),
              "channel_perm": np.tile(np.int32([1, 2, 0]), (3, 1))}
    np.testing.assert_allclose(_port_apply(HUE_CFG, imgs, params),
                               _jax_apply(HUE_CFG, imgs, params),
                               rtol=0, atol=1e-6)


def _host_photometric(imgs, factors, order, chan_perm):
    cj = T.ColorJitter(FULL_CFG["brightness"], FULL_CFG["contrast"],
                       FULL_CFG["saturation"], FULL_CFG["hue"],
                       rng=ScriptedRng(factors[:4], perm=order))
    gamma = T.RandomGamma(rng=ScriptedRng([factors[4]]))
    swap = T.RandomSwapChannels(rng=ScriptedRng([], perm=chan_perm))
    return swap(gamma(cj(imgs)))


@pytest.mark.parametrize("order", ORDERS)
def test_apply_matches_host_transforms(order):
    """The port's ``apply`` against its host ``ColorJitter``,
    ``RandomGamma`` and ``RandomSwapChannels`` with the same factors."""
    imgs = _images(4, (2, 2, 24, 32, 3))
    host = np.stack([_host_photometric(im, FACTORS, order, CHAN_PERM)
                     for im in imgs])
    got = _port_apply(FULL_CFG, imgs, _params(2, [order] * 2))
    np.testing.assert_allclose(got, host, rtol=0, atol=2e-6)


def test_hue_only_matches_host_transforms():
    imgs = _images(5, (3, 2, 16, 16, 3))
    d, perm = -0.37, (1, 2, 0)
    host = np.stack([
        T.RandomSwapChannels(rng=ScriptedRng([], perm=perm))(
            T.ColorJitter(hue=0.5, rng=ScriptedRng([d]))(im)) for im in imgs])
    params = {"hue": np.full((3,), d, np.float32),
              "channel_perm": np.tile(np.int32(perm), (3, 1))}
    np.testing.assert_allclose(_port_apply(HUE_CFG, imgs, params), host,
                               rtol=0, atol=2e-6)


def test_sample_params_ranges_and_shapes():
    sample_params, _ = make_photometric(FULL_CFG)
    gen = torch.Generator().manual_seed(0)
    p = sample_params(gen, 64, "cpu")
    assert set(p) == {"brightness", "contrast", "saturation", "hue", "order",
                      "gamma", "channel_perm"}
    for k in ("brightness", "contrast", "saturation", "hue", "gamma"):
        assert p[k].dtype == torch.float32 and p[k].shape == (64,)
    assert 0.7 <= p["brightness"].min() and p["brightness"].max() <= 1.3
    assert -0.5 <= p["hue"].min() and p["hue"].max() <= 0.5
    assert 0.7 <= p["gamma"].min() and p["gamma"].max() <= 1.5
    assert p["order"].shape == (64,)
    assert 0 <= p["order"].min() and p["order"].max() < 24
    assert p["channel_perm"].shape == (64, 3)
    assert (p["channel_perm"].sort(1).values == torch.arange(3)).all()
    assert len(p["brightness"].unique()) > 32
    # the generator's state alone decides the draws
    again = sample_params(torch.Generator().manual_seed(0), 64, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    # one op: no order; no gamma or swap unless asked
    assert set(make_photometric({"hue": 0.5})[0](gen, 4, "cpu")) == {"hue"}


def test_grad_flows_through_apply():
    """The augmentation sits inside the train step; a gradient through it
    is finite and equals JAX's."""
    cfg = {"brightness": 0.3, "hue": 0.2}
    imgs = np.random.RandomState(6).rand(2, 1, 8, 8, 3).astype(np.float32)
    params = {"brightness": np.float32([0.9, 1.2]),
              "hue": np.float32([0.1, -0.15]),
              "order": np.int32([0, 1])}
    _, apply = make_photometric(cfg)
    w = torch.tensor(1.0, requires_grad=True)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    (apply(torch.from_numpy(imgs) * w, tp) ** 2).sum().backward()
    _, jax_apply = jax_make_photometric(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    g = jax.grad(lambda w: (jax_apply(jnp.asarray(imgs) * w, jp) ** 2).sum())(
        jnp.float32(1.0))
    assert np.isfinite(float(w.grad))
    np.testing.assert_allclose(float(w.grad), float(g), rtol=1e-5)


def test_device_photometric_cfg():
    on = {"hue": 0.5, "device": True}
    assert device_photometric_cfg({"data": [
        {"type": "valid", "photometric_aug": on},
        {"type": "train", "photometric_aug": on}]}) is on
    assert device_photometric_cfg({"data": [
        {"type": "train", "photometric_aug": {"hue": 0.5}}]}) is None
    assert device_photometric_cfg(None) is None


@pytest.mark.gpu
def test_apply_on_cuda_matches_cpu():
    """The card's ``apply`` against the CPU's on the same injected params,
    every op and mixed orders, at a b8 pair batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs = np.random.RandomState(7).rand(8, 2, 64, 96, 3).astype(np.float32)
    sample_params, _ = make_photometric(FULL_CFG)
    p = sample_params(torch.Generator().manual_seed(8), 8, "cpu")
    params = {k: v.numpy() for k, v in p.items()}
    for cfg in (FULL_CFG, HUE_CFG):
        cp = {k: v for k, v in params.items()
              if k in make_photometric(cfg)[0](torch.Generator(), 1, "cpu")}
        np.testing.assert_allclose(_port_apply(cfg, imgs, cp, "cuda"),
                                   _port_apply(cfg, imgs, cp), rtol=0,
                                   atol=1e-6)
