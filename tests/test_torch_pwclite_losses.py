"""The PWC-Lite family's losses of ``arflow_tpu_torch`` against
``arflow_tpu``'s: ``UnFlowLoss``, ``ElboLoss`` (with injected noise) and
``FullResLoss``, in float64 on a 6-level pyramid of random flows over a
2x64x96 pair, every output key and the gradient of the total with respect
to every flow level of both directions.

The JAX side runs under ``torch_pwclite_util.lite_env`` (its bilinear
resize weights in float64, its area weights rounded to float32 as the
port's are).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import get_loss as jax_get_loss
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import ElboLoss, FullResLoss, UnFlowLoss, get_loss
from torch_pwclite_util import lite_env  # noqa: F401  (fixture)
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

B, H, W = 2, 64, 96
SIZES = [(H, W), (H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16),
         (H // 32, W // 32), (1, 1)]
# Same float64 math on both sides, summed in other orders.
ATOL = 1e-10

UNFLOW = {"type": "unflow", "w_l1": 0.15, "w_ssim": 0.85, "w_ternary": 0.0,
          "w_smooth": 75.0, "smooth_2nd": True, "alpha": 10.0,
          "w_scales": [1.0, 1.0, 1.0, 1.0, 0.0, 0.0],
          "w_sm_scales": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
          "warp_pad": "border", "with_bk": True, "occ_from_back": True}
FULLRES = {"type": "fullres", "w_l1": 0.15, "w_ssim": 0.85, "w_ternary": 1.0,
           "ternary_distance": 1, "w_smooth": 50.0, "alpha": 10.0,
           "wang_thr": 0.2, "warp_pad": "zeros", "align_corners": True,
           "smooth_2nd": False, "with_bk": True}


def smooth_noise(rs, h, w, c):
    """Normal noise upsampled bicubically from a grid 8 times coarser (a
    bilinear upsample would put the second differences at exactly the
    kink of |.|, where the two packages round to either side)."""
    coarse = torch.from_numpy(rs.randn(B, c, h // 8 + 2, w // 8 + 2))
    return torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bicubic",
        align_corners=True).permute(0, 2, 3, 1).numpy()


def pyramid(seed, log_var=False):
    """Flows per level, finest first, NHWC: smooth fields about 2 pixels
    long at the finest level, scaled down with the level (and a
    log-variance around -1 beside them with ``log_var``)."""
    rs = np.random.RandomState(seed)
    out = []
    for (h, w), s in zip(SIZES, (2.0, 0.5, 0.25, 0.12, 0.06, 0.03)):
        f = s * smooth_noise(rs, h, w, 2)
        if log_var:
            f = np.concatenate([f, -1.0 + 0.3 * rs.randn(B, h, w, 2)], -1)
        out.append(f)
    return out


def flows(seed, **kwargs):
    """Forward flows and backward flows close to their negatives, so that
    forward-backward consistency holds at most pixels."""
    fw = pyramid(seed, **kwargs)
    noise = pyramid(seed + 100, **kwargs)
    bw = [-f + 0.1 * n for f, n in zip(fw, noise)]
    if kwargs.get("log_var"):
        for b, n in zip(bw, noise):
            b[..., 2:] = n[..., 2:]
    return {"flows_fw": fw, "flows_bw": bw}


def images(seed):
    rs = np.random.RandomState(seed)
    base = rs.rand(B, H // 4 + 1, W // 4 + 1, 3)
    # a smooth texture (bilinear 4x of the coarse noise) plus fine noise
    t = torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(0, 3, 1, 2), size=(H, W),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    return [np.clip(t + 0.05 * rs.randn(B, H, W, 3), 0.0, 1.0)
            for _ in range(2)]


def run_both(cfg, res, img1, img2, keys, **noise):
    """Every output of both losses and the gradients of their totals with
    respect to each level of ``res``."""
    jax_loss = jax_get_loss(JaxConfig(cfg))

    def jax_total(r, a, b):
        out = jax_loss(r, a, b, **noise_j)
        return out["total"], out

    noise_j = {k: {n: jnp.asarray(v) for n, v in d.items()}
               for k, d in noise.items()}
    res_j = {k: [jnp.asarray(f) for f in v] for k, v in res.items()}
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        res_j, jnp.asarray(img1), jnp.asarray(img2))

    loss = get_loss(Config(cfg))
    res_t = {k: [torch.from_numpy(f).requires_grad_() for f in v]
             for k, v in res.items()}
    noise_t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
               for k, d in noise.items()}
    out_t = loss(res_t, torch.from_numpy(img1), torch.from_numpy(img2),
                 **noise_t)
    assert sorted(out_t) == sorted(out_j) == sorted(keys)
    for k in keys:
        assert np.isfinite(float(out_j[k])), k
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]),
                                   rtol=1e-12, atol=ATOL, err_msg=k)
    out_t["total"].backward()
    n_nonzero = 0
    for k in res:
        for i, (t, j) in enumerate(zip(res_t[k], grads_j[k])):
            g = np.zeros(t.shape) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(g, np.asarray(j), rtol=0, atol=ATOL,
                                       err_msg=f"{k}[{i}]")
            n_nonzero += int(np.abs(g).max() > 0)
    return loss, out_t, n_nonzero


@pytest.mark.parametrize("overrides", [
    {},
    {"occ_from_back": False, "smooth_2nd": False, "w_ternary": 1.0,
     "warp_pad": "zeros"},
    # level 0 carries no weight: its masks are still the level-0 flow's
    {"w_scales": [0.0, 1.0, 1.0, 0.0, 0.0, 0.0],
     "w_sm_scales": [0.0, 1.0, 0.0, 0.0, 0.0, 0.0], "with_bk": False},
], ids=["issue_config", "brox_1st_ternary_zeros", "w_scales0_zero"])
def test_unflow_loss(lite_env, overrides):
    cfg = dict(UNFLOW, **overrides)
    res = flows(0)
    loss, out, n = run_both(cfg, res, *images(2),
                            ("total", "l_ph", "l_sm", "flow_mean"))
    assert isinstance(loss, UnFlowLoss)
    assert n >= 2 and float(out["l_ph"].detach()) > 0
    assert float(out["l_sm"].detach()) > 0


@pytest.mark.parametrize("occ_from_back", [True, False])
def test_elbo_loss_injected_noise(lite_env, occ_from_back):
    cfg = dict(UNFLOW, type="elbo", occ_from_back=occ_from_back,
               w_entropy=0.01, w_en_scales=[1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    res = flows(3, log_var=True)
    rs = np.random.RandomState(5)
    noise = {}
    for i, (h, w) in enumerate(SIZES):
        noise[f"eps_fw_{i}"] = rs.randn(B, h, w, 2)
        noise[f"eps_bw_{i}"] = rs.randn(B, h, w, 2)
    loss, out, n = run_both(cfg, res, *images(6),
                            ("total", "l_ph", "l_sm", "entropy", "flow_mean"),
                            noise=noise)
    assert isinstance(loss, ElboLoss) and n >= 3
    # the noise was used: other draws give another loss
    other = {k: v + 0.5 for k, v in noise.items()}
    res_t = {k: [torch.from_numpy(f) for f in v] for k, v in res.items()}
    img1, img2 = (torch.from_numpy(x) for x in images(6))
    moved = loss(res_t, img1, img2,
                 noise={k: torch.from_numpy(v) for k, v in other.items()})
    assert abs(float(moved["total"]) - float(out["total"].detach())) > 1e-6
    # or a generator's draws; without either it raises, as JAX does
    drawn = loss(res_t, img1, img2,
                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["total"])
    with pytest.raises(ValueError, match="Generator"):
        loss(res_t, img1, img2)


@pytest.mark.parametrize("overrides", [
    {"occ_type": "wang"},
    {"occ_type": "wang", "wang_thr": 0.0, "align_corners": False},
    {"occ_type": "wang1", "align_corners": False, "smooth_2nd": True},
    {"occ_type": "brox", "warp_pad": "border"},
    {"occ_type": "none", "align_corners": False, "with_bk": False},
], ids=["wang", "wang_soft_ac_false", "wang1_ac_false_2nd", "brox_border",
        "none_ac_false_fw_only"])
def test_fullres_loss(lite_env, overrides):
    cfg = dict(FULLRES, **overrides)
    res = flows(7)
    loss, out, n = run_both(cfg, res, *images(9),
                            ("total", "l_ph", "l_sm", "flow_mean"))
    assert isinstance(loss, FullResLoss) and n >= 2


def test_resize_nearest_indices():
    """The JAX loss's nearest-neighbour indices ``(i * h) // oh``, not
    ``F.interpolate``'s float ones."""
    from arflow_tpu.losses.unflow import _resize_nearest as jax_nearest
    from arflow_tpu_torch.losses.unflow import _resize_nearest

    x = np.random.RandomState(10).rand(B, 37, 53, 1)
    for out_hw in ((7, 11), (13, 29), (36, 52)):
        t = _resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
        want = jax.jit(jax_nearest, static_argnums=1)(jnp.asarray(x), out_hw)
        np.testing.assert_array_equal(t.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
