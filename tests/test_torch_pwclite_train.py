"""The PWC-Lite family's training in ``arflow_tpu_torch`` against
``arflow_tpu``: one step's loss and every parameter's gradient at the
published widths on a 2x64x64 pair in float64 (the JAX package's TPU
relayouts off and its bilinear resize weights in float64,
``torch_pwclite_util.lite_env``), for ``pwclite`` with ``unflow`` (the
JAX package's own PWC-Lite train step, ``benchmarks/bench_bidir_ab.py``)
and ``pwclite_uflow`` with ``fullres`` (``check_step``; the second in
``test_torch_pwclite_train_fullres.py``, each file one JAX compile);
``train.remat``'s gradients against the plain step's; and both trainers
refusing the ``elbo`` loss, as the JAX trainers fail on it.

``train_main`` with this configuration is in
``test_torch_pwclite_cli.py``.
"""

import logging

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import get_loss as jax_get_loss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu.training.uflow_elbo_trainer import (
    UFlowElboTrainer as JaxUFlowElboTrainer,
)
from arflow_tpu.training.uflow_trainer import UFlowTrainer as JaxUFlowTrainer
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, state_dict_from_jax
from arflow_tpu_torch.models import layers as layers_module
from arflow_tpu_torch.models.layers import rematerialized
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.uflow_trainer import ELBO_HAS_NO_TRAINER
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import draw_params, lite_env, port_model  # noqa: F401

B, H, W = 2, 64, 64
PWCLITE = {"type": "pwclite", "n_frames": 2, "upsample": True,
           "reduce_dense": True}
PWCLITE_UFLOW = {"type": "pwclite_uflow", "n_frames": 2, "feature_norm": True}
PWCLITE_PROB = {"type": "pwclite_prob", "n_frames": 2}
# benchmarks/bench_bidir_ab.py's PWC-Lite train step
UNFLOW = {"type": "unflow", "occ_from_back": True, "w_l1": 0.15,
          "w_ssim": 0.85, "w_ternary": 0.0, "w_smooth": 75.0,
          "smooth_2nd": True, "alpha": 10.0,
          "w_scales": [1.0, 1.0, 1.0, 1.0, 0.0, 0.0],
          "w_sm_scales": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
          "warp_pad": "border", "with_bk": True}
FULLRES = {"type": "fullres", "w_l1": 0.15, "w_ssim": 0.85, "w_ternary": 1.0,
           "ternary_distance": 1, "w_smooth": 50.0, "alpha": 10.0,
           "occ_type": "wang", "wang_thr": 0.2, "warp_pad": "border",
           "align_corners": True, "smooth_2nd": False, "with_bk": True}
ELBO = dict(UNFLOW, type="elbo", w_entropy=0.01,
            w_en_scales=[1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
TRAIN = {"batch_size": B, "epoch_num": 1, "epoch_size": 1000, "lr": 1e-4,
         "lr_decay_start_epoch": 100, "lr_decay_factor": 0.5,
         "optim": "adamw", "momentum": 0.9, "beta": 0.999,
         "weight_decay": 1e-4, "bias_decay": 0.0, "print_freq": 100,
         "record_freq": 100, "save_iter": 10**9, "valid_freq": 10**9,
         "valid_size": 0, "seed": 0}
log = logging.getLogger("test")


def pair(seed):
    """A smooth random texture and its copy moved by (1, 2) px, NHWC."""
    rs = np.random.RandomState(seed)
    coarse = torch.from_numpy(rs.rand(B, 3, H // 8 + 2, W // 8 + 2))
    tex = torch.nn.functional.interpolate(
        coarse, size=(H + 8, W + 8), mode="bicubic",
        align_corners=True).clamp(0.0, 1.0).permute(0, 2, 3, 1).numpy()
    return tex[:, 4:4 + H, 4:4 + W], tex[:, 3:3 + H, 2:2 + W]


def _state_dict_f64(tree, cfg):
    """``state_dict_from_jax`` of a float64 tree, kept in float64: the
    converter stores float32 and its map is linear, so the float32 head
    and the remainder convert apart and add up."""
    hi = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    lo = jax.tree_util.tree_map(lambda x, h: np.asarray(x, np.float64) - h,
                                tree, hi)
    sd_hi = state_dict_from_jax(hi, Config(cfg))
    sd_lo = state_dict_from_jax(lo, Config(cfg))
    return {k: sd_hi[k].double() + sd_lo[k].double() for k in sd_hi}


def check_step(model_cfg, loss_cfg):
    """The loss terms and every parameter's gradient of one training step
    (``with_bk=True, train=True``, the loss on the same images) against
    the JAX model and loss."""
    params = draw_params(model_cfg, seed=3)
    img1, img2 = pair(4)
    model_j = jax_get_model(JaxConfig(model_cfg))
    loss_j = jax_get_loss(JaxConfig(loss_cfg))
    a, b = jnp.asarray(img1), jnp.asarray(img2)

    def total(p):
        res = model_j.apply({"params": p}, a, b, with_bk=True, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        out = loss_j(res, a, b)
        return out["total"], out

    p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(total, has_aux=True))(p64)

    model = port_model(model_cfg, params)
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    res = model(t1, t2, with_bk=True, train=True,
                generator=torch.Generator().manual_seed(0))
    out_t = get_loss(Config(loss_cfg))(res, t1, t2)
    out_t["total"].backward()
    for key in ("total", "l_ph", "l_sm", "flow_mean"):
        # Same float64 math on both sides, summation orders apart.
        np.testing.assert_allclose(float(out_t[key].detach()),
                                   float(out_j[key]), rtol=1e-10, err_msg=key)
    grads_j = _state_dict_f64(jax.device_get(grads_j), model_cfg)
    named = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(named)
    reached = 0
    for name, p in named.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        want = grads_j[name]
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-9 * scale + 1e-14,
                                   msg=name)
        reached += int(scale > 0)
    assert reached == len(named)


def test_pwclite_unflow_step_matches_jax(lite_env):
    check_step(PWCLITE, UNFLOW)


@pytest.mark.parametrize("model_cfg,loss_cfg", [
    (PWCLITE, UNFLOW),
    (dict(PWCLITE_UFLOW, level_dropout=0.5), FULLRES),
    (PWCLITE_PROB, ELBO),
], ids=["pwclite", "pwclite_uflow_dropout", "pwclite_prob"])
def test_remat_gradients_equal_plain(model_cfg, loss_cfg, monkeypatch):
    """Under ``rematerialized()`` (``train.remat``) every pyramid level and
    decode level is checkpointed, and the loss and gradients are the plain
    step's; level dropout draws once, outside the regions."""
    torch.manual_seed(0)
    model = get_model(Config(model_cfg), device="cpu").double()
    img1, img2 = (torch.from_numpy(x) for x in pair(5))
    loss = get_loss(Config(loss_cfg))

    def step(remat):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(1)
        with rematerialized() if remat else torch.enable_grad():
            res = model(img1, img2, with_bk=True, train=True, generator=gen)
        kwargs = {"generator": gen} if loss_cfg["type"] == "elbo" else {}
        out = loss(res, img1, img2, **kwargs)
        out["total"].backward()
        return float(out["total"].detach()), {n: p.grad.clone()
                                     for n, p in model.named_parameters()}

    total, grads = step(False)
    regions = []
    checkpoint = layers_module.checkpoint
    monkeypatch.setattr(layers_module, "checkpoint",
                        lambda fn, *a, **k: regions.append(fn) or
                        checkpoint(fn, *a, **k))
    total_r, grads_r = step(True)
    # 6 or 5 pyramid levels per image; 5 decode levels per direction, or 4
    # estimates and the context network
    want = {"pwclite": 2 * 6 + 2 * 5, "pwclite_prob": 2 * 6 + 2 * 5,
            "pwclite_uflow": 2 * 5 + 2 * 5}[model_cfg["type"]]
    assert len(regions) == want
    assert total_r == total
    for n, g in grads.items():
        torch.testing.assert_close(grads_r[n], g, rtol=1e-12, atol=1e-14, msg=n)


class ProbOutputs(nn.Module):
    """A stand-in for ``PWCLiteProb`` with its outputs' shapes (six levels
    of [flow, log-variance] per direction) and one parameter, so that the
    JAX trainers trace their steps around ``ElboLoss`` quickly."""

    @nn.compact
    def __call__(self, img1, img2, with_bk=True, train=False):
        b, h, w, _ = img1.shape
        bias = self.param("bias", nn.initializers.zeros, (4,))
        flows = [jnp.zeros((b, h >> s, w >> s, 4)) + bias
                 for s in (0, 2, 3, 4, 5, 6)]
        return {"flows_fw": flows, "flows_bw": flows}


def test_trainers_refuse_elbo(tmp_path):
    """Neither JAX trainer runs ``ElboLoss``: the uflow trainer's step
    calls the loss without ``rng`` and it raises; the uflow_elbo trainer's
    step reads an ``l_oof`` term that the loss does not return. The
    port's trainers refuse it when they are built, naming both causes."""
    params = {"bias": jnp.zeros((4,), jnp.float32)}
    img1, img2 = (jnp.asarray(x, jnp.float32) for x in pair(7))
    rng = jax.random.PRNGKey(0)
    for cls, args, error, match in (
            (JaxUFlowTrainer, (img1, img2, img1, img2, rng), ValueError, "rng"),
            (JaxUFlowElboTrainer, (img1, img2, rng), KeyError, "l_oof")):
        tr = cls(None, None, ProbOutputs(),
                 jax_get_loss(JaxConfig(ELBO)), log, str(tmp_path / "jax"),
                 JaxConfig(TRAIN), model_cfg=JaxConfig(PWCLITE_PROB))
        tr.tx = jax_create_optimizer(JaxConfig(TRAIN), params, 1)
        tr.state = {"params": params, "opt_state": tr.tx.init(params),
                    "step": jnp.zeros((), jnp.int32)}
        with pytest.raises(error, match=match):
            tr._build_train_step()(tr.state, *args)

    model = get_model(Config(PWCLITE_PROB), device="cpu")
    for name in ("uflow", "uflow_elbo"):
        with pytest.raises(ValueError) as e:
            get_trainer(name)([], None, model, get_loss(Config(ELBO)), log,
                              str(tmp_path / name), Config(TRAIN),
                              model_cfg=Config(PWCLITE_PROB))
        assert str(e.value) == ELBO_HAS_NO_TRAINER
    assert "l_oof" in ELBO_HAS_NO_TRAINER and "noise" in ELBO_HAS_NO_TRAINER
