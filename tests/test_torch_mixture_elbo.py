"""ELBO training of chairs_uflow_elbo_mixture.json's model (two pyramids
and ``MixtureWeightsNet``) against ``arflow_tpu`` at full default widths
on 64x96 pairs at b2, in float64 with the JAX package's TPU relayouts off:

- one ELBO step, the config's loss (mixture posterior with the predicted
  weights, n_samples 6) with the same injected draws (``eps12``, ``eps21``,
  ``z12``, ``z21``): the loss terms, every parameter's gradient, the
  ResNet's included, and the running statistics flax's ``batch_stats``
  hold after the step;

The trainers in lockstep and a resumed ``train_main`` run are in
``test_torch_mixture_lockstep.py`` (each file compiles its JAX functions
anew, so they are kept apart to keep each file short).
"""

import json
import os

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowElboLoss as JaxElboLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, uflow_prob_state_dict_from_jax
from torch_mixture_util import MIXTURE, as_f64, draw_variables, image_pair, stats_gap
from torch_port_util import H, W, few_torch_threads  # noqa: F401
from torch_prob_util import GATES_OFF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow_elbo_mixture.json")
B = 2
TERMS = ("total", "l_ph", "l_sm", "entropy", "l_oof")
# float64 on both sides. Measured with these seeds: the loss terms and the
# running statistics within 1e-12; the gradients within 4.4e-9 of each
# parameter's largest element, the flow network's too (3.5e-9), where
# chairs_uflow_elbo.json's step, without the weights net, is within
# 3.7e-12: the ResNet's last stage normalizes 2 values per channel at b2
# and 64x96 (flax's one-pass variance cancels there), and the weights it
# gives reach every flow parameter through the mixture's log-density.
LOSS_RTOL, STATS_RTOL, GRAD_RTOL = 1e-10, 1e-10, 1e-7


@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")


def loss_section():
    with open(CONFIG) as f:
        return json.load(f)["loss"]


def draws(seed, n):
    rs = np.random.RandomState(seed)
    noise = {k: rs.randn(n * B, H // 4, W // 4, 2) for k in ("eps12", "eps21")}
    noise.update({k: rs.randint(0, 2, (B, n)) for k in ("z12", "z21")})
    return noise


def state_dict_f64(variables):
    """``uflow_prob_state_dict_from_jax`` of a float64 tree, in float64:
    the converter stores float32 and its map is linear, so the float32 head
    and remainder convert apart and add up."""
    hi = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)
    lo = jax.tree_util.tree_map(lambda x, h: np.asarray(x, np.float64) - h,
                                variables, hi)
    sd_hi, sd_lo = uflow_prob_state_dict_from_jax(hi), uflow_prob_state_dict_from_jax(lo)
    return {k: sd_hi[k].double() + sd_lo[k].double() for k in sd_hi
            if sd_hi[k].is_floating_point()}


def param_grads_f64(grads, stats):
    """The JAX parameter gradients as the port's parameter names."""
    sd = state_dict_f64({"params": grads, "batch_stats": stats})
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var"))}


def test_one_mixture_elbo_step_matches_jax(monkeypatch):
    loss_c = loss_section()
    noise = draws(seed=21, n=loss_c["n_samples"])
    jmodel = jax_get_model(JaxConfig(MIXTURE))
    img = jnp.zeros((B, H, W, 3), jnp.float32)
    variables = draw_variables(jmodel, (img, img), seed=22, with_bk=True)
    img1, img2 = image_pair(B, seed=23)
    jloss = JaxElboLoss(JaxConfig(loss_c))
    a, b = jnp.asarray(img1), jnp.asarray(img2)
    jnoise = {k: jnp.asarray(v) for k, v in noise.items()}
    v64 = as_f64(variables)

    def total(p):
        res, upd = jmodel.apply({"params": p, "batch_stats": v64["batch_stats"]},
                                a, b, with_bk=True, train=True,
                                mutable=["batch_stats"])
        out = jloss(res, a, b, noise=jnoise)
        return out["total"], (out, upd["batch_stats"])

    (_, (out_j, stats_j)), grads_j = jax.jit(
        jax.value_and_grad(total, has_aux=True))(v64["params"])

    model = get_model(Config(MIXTURE), device="cpu")
    model.load_state_dict(uflow_prob_state_dict_from_jax(variables), strict=True)
    model = model.double()
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    res_t = model(t1, t2, with_bk=True, train=True)
    out_t = get_loss(Config(loss_c))(
        res_t, t1, t2, noise={k: torch.from_numpy(v) for k, v in noise.items()})
    out_t["total"].backward()

    for key in TERMS:
        np.testing.assert_allclose(float(out_t[key].detach()), float(out_j[key]),
                                   rtol=LOSS_RTOL, atol=1e-13, err_msg=key)
    assert stats_gap(model._mixture_weights_net.resnet,
                     stats_j["mixture_weights_net"]["resnet"], "") < STATS_RTOL
    grads_j = param_grads_f64(jax.device_get(grads_j), variables["batch_stats"])
    params_t = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params_t)
    # A downsample conv's bias feeds a BatchNorm in training mode, which
    # removes any constant: its gradient is zero up to rounding, on both
    # sides, and is held to the largest gradient of the net instead.
    largest = max(float(g.abs().max()) for g in grads_j.values())
    gaps, resnet = {}, 0
    for name, param in params_t.items():
        got = torch.zeros_like(param) if param.grad is None else param.grad
        want = grads_j[name]
        scale = largest if name.endswith("downsample.0.bias") else float(want.abs().max())
        gaps[name] = float((got - want).abs().max()) / max(scale, 1e-300)
        resnet += name.startswith("_mixture_weights_net.") and scale > 0
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    assert worst[0][1] < GRAD_RTOL, worst
    assert resnet == 20 + 3 + 40 + 2  # every conv, BatchNorm and fc parameter

