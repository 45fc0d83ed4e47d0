"""ELBO training of the probabilistic UFlow against ``arflow_tpu`` at full
default widths on 64x96 pairs, in float64 with the JAX package's TPU
relayouts off:

- level dropout of ``PWCProbFlow(train=True)`` with two pyramids (four
  (component, direction) groups on one decoder pass) and of
  ``ComponentNet`` (two nets of two groups), with the same uniform draws
  injected on both sides, each group dropped at some levels and kept at
  others;
- one ELBO step, ``configs/chairs_uflow_elbo.json``'s model (dropout off)
  and loss with the same injected noise: the loss terms and every
  parameter's gradient.

The trainer is in ``test_torch_elbo_lockstep.py`` (against the JAX
trainer) and ``test_torch_elbo_trainer.py`` (validation, checkpoints,
``train_main``).
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowElboLoss as JaxElboLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import (
    component_state_dict_from_jax,
    get_model,
    uflow_prob_state_dict_from_jax,
)
from torch_port_util import H, W, draw_jax_params, few_torch_threads, frames  # noqa: F401
from torch_prob_util import ATOL, GATES_OFF, max_gap, model_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 0.5


def _draws(n_calls, groups, seed):
    """Uniform draws, one (groups,) array per dropout call, in which each
    group is dropped (u <= P) at some call and kept at another."""
    rs = np.random.RandomState(seed)
    while True:
        u = rs.rand(n_calls, groups)
        if ((u <= P).any(axis=0) & (u > P).any(axis=0)).all():
            return list(u)


def _jax_train_forward(cfg, params, img1, img2, draws, monkeypatch):
    """The JAX model's training forward, ``with_bk=True``, float64, its
    ``jax.random.uniform`` dropout draws taken from ``draws`` in order."""
    queue = list(draws)

    def uniform(key, shape=(), dtype=None, *args, **kwargs):
        u = queue.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return jnp.asarray(u, jnp.float64)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    model = jax_get_model(JaxConfig(cfg))
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)
    res = jax.jit(lambda p, a, b: model.apply(
        {"params": p}, a, b, with_bk=True, train=True,
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(img1), jnp.asarray(img2))
    monkeypatch.undo()
    assert not queue
    return res


@pytest.mark.parametrize("case", ["two_pyramids", "component"])
def test_level_dropout_per_group_matches_jax(case, monkeypatch):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    cfg = dict(model_cfg(case), level_dropout=P)
    # (draws per forward pass, groups per draw): 4 levels and the
    # refinement; two pyramids x two directions on one pass, or each of
    # ComponentNet's two nets with its two directions.
    calls, groups = (5, 4) if case == "two_pyramids" else (10, 2)
    draws = _draws(calls, groups, seed=calls)
    params = draw_jax_params(cfg, seed=1, with_bk=True)
    img1, img2 = frames(2, seed=2)
    res_j = _jax_train_forward(cfg, params, img1, img2, draws, monkeypatch)
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)

    convert = (component_state_dict_from_jax if case == "component"
               else uflow_prob_state_dict_from_jax)
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(convert(params), strict=True)
    model = model.double()
    queue = list(draws)

    def rand(shape, generator=None, device=None, **kwargs):
        assert generator is not None
        u = queue.pop(0)
        assert u.shape == tuple(shape)
        return torch.from_numpy(u)

    monkeypatch.setattr(torch, "rand", rand)
    with torch.no_grad():
        res_t = model(torch.from_numpy(img1), torch.from_numpy(img2),
                      with_bk=True, train=True, generator=torch.Generator())
    monkeypatch.undo()
    assert not queue
    assert max_gap(res_t, res_j, ["flows_fw", "flows_bw"]) < ATOL
    # The drops reached the outputs: the same weights without dropout differ.
    with torch.no_grad():
        plain = model(torch.from_numpy(img1), torch.from_numpy(img2))
    assert max_gap(plain, res_j, ["flows_fw"]) > 1e-3


def _state_dict_f64(tree):
    """``uflow_prob_state_dict_from_jax`` of a float64 tree, kept in
    float64: the converter stores float32 and its map is linear, so the
    float32 head and remainder convert apart and add up."""
    hi = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    lo = jax.tree_util.tree_map(lambda x, h: np.asarray(x, np.float64) - h,
                                tree, hi)
    sd_hi, sd_lo = (uflow_prob_state_dict_from_jax(t) for t in (hi, lo))
    return {k: sd_hi[k].double() + sd_lo[k].double() for k in sd_hi}


def test_one_elbo_step_matches_jax_loss_and_param_grads(monkeypatch):
    """chairs_uflow_elbo.json's model and loss (closed-form isotropic
    smoothness, the diag posterior), dropout off, the same noise."""
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")
    with open(os.path.join(REPO, "configs", "chairs_uflow_elbo.json")) as f:
        full = json.load(f)
    model_c = dict(full["model"], level_dropout=0.0)
    loss_c = dict(full["loss"], type="uflow_elbo")
    params = draw_jax_params(model_c, seed=4, with_bk=True)
    img1, img2 = frames(2, seed=5)
    rs = np.random.RandomState(6)
    noise = {k: rs.randn(1, H // 4, W // 4, 2) for k in ("eps12", "eps21")}

    model_j = jax_get_model(JaxConfig(model_c))
    loss_j = JaxElboLoss(JaxConfig(loss_c))
    a, b = jnp.asarray(img1), jnp.asarray(img2)
    jnoise = {k: jnp.asarray(v) for k, v in noise.items()}

    def total(p):
        res = model_j.apply({"params": p}, a, b, with_bk=True, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        out = loss_j(res, a, b, noise=jnoise)
        return out["total"], out

    params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(total, has_aux=True))(params64)

    model = get_model(Config(model_c), device="cpu")
    model.load_state_dict(uflow_prob_state_dict_from_jax(params), strict=True)
    model = model.double()
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    res_t = model(t1, t2, with_bk=True, train=True)
    out_t = get_loss(Config(loss_c))(
        res_t, t1, t2, noise={k: torch.from_numpy(v) for k, v in noise.items()})
    out_t["total"].backward()

    for key in ("total", "l_ph", "l_sm", "entropy", "l_oof"):
        np.testing.assert_allclose(float(out_t[key].detach()), float(out_j[key]),
                                   rtol=1e-10, atol=1e-13, err_msg=key)
    grads_j = _state_dict_f64(jax.device_get(grads_j))
    params_t = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params_t)
    zero = set()
    for name, param in params_t.items():
        got = torch.zeros_like(param) if param.grad is None else param.grad
        want = grads_j[name]
        scale = float(want.abs().max())
        # Measured: within 3.7e-12 of each parameter's largest gradient.
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * scale,
                                   msg=name)
        if scale == 0:
            zero.add(name)
    # Only the context deconvs of levels 0 and 1 reach no output.
    assert zero == {f"_context_up_layers.{i}.{w}" for i in (0, 1)
                    for w in ("weight", "bias")}
