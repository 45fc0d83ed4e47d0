"""``PWCFlow(train=True)`` and ``UFlowLoss`` against the JAX model in
training mode on the full-width model at 1x64x96, float64, the JAX package's
TPU relayouts off: flows, the loss and every parameter's gradient of the
loss (``jax.grad`` against autograd), at two level-dropout rates.

- p = 0: no level drops; the gradients run through the whole network, the
  cost volume's backward (its plain version here) included.
- p = 1: every draw drops on both sides, whatever the random bits, so no
  parameter reaches a flow.
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.losses import UFlowLoss as JaxUFlowLoss
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import UFlowLoss
from arflow_tpu_torch.models import get_model, uflow_state_dict_from_jax
from torch_port_util import (  # noqa: F401  (fixtures: jax_params, few_torch_threads)
    CFG,
    frames,
    few_torch_threads,
    jax_params,
    max_gap,
)

GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_PYR_BATCH": "0", "ARFLOW_HFOLD": "0"}
LOSS_CFG = {"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
            "w_census": 1.0, "smooth_order": 1, "with_bk": True}


def _port(params, level_dropout):
    model = get_model(Config(dict(CFG, level_dropout=level_dropout)),
                      device="cpu")
    model.load_state_dict(uflow_state_dict_from_jax(params), strict=True)
    return model.to(torch.float64)


def _state_dict_f64(tree):
    """``uflow_state_dict_from_jax`` of a float64 tree, kept in float64: the
    converter stores float32, and its map (transposes, flips) is linear, so
    the float32 head and the float32 remainder convert apart and add up."""
    hi = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    lo = jax.tree_util.tree_map(
        lambda x, h: np.asarray(x, np.float64) - h, tree, hi)
    sd_hi, sd_lo = uflow_state_dict_from_jax(hi), uflow_state_dict_from_jax(lo)
    return {k: sd_hi[k].double() + sd_lo[k].double() for k in sd_hi}


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_train_matches_jax_flows_loss_and_param_grads(jax_params, monkeypatch,
                                                      p):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    img1, img2 = frames(2, seed=6)
    cfg = dict(CFG, level_dropout=p)

    model_j = jax_get_model(JaxConfig(cfg))
    loss_j = JaxUFlowLoss(JaxConfig(LOSS_CFG))
    a, b = jnp.asarray(img1), jnp.asarray(img2)

    def total(params):
        res = model_j.apply({"params": params}, a, b, with_bk=True,
                            train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_j(res, a, b)["total"], res

    params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                      jax_params)
    (tot_j, res_j), grads_j = jax.jit(
        jax.value_and_grad(total, has_aux=True))(params64)

    model = _port(jax_params, p)
    t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
    res_t = model(t1, t2, with_bk=True, train=True,
                  generator=torch.Generator().manual_seed(0))
    tot_t = UFlowLoss(Config(LOSS_CFG))(res_t, t1, t2)["total"]
    tot_t.backward()

    # Same float64 math on both sides, summation orders apart.
    assert max_gap({k: [f.detach() for f in v] for k, v in res_t.items()},
                   res_j, True) < 1e-10
    np.testing.assert_allclose(float(tot_t.detach()), float(tot_j), rtol=1e-12)
    # None in torch where the graph never reaches a parameter (level 0's
    # context deconv, and every parameter at p = 1), zeros in JAX.
    grads_j = _state_dict_f64(jax.device_get(grads_j))
    params = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params)
    zero = set()
    for name, param in params.items():
        got = torch.zeros_like(param) if param.grad is None else param.grad
        want = grads_j[name]
        scale = float(want.abs().max())
        # Measured: within 8e-12 of each parameter's largest gradient.
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * scale,
                                   msg=name)
        if scale == 0:
            zero.add(name)
    # At p = 0 only the context deconvs of levels 0 and 1 reach no flow.
    assert zero == (set(params) if p == 1.0 else
                    {f"_context_up_layers.{i}.{w}" for i in (0, 1)
                     for w in ("weight", "bias")})
