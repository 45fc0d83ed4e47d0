"""``PWCFlow(train=True)`` and ``UFlowLoss`` against the JAX model in
training mode on the full-width model at 1x64x96, float64, the JAX package's
TPU relayouts off: flows, the loss and every parameter's gradient of the
loss (``jax.grad`` against autograd), at two level-dropout rates.

- p = 0: no level drops; the gradients run through the whole network, the
  cost volume's backward (its plain version here) included.
- p = 1: every draw drops on both sides, whatever the random bits, so no
  parameter reaches a flow.

The spatial objective (``parallel.spatial_value_and_grad``) on gloo ranks
of ``torch_ddp_util.Pool``, meshes (1, 2) and (1, 4), is held to the same
JAX loss and gradients, the counterpart of the JAX
``test_spatial_train_grads_match_single_device``: one JAX ``value_and_grad``
per rate serves both tests, and the ranks run while it compiles.
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
from torch_ddp_util import Ranks
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


RATES = (0.0, 1.0)
SPATIAL = {"1x2": 2, "1x4": 4}  # the meshes' space ranks (one data group)


@pytest.fixture(scope="module")
def jax_refs(jax_params, tmp_path_factory):
    """Per level-dropout rate: the JAX float64 ``value_and_grad`` of the
    loss (relayouts off) at 1x64x96 (``(total, res, grads)``), and the
    ranks' ``spatial_train_case`` on each mesh, submitted before the JAX
    side compiles."""
    root = tmp_path_factory.mktemp("spatial_train_grads")
    sd = str(root / "w.pt")
    torch.save(uflow_state_dict_from_jax(jax_params), sd)
    img1, img2 = frames(2, seed=6)
    a, b = jnp.asarray(img1), jnp.asarray(img2)
    params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                      jax_params)
    loss_j = JaxUFlowLoss(JaxConfig(LOSS_CFG))
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in GATES_OFF.items():
            mp.setenv(k, v)
        for p in RATES:
            cfg = dict(CFG, level_dropout=p)
            pending = {key: Ranks(
                {"model": cfg, "state_dict": sd, "dtype": "float64",
                 "n_spatial": s, "img1": img1, "img2": img2,
                 "loss": LOSS_CFG, "seed": 0},
                root / f"{key}-{p}", world=s, entry="spatial_train_case")
                for key, s in SPATIAL.items()}
            model_j = jax_get_model(JaxConfig(cfg))

            def total(params, model_j=model_j):
                res = model_j.apply({"params": params}, a, b, with_bk=True,
                                    train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)})
                return loss_j(res, a, b)["total"], res

            (tot_j, res_j), grads_j = jax.jit(
                jax.value_and_grad(total, has_aux=True))(params64)
            refs[p] = {"total": tot_j, "res": res_j,
                       "grads": _state_dict_f64(jax.device_get(grads_j)),
                       "spatial": {key: r.results()
                                   for key, r in pending.items()}}
    return refs


def _zero_grads(p):
    """The parameters whose JAX gradient is zero: at p = 0 only the context
    deconvs of levels 0 and 1 reach no flow; at p = 1 every one."""
    return None if p == 1.0 else {f"_context_up_layers.{i}.{w}"
                                  for i in (0, 1) for w in ("weight", "bias")}


@pytest.mark.parametrize("p", RATES)
def test_train_matches_jax_flows_loss_and_param_grads(jax_params, jax_refs,
                                                      monkeypatch, p):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    img1, img2 = frames(2, seed=6)
    tot_j, res_j, grads_j = (jax_refs[p][k] for k in ("total", "res", "grads"))

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
    assert zero == (_zero_grads(p) or set(params))


@pytest.mark.parametrize("key", list(SPATIAL))
@pytest.mark.parametrize("p", RATES)
def test_spatial_train_matches_jax_loss_and_param_grads(jax_refs, p, key):
    """The spatial objective on the ranks, float64: every rank's loss and
    averaged gradients equal bit for bit; the loss within 1e-12 of the JAX
    loss and each parameter's gradient within 1e-10 of its largest JAX
    entry, the one-process port's bounds (none where the JAX gradient is
    zero). Measured at p = 0: the loss within 2.2e-16, each gradient within
    7.0e-12 on both meshes."""
    runs = jax_refs[p]["spatial"][key]
    for run in runs:
        assert run["values"] == runs[0]["values"]
        assert run["digest"] == runs[0]["digest"]
    np.testing.assert_allclose(runs[0]["values"]["total"],
                               float(jax_refs[p]["total"]), rtol=1e-12)
    grads_j = jax_refs[p]["grads"]
    grads = runs[0]["grads"]
    assert sorted(grads) == sorted(grads_j)
    zero = set()
    for name, want in grads_j.items():
        got = grads[name]
        got = torch.zeros_like(want) if got is None else torch.from_numpy(got)
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * scale,
                                   msg=name)
        if scale == 0:
            zero.add(name)
    assert zero == (_zero_grads(p) or set(grads_j))
