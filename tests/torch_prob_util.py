"""Shared set-up of the tests that hold ``arflow_tpu_torch``'s probabilistic
UFlow to ``arflow_tpu``'s: the shipped ``out_channels`` layouts, JAX
parameters from a seed, and the float64 JAX forward with the TPU relayouts
off."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model
from torch_port_util import H, draw_jax_params, frames

GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_PYR_BATCH": "0", "ARFLOW_HFOLD": "0"}

# Each shipped out_channels layout: [2,2,0] (diag, sintel_uflow_elbo*.json),
# [2,2,30] (chairs_uflow_elbo_nondiag.json), [2,2,6] with inv_cov
# (chairs_uflow_elbo_nondiag_inv.json), [2,0,30]
# (chairs_uflow_elbo_lowrank.json), the int schema 4
# (chairs_uflow_elbo_gmm.json) and 8 with inv_cov (chairs_uflow_mse.json),
# and two pyramids (chairs_uflow_elbo_mixture.json without its weights net).
CASES = {
    "diag": {"out_channels": [2, 2, 0]},
    "nondiag": {"out_channels": [2, 2, 30]},
    "nondiag_inv": {"out_channels": [2, 2, 6], "inv_cov": True},
    "lowrank": {"out_channels": [2, 0, 30]},
    "int4": {"out_channels": 4},
    "int8_inv": {"out_channels": 8, "inv_cov": True},
    "two_pyramids": {"out_channels": [2, 2, 0], "n_pyramids": 2},
}
COMPONENT = {"type": "component", "out_channels": [2, 2, 0]}
# Same float64 math on both sides; only summation orders differ (measured
# with seed 0: at most 4.3e-14 over all outputs of each case and of
# ComponentNet, on values up to 17.4).
ATOL = 1e-10

_JAX_FWD = {}


def model_cfg(case):
    if case == "component":
        return dict(COMPONENT)
    return {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
            **CASES[case]}


def jax_forward_f64(cfg, params, img1, img2):
    """``apply(..., with_bk=True)`` in float64, jitted once per distinct
    JAX module (the int schema 4 builds the [2,2,0] one), params an
    argument. Set ``GATES_OFF`` before the first call of a module."""
    model = jax_get_model(JaxConfig(cfg))
    if model not in _JAX_FWD:
        _JAX_FWD[model] = jax.jit(lambda p, a, b: model.apply(
            {"params": p}, a, b, with_bk=True))
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)
    return _JAX_FWD[model](params, jnp.asarray(img1), jnp.asarray(img2))


def max_gap(res_t, res_j, keys):
    """Check counts and shapes; the largest |port - JAX| over ``keys``."""
    gap = 0.0
    for key in keys:
        assert len(res_t[key]) == len(res_j[key]) == 6
        for ft, fj in zip(res_t[key], res_j[key]):
            fj = np.asarray(fj)
            assert tuple(ft.shape) == fj.shape
            assert np.isfinite(fj).all() and torch.isfinite(ft).all()
            gap = max(gap, float(np.abs(ft.numpy() - fj).max()))
    return gap


def forward_gap(case, convert, seed, monkeypatch):
    """The port's model of ``case`` with JAX weights from ``seed``, in
    float64, against the JAX forward on a seeded pair: the largest gap over
    both directions with ``with_bk=True`` and the forward alone with
    ``with_bk=False``, and the port's forward outputs."""
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    cfg = model_cfg(case)
    params = draw_jax_params(cfg, seed=seed, with_bk=True)
    img1, img2 = frames(2, seed=seed + 1)
    res_j = jax_forward_f64(cfg, params, img1, img2)
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(convert(params), strict=True)
    model = model.double()
    a, b = torch.from_numpy(img1), torch.from_numpy(img2)
    with torch.no_grad():
        both = model(a, b, with_bk=True)
        fw = model(a, b, with_bk=False)
    assert sorted(both) == ["flows_bw", "flows_fw"] and sorted(fw) == ["flows_fw"]
    gap = max(max_gap(both, res_j, ["flows_fw", "flows_bw"]),
              max_gap(fw, res_j, ["flows_fw"]))
    return gap, model, fw["flows_fw"]


def check_channels(model, flows):
    """Full resolution first; level 1 and finer carry the N extras."""
    l, m, n = model.out_channels
    k = model.n_pyramids
    assert [f.shape[-1] for f in flows] == [k * (l + m + n)] * 3 + [k * (l + m)] * 3
    assert [f.shape[1] for f in flows] == [H // 2 ** i for i in range(6)]
