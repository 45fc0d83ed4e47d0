"""Shared set-up of the tests that hold the port's bfloat16 models to
``arflow_tpu``'s: the JAX cost volume's float32 round trip, JAX forwards in
both dtypes, and the per-level bounds.

The JAX package runs its Pallas cost volume in float32 on bfloat16 features
and casts the result back (``arflow_tpu/ops/cost_volume.py:74-98``), the
path its TPU users run; on the CPU its dispatcher takes the XLA path, which
computes in bfloat16. ``jax_cost_volume_round_trip`` gives the JAX models
that float32 round trip of ``compute_cost_volume_reference``, which
``test_torch_bf16.py`` holds to the Pallas kernel's own round trip
(interpret mode) at a level shape; compiling whole models through the
interpreted kernel would take about 17 s more per model on this CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.ops.cost_volume import compute_cost_volume_reference
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model
from torch_prob_util import GATES_OFF

KEYS = ("flows_fw", "flows_bw")
# tests/test_mixed_precision.py:35 holds JAX's bfloat16 UFlow to its float32
# one at this mean relative gap.
REL_F32 = 0.05


def round_trip(f1, f2, md=4):
    """The JAX dispatcher's bfloat16 path: float32 in, bfloat16 out."""
    if f1.dtype == jnp.bfloat16:
        return compute_cost_volume_reference(
            f1.astype(jnp.float32), f2.astype(jnp.float32), md
        ).astype(jnp.bfloat16)
    return compute_cost_volume_reference(f1, f2, md)


@pytest.fixture(autouse=True)
def jax_cost_volume_round_trip(monkeypatch):
    """The JAX models' cost volume as the TPU runs it, the relayouts off."""
    import arflow_tpu.models.uflow as jax_uflow
    import arflow_tpu.models.uflow_prob as jax_uflow_prob

    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jax_uflow, "compute_cost_volume", round_trip)
    monkeypatch.setattr(jax_uflow_prob, "compute_cost_volume", round_trip)


def jax_forwards(cfg, variables, img1, img2, dtypes=("float32", "bfloat16"),
                 with_bk=True):
    """{dtype: the JAX model's eval forward}, for each of ``dtypes`` from
    the same float32 variables."""
    out = {}
    for dt in dtypes:
        model = jax_get_model(JaxConfig(dict(cfg, dtype=dt)))
        run = jax.jit(lambda v, a, b, m=model: m.apply(v, a, b, with_bk=with_bk))
        out[dt] = jax.device_get(run(variables, jnp.asarray(img1),
                                     jnp.asarray(img2)))
    return out


def port_forwards(cfg, state_dict, img1, img2, dtypes=("float32", "bfloat16"),
                  with_bk=True):
    """{dtype: the port's eval forward} for each of ``dtypes`` from one
    ``state_dict``, which loads strictly into each."""
    out = {}
    for dt in dtypes:
        model = get_model(Config(dict(cfg, dtype=dt)), device="cpu")
        model.load_state_dict(state_dict, strict=True)
        with torch.no_grad():
            out[dt] = model(torch.from_numpy(img1), torch.from_numpy(img2),
                            with_bk=with_bk)
    return out


def level_gaps(port, jax_out, keys=KEYS, low="bfloat16"):
    """Per key and output level, (mean |port low - JAX low|, mean |JAX
    low - JAX f32|, mean |port low - port f32| / mean |port f32|), ``low``
    the dtype held to float32 (bfloat16 or int8); the port's outputs must
    be float32 of JAX's shapes."""
    gaps = {}
    for key in keys:
        assert len(port[low][key]) == len(jax_out[low][key]) == 6
        for lvl in range(6):
            p16, p32 = (port[dt][key][lvl] for dt in (low, "float32"))
            assert p16.dtype == p32.dtype == torch.float32
            j16, j32 = (np.asarray(jax_out[dt][key][lvl], np.float64)
                        for dt in (low, "float32"))
            assert tuple(p16.shape) == j16.shape
            assert torch.isfinite(p16).all()
            p16, p32 = p16.double().numpy(), p32.double().numpy()
            gaps[key, lvl] = (np.abs(p16 - j16).mean(), np.abs(j16 - j32).mean(),
                              np.abs(p16 - p32).mean() / np.abs(p32).mean())
    return gaps


def check_levels(gaps):
    """The acceptance bounds at every level: the port's bfloat16 within
    2 x JAX's own bfloat16 gap + 1e-3 px of JAX's bfloat16, and within
    ``REL_F32`` of the port's float32."""
    bad = {k: v for k, v in gaps.items()
           if not (v[0] <= 2 * v[1] + 1e-3 and v[2] < REL_F32)}
    assert not bad, bad


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def grad_gaps(port16, jax16, port32):
    """Per parameter and over all together (key ``None``): (relative L2 of
    the port's bfloat16 gradient to JAX's, relative L2 of JAX's bfloat16
    gradient to the float32 one), from ``{name: numpy}`` maps with the same
    keys; the float32 gradient is the port's, which the float32 and float64
    tests hold to JAX's."""
    assert sorted(port16) == sorted(jax16) == sorted(port32)
    names = sorted(port16)
    gaps = {n: (rel_l2(port16[n], jax16[n]), rel_l2(jax16[n], port32[n]))
            for n in names if np.abs(port32[n]).max() > 0}

    def cat(g):
        return np.concatenate([g[n].ravel() for n in names])

    gaps[None] = (rel_l2(cat(port16), cat(jax16)), rel_l2(cat(jax16), cat(port32)))
    return gaps


def _flat(grads) -> np.ndarray:
    return np.concatenate([grads[k].ravel() for k in sorted(grads)]).astype(np.float64)


def _cos(a, b) -> float:
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def bf16_step_gaps(model_c, loss_c, noise, seed=8, size=(64, 96)):
    """One train step of ``model_c`` / ``loss_c`` (``noise``: the ELBO
    loss's injected draws, numpy, or None) in bfloat16, both packages, and
    the port's float32 step, from the same JAX weights on a seeded pair of
    1 x ``size`` (the PWC-Lite family's six levels need sides that 64
    divides); checks and returns the gaps.

    - The loss: the port's bfloat16 loss within 2e-3 (relative to the
      float32 one) of JAX's bfloat16 loss.
    - The step's parameter gradients, float32: the parameters that reach
      the loss in float32 reach it in bfloat16 too. At random weights a
      bfloat16 step's gradients are mostly rounding noise in both packages
      (the loss's gradient in the flows is not smooth at bfloat16's
      resolution), so they are held to the float32 ones only in direction:
      cosine >= 0.4.
    - The network's own backward, free of that noise: the vector-Jacobian
      product of every output flow with one seeded cotangent, through the
      bfloat16 model in both packages: over all parameters, its relative
      L2 gap to JAX's at most 2 x JAX's own gap to the float32 one + 1e-3,
      and per parameter at most 2 x the larger of that parameter's and the
      overall gap + 1e-3.
    """
    from arflow_tpu.losses import get_loss as jax_get_loss
    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import state_dict_from_jax
    from torch_mixture_util import image_pair
    from torch_port_util import draw_jax_params

    params = draw_jax_params(model_c, with_bk=True, size=size)
    im1, im2 = (x.astype(np.float32) for x in image_pair(1, seed, *size))
    sd = state_dict_from_jax(params, Config(model_c))
    a, b = torch.from_numpy(im1), torch.from_numpy(im2)
    rs = np.random.RandomState(seed + 1)
    cot = None
    port = {}
    for dt in ("float32", "bfloat16"):
        model = get_model(Config(dict(model_c, dtype=dt)), device="cpu")
        model.load_state_dict(sd, strict=True)
        res = model(a, b, with_bk=True, train=True)
        if cot is None:
            cot = {k: [rs.randn(*f.shape).astype(np.float32) for f in res[k]]
                   for k in KEYS}
        kw = {} if noise is None else {
            "noise": {k: torch.from_numpy(v) for k, v in noise.items()}}
        total = get_loss(Config(loss_c))(res, a, b, **kw)["total"]
        grads = []
        for out in (total, sum((f * torch.from_numpy(c)).sum()
                               for k in KEYS for f, c in zip(res[k], cot[k]))):
            model.zero_grad(set_to_none=True)
            out.backward(retain_graph=True)
            g = {}
            for n, p in model.named_parameters():
                assert p.grad is None or p.grad.dtype == torch.float32
                g[n] = (np.zeros(p.shape, np.float32) if p.grad is None
                        else p.grad.numpy().copy())
            grads.append(g)
        port[dt] = (float(total.detach()), *grads)

    jmodel = jax_get_model(JaxConfig(dict(model_c, dtype="bfloat16")))
    jloss = jax_get_loss(JaxConfig(loss_c))
    ja, jb = jnp.asarray(im1), jnp.asarray(im2)
    jkw = {} if noise is None else {
        "noise": {k: jnp.asarray(v) for k, v in noise.items()}}
    jcot = {k: [jnp.asarray(c) for c in cot[k]] for k in KEYS}

    def step(p):
        res, vjp = jax.vjp(lambda q: jmodel.apply(
            {"params": q}, ja, jb, with_bk=True, train=True), p)
        return jloss(res, ja, jb, **jkw)["total"], vjp(jcot)[0]

    tot_j, vjp_j = jax.device_get(jax.jit(step)(params))
    jv = {k: v.numpy() for k, v in
          state_dict_from_jax(vjp_j, Config(model_c)).items()}
    loss32, grad32, vjp32 = port["float32"]
    loss16, grad16, vjp16 = port["bfloat16"]
    gaps = {"loss": (abs(loss16 - float(tot_j)) / abs(loss32),
                     abs(float(tot_j) - loss32) / abs(loss32))}
    nonzero = [{k for k, v in g.items() if np.abs(v).max() > 0}
               for g in (grad16, grad32, jv)]
    assert nonzero[0] == nonzero[1] == nonzero[2]
    gaps["grad_cos"] = _cos(_flat(grad16), _flat(grad32))
    gaps["vjp"] = (rel_l2(_flat(vjp16), _flat(jv)),
                   rel_l2(_flat(jv), _flat(vjp32)))
    # Per parameter against the larger of its own and the overall noise:
    # a coarse level's few parameters see the noise of the whole backward.
    floor = gaps["vjp"][1]
    per = {k: (rel_l2(vjp16[k], jv[k]), max(rel_l2(jv[k], vjp32[k]), floor))
           for k in sorted(vjp32) if np.abs(vjp32[k]).max() > 0}
    gaps["vjp_worst"] = max(per.items(), key=lambda kv: kv[1][0] / kv[1][1])
    assert gaps["loss"][0] <= 2e-3, gaps
    assert gaps["grad_cos"] >= 0.4, gaps
    assert gaps["vjp"][0] <= 2 * gaps["vjp"][1] + 1e-3, gaps
    bad = {k: v for k, v in per.items() if not v[0] <= 2 * v[1] + 1e-3}
    assert not bad, bad
    return gaps
