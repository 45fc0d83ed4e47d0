"""``model.dtype`` bfloat16 in the port against ``arflow_tpu``'s on the CPU:

- ``get_model`` parses the dtypes as the JAX factory does and builds every
  ``uflow`` / ``uflow_prob`` / ``component`` model (with and without
  ``mixture_weights``) in bfloat16 with float32 parameters, the float32
  model's ``state_dict`` keys and float32 outputs; a JAX checkpoint's
  weights load into it unchanged (``models/weights.py`` needs no dtype);
  ``int8`` raises and names its roadmap item;
- the cost volume's float32 round trip: float32 into the op, forward and
  backward, bfloat16 out, and bfloat16 gradients of bfloat16 features,
  equal to the JAX Pallas kernel's round trip (interpret mode).

The models against the JAX models in bfloat16, per output level: ``PWCFlow``
in ``test_torch_bf16_uflow.py``, ``PWCProbFlow`` in
``test_torch_bf16_prob.py``, ``ComponentNet`` with the mixture weights net
in ``test_torch_bf16_component.py`` (a file each: each compiles its JAX
model anew); the train steps in ``test_torch_bf16_train.py``.
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, parse_dtype, state_dict_from_jax
from arflow_tpu_torch.ops import compute_cost_volume
from arflow_tpu_torch.ops.cuda import cost_volume as cv_module
from torch_mixture_util import COMPONENT_MIXTURE, MIXTURE, image_pair
from torch_port_util import draw_jax_params, few_torch_threads  # noqa: F401

UFLOW = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}
PROB = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
        "out_channels": [2, 2, 0]}
COMPONENT = {"type": "component", "out_channels": [2, 2, 0]}


@pytest.mark.parametrize("name, want", [
    (None, None), ("float32", None), ("f32", None),
    ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16)])
def test_parse_dtype(name, want):
    assert parse_dtype(name) is want


def test_int8_raises_and_names_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*int8"):
        get_model(Config(dict(UFLOW, dtype="int8")), device="cpu")


@pytest.mark.parametrize("cfg", [UFLOW, PROB, COMPONENT, MIXTURE,
                                 COMPONENT_MIXTURE],
                         ids=["uflow", "uflow_prob", "component",
                              "uflow_prob_mixture", "component_mixture"])
def test_bf16_models_keep_float32_params_and_outputs(cfg):
    """The bfloat16 model has the float32 model's parameters, buffers and
    keys, in float32, and returns float32 from a float32 forward of the
    same weights within 0.05 mean relative."""
    m32 = get_model(Config(cfg), device="cpu")
    m16 = get_model(Config(dict(cfg, dtype="bfloat16")), device="cpu")
    sd32, sd16 = m32.state_dict(), m16.state_dict()
    assert list(sd32) == list(sd16)
    for k in sd32:
        assert sd16[k].dtype == sd32[k].dtype and sd16[k].shape == sd32[k].shape
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    m16.load_state_dict(sd32, strict=True)
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in image_pair(1, 0))
    with torch.no_grad():
        r32, r16 = m32(a, b), m16(a, b)
    assert sorted(r16) == sorted(r32)
    for key in r16:
        outs16 = r16[key] if isinstance(r16[key], list) else [r16[key]]
        outs32 = r32[key] if isinstance(r32[key], list) else [r32[key]]
        for x, y in zip(outs16, outs32):
            assert x.dtype == torch.float32 and x.shape == y.shape
            assert torch.isfinite(x).all()
        rel = float((outs16[0] - outs32[0]).abs().mean()
                    / outs32[0].abs().mean().clamp_min(1e-6))
        assert rel < 0.05, (key, rel)


def test_jax_weights_load_into_the_bf16_model():
    """``state_dict_from_jax`` has no dtype: a JAX parameter tree loads
    strictly into the bfloat16 model as into the float32 one."""
    params = draw_jax_params(PROB, with_bk=True)
    sd = state_dict_from_jax(params, Config(PROB))
    model = get_model(Config(dict(PROB, dtype="bf16")), device="cpu")
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_cost_volume_round_trip(monkeypatch):
    """bfloat16 features (B,C,H,W) of a level shape: the op sees float32
    in both directions, the output and both gradients are bfloat16, and
    they equal the JAX dispatcher's Pallas path (``ARFLOW_USE_PALLAS=1``,
    interpret mode, its float32 round trip and custom VJP)."""
    seen = []

    def spy(fn):
        def wrapped(*args):
            seen.append((fn.__name__, [a.dtype for a in args
                                       if isinstance(a, torch.Tensor)]))
            return fn(*args)
        return wrapped

    for name in ("compute_cost_volume_reference", "cost_volume_grad_reference"):
        monkeypatch.setattr(cv_module, name, spy(getattr(cv_module, name)))
    rs = np.random.RandomState(3)
    f1, f2 = (rs.randn(2, 32, 8, 12).astype(np.float32) for _ in range(2))
    g = rs.randn(2, 81, 8, 12).astype(np.float32)
    t1, t2 = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (f1, f2))
    out = compute_cost_volume(t1, t2, 4)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == t1.grad.dtype == t2.grad.dtype == torch.bfloat16
    assert [s[0] for s in seen] == ["compute_cost_volume_reference",
                                    "cost_volume_grad_reference"]
    assert all(d == torch.float32 for _, dts in seen for d in dts), seen

    monkeypatch.setenv("ARFLOW_USE_PALLAS", "1")
    from arflow_tpu.ops.cost_volume import compute_cost_volume as jax_cv

    def nhwc(x):
        return jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)

    def loss(a, b):
        out = jax_cv(a, b, 4)
        return jnp.sum(out.astype(jnp.float32) * nhwc(g).astype(jnp.float32)), out

    (_, out_j), (ga, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(nhwc(f1), nhwc(f2))
    assert out_j.dtype == ga.dtype == jnp.bfloat16
    for got, want in ((out, out_j), (t1.grad, ga), (t2.grad, gb)):
        got = got.detach().float().permute(0, 2, 3, 1).numpy()
        # Equal bit for bit (measured): the float32 sums round to the same
        # bfloat16 values here.
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
