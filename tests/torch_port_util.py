"""Shared set-up of the tests that hold ``arflow_tpu_torch``'s UFlow to
``arflow_tpu``'s: JAX parameters from a fixed key, images from a seed, the
port's model with those weights, and the JAX forward."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, uflow_state_dict_from_jax
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)

H, W = 64, 96
CFG = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}


_INIT_SHAPES = {}


def init_shapes(module, *args, **init_kwargs):
    """``jax.eval_shape`` of ``module.init(PRNGKey(0), *args,
    **init_kwargs)`` (``args`` arrays or ``ShapeDtypeStruct``s): the shapes
    of the tree that ``init`` makes, without compiling it. Traced once per
    process for each module (its class and fields), argument shapes,
    keywords and setting of the ``ARFLOW_*`` variables: many tests draw
    weights for one config, and a trace of a full-width model's ``init``
    takes seconds."""
    key = (type(module).__qualname__, repr(module),
           tuple((tuple(a.shape), str(a.dtype)) for a in args),
           tuple(sorted(init_kwargs.items())),
           tuple(sorted((k, v) for k, v in os.environ.items()
                        if k.startswith("ARFLOW_"))))
    if key not in _INIT_SHAPES:
        _INIT_SHAPES[key] = jax.eval_shape(
            lambda r, *a: module.init(r, *a, **init_kwargs),
            jax.random.PRNGKey(0), *args)
    return _INIT_SHAPES[key]


def draw_jax_params(model_cfg, seed=0, size=(H, W), **init_kwargs):
    """Full-width JAX parameters of ``model_cfg`` as numpy float32, drawn
    from ``RandomState(seed)`` in the tree that ``init`` makes (its shapes
    from ``init_shapes`` on images of ``size``, which the PWC-Lite
    family's six levels need divisible by 64): xavier-uniform kernels, as
    the init draws them, and small nonzero biases, so that the bias
    conversion is exercised too."""
    img = jax.ShapeDtypeStruct((1, *size, 3), jnp.float32)
    shapes = init_shapes(jax_get_model(JaxConfig(model_cfg)), img, img,
                         **init_kwargs)["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) == 1:
            return rs.uniform(-0.1, 0.1, shape).astype(np.float32)
        receptive = int(np.prod(shape[:-2]))
        limit = np.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
        return rs.uniform(-limit, limit, shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(scope="module")
def jax_params():
    """Full-width JAX ``PWCFlow`` params (``draw_jax_params``)."""
    return draw_jax_params(CFG, with_bk=False)


def frames(n, seed, dtype=np.float64):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, H, W, 3).astype(dtype) for _ in range(n)]


def port_model(params, dtype=torch.float32):
    model = get_model(Config(CFG), device="cpu")
    model.load_state_dict(uflow_state_dict_from_jax(params), strict=True)
    return model.to(dtype)


def jax_forward(params, img1, img2, with_bk, dtype):
    """JAX ``PWCFlow.apply`` under a fresh jit (env gates are read while
    tracing), ``with_bk`` static."""
    model = jax_get_model(JaxConfig(CFG))
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), params)
    fwd = jax.jit(lambda a, b, bk: model.apply({"params": params}, a, b,
                                                with_bk=bk),
                  static_argnums=2)
    return fwd(jnp.asarray(img1, dtype), jnp.asarray(img2, dtype), with_bk)


def max_gap(res_t, res_j, with_bk):
    """Check keys, counts and shapes; return the largest |port - JAX| over
    all flows of all directions."""
    keys = ["flows_fw"] + (["flows_bw"] if with_bk else [])
    assert sorted(res_t) == sorted(res_j) == sorted(keys)
    gap = 0.0
    for key in keys:
        assert len(res_t[key]) == len(res_j[key]) == 6
        for ft, fj in zip(res_t[key], res_j[key]):
            fj = np.asarray(fj)
            assert tuple(ft.shape) == fj.shape
            assert np.isfinite(fj).all() and torch.isfinite(ft).all()
            gap = max(gap, float(np.abs(ft.numpy() - fj).max()))
    return gap
