"""Shared set-up of the tests that hold ``arflow_tpu_torch``'s PWC-Lite
family to ``arflow_tpu``'s: JAX parameters drawn from a seed in the tree
that ``init`` makes, images from a seed, the port's model with those
weights in float64, the float64 JAX forward with the TPU relayouts off,
and the comparison of their outputs level by level.

The 6-level PWC-Lite pyramid needs sides divisible by 64: the tests run at
64x128, batch 2."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import arflow_tpu.ops.resize as jax_resize
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model, state_dict_from_jax
from torch_port_util import init_shapes

B, H, W = 2, 64, 128
# The JAX package's relayouts, off: the W-fold pyramid (on by default at
# inference, arflow_tpu/models/pwclite_uflow.py:63 and pwclite.py:69) and
# the bidirectional / window batching.
GATES_OFF = {"ARFLOW_WFOLD_PYR": "0", "ARFLOW_BIDIR_BATCH": "0"}

_JAX_FWD = {}


_JAX_RESIZE_MATRIX = jax_resize._resize_matrix


@functools.lru_cache(maxsize=None)
def resize_matrix_f64(in_size, out_size, mode, align_corners):
    """``arflow_tpu/ops/resize.py:_resize_matrix``'s bilinear weights kept
    in float64. The JAX function rounds them to float32, which at
    ``align_corners=True`` (the PWC-Lite upsampling) is not exact: the
    float64 JAX flows then part from the float64 port's by about 1e-6 px,
    and every other difference would hide under that. With the weights in
    float64 the two part by about 1e-14. The ``area`` weights stay the JAX
    function's, rounded to float32, as the port's ``resize_area`` rounds
    them."""
    if mode == "area":
        return _JAX_RESIZE_MATRIX(in_size, out_size, mode, align_corners)
    assert mode == "bilinear"
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners:
        src = (np.zeros(1) if out_size == 1 else
               np.arange(out_size) * (in_size - 1) / (out_size - 1))
    else:
        src = np.maximum((np.arange(out_size) + 0.5) * in_size / out_size
                         - 0.5, 0.0)
    x0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w1 = src - x0
    np.add.at(m, (np.arange(out_size), x0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), x1), w1)
    return m


@pytest.fixture(scope="module")
def lite_env():
    """The JAX relayouts off and its resize weights in float64, for a whole
    test module (the traces keep what they saw)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in GATES_OFF.items():
            mp.setenv(k, v)
        mp.setattr(jax_resize, "_resize_matrix", resize_matrix_f64)
        yield


def n_init_frames(cfg) -> int:
    return 3 if cfg.get("n_frames", 2) in (3, 5) else 2


def draw_params(model_cfg, seed=0):
    """Full-width JAX parameters of ``model_cfg`` as numpy float32, drawn
    from ``RandomState(seed)`` in the tree that ``init`` makes (shapes from
    ``init_shapes``): kernels normal with variance 1 / fan_in (half the
    kaiming init's, so that the flows of random weights stay within a few
    tens of pixels over six levels), biases small and nonzero, so that the
    bias conversion is exercised too."""
    img = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    imgs = [img] * n_init_frames(model_cfg)
    shapes = init_shapes(jax_get_model(JaxConfig(model_cfg)), *imgs)["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) == 1:
            return rs.uniform(-0.1, 0.1, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def images(n, seed, b=B, dtype=np.float64):
    rs = np.random.RandomState(seed)
    return [rs.rand(b, H, W, 3).astype(dtype) for _ in range(n)]


def port_model(model_cfg, params, dtype=torch.float64):
    """The port's model of ``model_cfg`` with the JAX ``params``, on the
    CPU, in ``dtype``."""
    cfg = Config(model_cfg)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model.to(dtype)


def jax_forward(model_cfg, params, imgs, with_bk, dtype=jnp.float64,
                train=False, rngs=None):
    """The JAX model's ``apply`` under jit, one trace per (module,
    frames, ``with_bk``, ``train``); set ``GATES_OFF`` before."""
    model = jax_get_model(JaxConfig(model_cfg))
    key = (model, len(imgs), with_bk, train)
    if key not in _JAX_FWD:
        _JAX_FWD[key] = jax.jit(lambda p, r, *a: model.apply(
            {"params": p}, *a, with_bk=with_bk, train=train, rngs=r))
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), params)
    return _JAX_FWD[key](params, rngs,
                         *[jnp.asarray(x, dtype) for x in imgs])


def run_port(model, imgs, **kwargs):
    with torch.no_grad():
        return model(*[torch.from_numpy(x) for x in imgs], **kwargs)


def level_gaps(ours: list, theirs: list) -> list:
    """max |port - JAX| per output level, after checking counts, shapes
    and finiteness."""
    assert len(ours) == len(theirs)
    gaps = []
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (tuple(a.shape), b.shape)
        assert torch.isfinite(a).all() and np.isfinite(b).all()
        gaps.append(float(np.abs(a.numpy() - b).max()))
    return gaps


def max_abs(levels) -> float:
    return max(float(np.abs(np.asarray(f)).max()) for f in levels)


# Same float64 math on both sides, the JAX resize weights in float64; only
# summation orders differ (measured: at most 1.6e-14 px on flows up to 8.7).
ATOL_5 = 1e-10


def check_5frame(params, with_bk):
    """The 5-frame PWCLite against the JAX one: 'flows_fw' [1 -> 2, 2 -> 3]
    and with ``with_bk`` 'flows_bw' [2 -> 1, 3 -> 2], every level; and the
    port's 3-frame windows in sequence, bit for bit."""
    cfg = {"type": "pwclite", "n_frames": 5}
    imgs = images(5, seed=3)
    res_j = jax_forward(cfg, params, imgs, with_bk=with_bk)
    model = port_model(cfg, params)
    res_t = run_port(model, imgs, with_bk=with_bk)
    keys = ["flows_bw", "flows_fw"] if with_bk else ["flows_fw"]
    assert sorted(res_t) == sorted(res_j) == keys
    for key in keys:
        assert len(res_t[key]) == len(res_j[key]) == 2
        for ours, theirs in zip(res_t[key], res_j[key]):
            gaps = level_gaps(ours, theirs)
            assert max(gaps) < ATOL_5, (key, gaps)
    # the windows are the 3-frame network's on frames (0,1,2), (1,2,3), (2,3,4)
    win = [run_port(model, imgs[s:s + 3]) for s in range(3)]
    want = {"flows_fw": [win[0]["flows_fw"], win[1]["flows_fw"]],
            "flows_bw": [win[1]["flows_bw"], win[2]["flows_bw"]]}
    for key in keys:
        for ours, theirs in zip(res_t[key], want[key]):
            for a, b in zip(ours, theirs):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
