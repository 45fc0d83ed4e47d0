"""``model.dtype`` int8's operator and switches in the port against
``arflow_tpu``'s on the CPU (``arflow_tpu_torch/models/layers.py``):

- ``quantized_conv2d`` against ``arflow_tpu.models.layers.quantized_conv2d``
  under ``jit``, at the UFlow pyramid's conv shapes, float32 and bfloat16
  inputs: the int8 activations, int8 weights and int32 sums equal JAX's
  (caught inside the JAX function at its int8 conv), the float32 outputs
  equal, at batch 1 within what 1 ulp of the dequantization scale moves
  (``check_against_jax``); on the quantization grid, on random
  inputs, a sample's result independent of its batch, an all-zero sample
  and an all-zero output channel (the 1e-6 and 1e-12 clamps);
- the ``torch._int_mm`` route (``int8_conv``) against its plain version
  (``int8_conv_reference``), int32 sums equal bit for bit, where the GEMM
  needs no padding and where it pads M or K;
- ``parse_dtype`` / ``get_model`` with int8 over all six model types,
  ``ARFLOW_INT8_PYRAMID`` both ways, the per-instance rule, ``train_main``'s
  two refusals, and a JAX int8 model's parameters through
  ``state_dict_from_jax``.

No JAX model is compiled here; the models against the JAX models are in
``test_torch_int8_uflow.py``, ``_prob.py``, ``_component.py`` and
``_pwclite.py``, serving in ``_serving.py``.
"""

import types

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax

import arflow_tpu.models.layers as jax_layers
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.models import get_model, parse_dtype, state_dict_from_jax
from arflow_tpu_torch.models import layers
from torch_port_util import draw_jax_params, few_torch_threads  # noqa: F401

UFLOW = {"type": "uflow", "feature_norm": True, "level_dropout": 0.0}
PROB = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.0,
        "out_channels": [2, 2, 0]}
COMPONENT = {"type": "component", "out_channels": [2, 2, 0]}
PWCLITE = ({"type": "pwclite", "n_frames": 2},
           {"type": "pwclite_prob", "n_frames": 2},
           {"type": "pwclite_uflow", "n_frames": 2})
# The UFlow pyramid's conv shapes (B, H, W, Cin, Cout, stride) at small
# sizes: each level's stride-2 first conv (Cin 3 at the stem, 32 above)
# and its stride-1 convs.
PYRAMID_SHAPES = [(2, 16, 24, 3, 32, 2), (2, 16, 24, 32, 32, 2),
                  (2, 8, 12, 32, 32, 1), (1, 4, 6, 32, 32, 1)]


@pytest.fixture
def jax_int8(monkeypatch):
    """``arflow_tpu.models.layers.quantized_conv2d`` under ``jit``, with the
    int8 tensors it convolves and the int32 sums caught at its
    ``lax.conv_general_dilated``: ``run(x, kernel, bias, stride)`` ->
    (float32 output, {"xq", "wq", "yi"}) as numpy, NHWC / HWIO."""
    caught = {}

    def conv(xq, wq, *args, **kwargs):
        y = lax.conv_general_dilated(xq, wq, *args, **kwargs)
        jax.debug.callback(lambda a, b, c: caught.update(
            xq=np.asarray(a), wq=np.asarray(b), yi=np.asarray(c)), xq, wq, y)
        return y

    shim = types.SimpleNamespace(**{n: getattr(lax, n) for n in dir(lax)
                                    if not n.startswith("__")})
    shim.conv_general_dilated = conv
    monkeypatch.setattr(jax_layers, "lax", shim)

    def run(x, kernel, bias, stride):
        f = jax.jit(lambda a, k, b: jax_layers.quantized_conv2d(
            a, k, b, stride=stride, pad=1))
        out = np.asarray(f(x, jnp.asarray(kernel), jnp.asarray(bias)))
        return out, dict(caught)

    return run


def port_int8(xt, kernel, bias, stride):
    """The port's quantized conv of an NCHW tensor with an HWIO kernel:
    (float32 NHWC output, {"xq", "wq", "yi", "scale"} NHWC / HWIO /
    (B,1,1,O)) as numpy."""
    w = torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()
    b = torch.from_numpy(bias)
    xq, ax = layers.quantize_activations(xt)
    wq, sw = layers.quantize_weights(w)
    yi = layers.int8_conv(xq, wq, stride, 1)
    out = layers.dequantize(yi, ax, sw, b, torch.float32)
    whole = layers.quantized_conv2d(xt, w, b, stride, 1, torch.float32)
    assert torch.equal(out, whole) and whole.is_contiguous()
    return (out.permute(0, 2, 3, 1).numpy(),
            {"xq": xq.numpy(), "wq": wq.permute(2, 3, 1, 0).numpy(),
             "yi": yi.numpy(), "scale": (ax * sw).numpy()})


def check_against_jax(jax_int8, x, kernel, bias, stride, dtype="float32"):
    """NHWC ``x`` in ``dtype`` through both packages: the port's int8
    tensors and int32 sums equal JAX's; the float32 outputs equal JAX's at
    batch 2 and more, and at batch 1 within what a 1-ulp scale moves."""
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    out_j, ints_j = jax_int8(xj, kernel, bias, stride)
    out_p, ints_p = port_int8(xt, kernel, bias, stride)
    for key in ("xq", "wq", "yi"):
        assert ints_p[key].dtype == ints_j[key].dtype
        np.testing.assert_array_equal(ints_p[key], ints_j[key], err_msg=key)
    assert out_p.dtype == out_j.dtype == np.float32
    if x.shape[0] > 1:
        np.testing.assert_array_equal(out_p, out_j)
    else:
        # XLA folds a batch of one's two scales' ``/ 127`` into one
        # ``/ 16129`` (its fused HLO: ``max_w * (max_x * 6.2e-05)``), so
        # JAX's scale ``ax * sw`` may part from the port's by 1 ulp, which
        # the product ``y * scale`` carries, and the sum rounds once more.
        # The port keeps one arithmetic for every batch: a sample's result
        # does not depend on its batch.
        tol = (np.abs(ints_p["yi"]) * np.spacing(ints_p["scale"])
               + np.spacing(np.abs(out_j)))
        assert np.all(np.abs(out_p - out_j) <= tol)
    return out_p


def draw(shape, seed):
    b, h, w, cin, cout, _ = shape
    rs = np.random.RandomState(seed)
    x = rs.randn(b, h, w, cin).astype(np.float32)
    kernel = (rs.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = rs.uniform(-0.1, 0.1, cout).astype(np.float32)
    return x, kernel, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PYRAMID_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_quantized_conv2d_matches_jax_on_random_inputs(jax_int8, shape, dtype):
    x, kernel, bias = draw(shape, seed=sum(shape))
    check_against_jax(jax_int8, x, kernel, bias, shape[-1], dtype)


def test_exact_on_quantization_grid(jax_int8):
    """The JAX test's grid inputs (``tests/test_int8_conv.py``): quantized
    losslessly, so the port equals the float32 conv to float tolerance
    (the JAX test's 1e-5), and JAX's int8 conv."""
    rs = np.random.RandomState(0)
    xi = rs.randint(-127, 128, (2, 12, 16, 8)).astype(np.float32)
    xi[:, 0, 0, 0] = 127.0
    ki = rs.randint(-127, 128, (3, 3, 8, 16)).astype(np.float32)
    ki[0, 0, 0, :] = 127.0
    x = (xi / 127.0 * 0.5).astype(np.float32)
    kernel = (ki / 127.0 * 0.03).astype(np.float32)
    bias = rs.rand(16).astype(np.float32)
    out = check_against_jax(jax_int8, x, kernel, bias, 1)
    exact = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(kernel).permute(3, 2, 0, 1),
                     torch.from_numpy(bias), padding=1)
    np.testing.assert_allclose(out, exact.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_per_sample_scales_batch_independent(jax_int8):
    """A sample's result equals its result alone, bit for bit, next to a
    sample 50x larger (b1 streaming numerics == batched), as JAX's."""
    rs = np.random.RandomState(1)
    x1 = rs.rand(1, 12, 16, 32).astype(np.float32)
    x_out = 50.0 * rs.rand(1, 12, 16, 32).astype(np.float32)
    _, kernel, bias = draw((1, 1, 1, 32, 32, 1), seed=2)
    solo = check_against_jax(jax_int8, x1, kernel, bias, 2)
    batched = check_against_jax(jax_int8, np.concatenate([x1, x_out]), kernel,
                                bias, 2)
    np.testing.assert_array_equal(solo[0], batched[0])


def test_zero_sample_and_zero_channel(jax_int8):
    """An all-zero sample (scale clamped at 1e-6 / 127) and an all-zero
    output channel (clamped at 1e-12 / 127) quantize to zeros: their
    outputs are the bias, as JAX's."""
    x, kernel, bias = draw((2, 8, 12, 32, 32, 1), seed=3)
    x[1] = 0.0
    kernel[..., 5] = 0.0
    out = check_against_jax(jax_int8, x, kernel, bias, 1)
    np.testing.assert_array_equal(out[1], np.broadcast_to(bias, out[1].shape))
    np.testing.assert_array_equal(out[0, ..., 5], np.full(out.shape[1:3], bias[5]))


# (B, H, W, Cin, Cout, stride): the UFlow pyramid's convs; M <= 16 (padded
# to 17 rows); the stem's K = 27 (padded to 32); the PWC-Lite pyramid's
# channels (16 -> 32 -> 64 ... 192).
ROUTE_SHAPES = PYRAMID_SHAPES + [(1, 6, 6, 32, 32, 2), (3, 10, 14, 3, 16, 2),
                                 (2, 8, 8, 16, 32, 2), (1, 4, 6, 192, 192, 1)]


@pytest.mark.parametrize("shape", ROUTE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int_mm_route_equals_plain_version(shape):
    b, h, w, cin, cout, stride = shape
    g = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=g, dtype=torch.int8)
    xq[0, 0, 0, 0] = wq[0, 0, 0, 0] = -127  # the extremes reach every sum
    got = layers.int8_conv(xq, wq, stride, 1)
    want = layers.int8_conv_reference(xq, wq, stride, 1)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (b, (h - 1) // stride + 1,
                                       (w - 1) // stride + 1, cout)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name, want", [("int8", torch.bfloat16),
                                        ("bfloat16", torch.bfloat16),
                                        (None, None)])
def test_parse_dtype_int8(name, want):
    assert parse_dtype(name) is want


def pyramid_int8(model):
    """{module name: ``int8``} of every conv that has one set."""
    return {n: m.int8 for n, m in model.named_modules()
            if getattr(m, "int8", None) is not None}


@pytest.mark.parametrize("cfg", [UFLOW, PROB, COMPONENT, *PWCLITE],
                         ids=lambda c: c["type"])
def test_get_model_int8_over_the_six_types(cfg, monkeypatch):
    """The UFlow types build in bfloat16 with every pyramid conv (and only
    those) quantizing and the bfloat16 model's parameters; the PWC-Lite
    types refuse, as JAX's, while their pyramid convs are quantizable
    under the override."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    if cfg["type"].startswith("pwclite"):
        for factory in (lambda c: get_model(Config(c), device="cpu"),
                        lambda c: jax_get_model(JaxConfig(c))):
            with pytest.raises(NotImplementedError, match="has no int8 path"):
                factory(dict(cfg, dtype="int8"))
        flags = pyramid_int8(get_model(Config(cfg), device="cpu"))
        assert flags and set(flags.values()) == {False}
        assert all("feature_pyramid_extractor" in n for n in flags)
        return
    m8 = get_model(Config(dict(cfg, dtype="int8")), device="cpu")
    m16 = get_model(Config(dict(cfg, dtype="bfloat16")), device="cpu")
    flags = pyramid_int8(m8)
    n_pyramids = 2 if cfg["type"] == "component" else 1
    assert len(flags) == 15 * n_pyramids and set(flags.values()) == {True}
    assert all("_feature_pyramid_extractor" in n for n in flags)
    assert set(pyramid_int8(m16).values()) == {False}
    assert pyramid_int8(m16).keys() == flags.keys()
    assert {m.compute_dtype for m in m8.modules()
            if hasattr(m, "compute_dtype")} == {torch.bfloat16}
    sd8, sd16 = m8.state_dict(), m16.state_dict()
    assert sd8.keys() == sd16.keys()
    assert all(sd8[k].dtype == sd16[k].dtype for k in sd8)


@pytest.fixture(scope="module")
def pyramids():
    """An int8 and a bfloat16 UFlow pyramid with one set of weights, and a
    1x32x48 image."""
    m8 = get_model(Config(dict(UFLOW, dtype="int8")), device="cpu", seed=4)
    m16 = get_model(Config(dict(UFLOW, dtype="bfloat16")), device="cpu")
    m16.load_state_dict(m8.state_dict(), strict=True)
    img = torch.rand(1, 3, 32, 48, generator=torch.Generator().manual_seed(5))
    return m8, m16, img


def run_pyramid(model, img):
    with torch.no_grad():
        return model.feature_pyramid(img)


def test_env_override_both_ways(pyramids, monkeypatch):
    """``ARFLOW_INT8_PYRAMID=0`` runs an int8 model's pyramid as the
    bfloat16 one, ``=1`` a bfloat16 model's as the int8 one, bit for bit;
    read at each call. Convs outside a pyramid never quantize."""
    m8, m16, img = pyramids
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    q = run_pyramid(m8, img)
    exact = run_pyramid(m16, img)
    assert all(a.dtype == torch.bfloat16 and a.is_contiguous() for a in q)
    assert not all(torch.equal(a, b) for a, b in zip(q, exact))
    monkeypatch.setenv("ARFLOW_INT8_PYRAMID", "0")
    assert all(torch.equal(a, b) for a, b in zip(run_pyramid(m8, img), exact))
    monkeypatch.setenv("ARFLOW_INT8_PYRAMID", "1")
    assert all(torch.equal(a, b) for a, b in zip(run_pyramid(m16, img), q))
    dec = m16._flow_layers[1][0][0]
    x = torch.rand(1, dec.in_channels, 4, 6, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        y = dec(x)
        monkeypatch.delenv("ARFLOW_INT8_PYRAMID")
        assert torch.equal(y, dec(x))


def test_int8_attribute_is_per_instance(pyramids, monkeypatch):
    """An int8 model and an exact one in one process: the exact model's
    flows are the same bit for bit after the int8 model has run, and no
    process state changed."""
    import os

    m8, m16, _ = pyramids
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    g = torch.Generator().manual_seed(7)
    a, b = (torch.rand(1, 32, 64, 3, generator=g) for _ in range(2))
    with torch.no_grad():
        before = m16(a, b, with_bk=False)["flows_fw"]
        m8(a, b, with_bk=False)
        after = m16(a, b, with_bk=False)["flows_fw"]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert "ARFLOW_INT8_PYRAMID" not in os.environ


def _train_cfg(tmp_path, model):
    return Config({
        "model": model, "loss": {"type": "uflow", "smooth_order": 1},
        "trainer": "uflow", "seed": 0, "data": [], "save_root": str(tmp_path),
        "train": {"epoch_size": 1, "valid_size": 0, "batch_size": 1}})


def test_train_main_refuses_both_forms(tmp_path, monkeypatch):
    """``model.dtype: "int8"`` and ``ARFLOW_INT8_PYRAMID=1``: the pyramid
    would receive no training, so ``train_main`` refuses both before it
    reads data or writes anything, as JAX's (``tests/test_int8_conv.py``)."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    with pytest.raises(ValueError, match="serving-only"):
        cli.train_main(_train_cfg(tmp_path, dict(UFLOW, dtype="int8")), None,
                       device="cpu")
    monkeypatch.setenv("ARFLOW_INT8_PYRAMID", "1")
    with pytest.raises(ValueError, match="serving-only"):
        cli.train_main(_train_cfg(tmp_path, dict(UFLOW)), None, device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_jax_int8_params_convert_key_for_key(monkeypatch):
    """A JAX int8 model's parameter tree is the bfloat16 model's: it
    converts (``state_dict_from_jax``) to the same keys and values and
    loads strictly into the port's int8 model."""
    monkeypatch.delenv("ARFLOW_INT8_PYRAMID", raising=False)
    p8 = draw_jax_params(dict(UFLOW, dtype="int8"), with_bk=False)
    p16 = draw_jax_params(dict(UFLOW, dtype="bfloat16"), with_bk=False)
    assert (jax.tree_util.tree_structure(p8)
            == jax.tree_util.tree_structure(p16))
    sd8 = state_dict_from_jax(p8, Config(dict(UFLOW, dtype="int8")))
    sd16 = state_dict_from_jax(p16, Config(UFLOW))
    assert list(sd8) == list(sd16)
    assert all(torch.equal(sd8[k], sd16[k]) for k in sd8)
    model = get_model(Config(dict(UFLOW, dtype="int8")), device="cpu")
    model.load_state_dict(sd8, strict=True)
