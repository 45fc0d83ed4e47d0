"""The port's ``MixtureWeightsNet`` and its BatchNorm ResNet against
``arflow_tpu``'s in float64 with the TPU relayouts off: outputs and input
gradients in training mode, the running statistics flax's ``batch_stats``
hold after the update (the biased batch variance, momentum 0.9), and the
outputs in eval mode; then ``PWCProbFlow`` with ``mixture_weights`` and two
pyramids (chairs_uflow_elbo_mixture.json's model) and ``ComponentNet`` with
``mixture_weights``, the weight converters against the JAX export, and the
``with_bk=False`` refusal of both packages.

Small batch statistics are the case that matters: at the ELBO crop the
ResNet's last stage sees 2x4 pixels per image, where torch's own
``BatchNorm2d`` would store a running variance n/(n-1) larger.
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

import jax
import jax.numpy as jnp

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.models.torch_export import (
    export_component_net,
    export_uflow_prob,
    save_torch_checkpoint,
)
from arflow_tpu.models.uflow_prob import MixtureWeightsNet as JaxMixtureWeightsNet
from arflow_tpu.models.uflow_prob import ResNet as JaxResNet
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import (
    ComponentNet,
    MixtureWeightsNet,
    PWCProbFlow,
    ResNet,
    component_state_dict_from_jax,
    get_model,
    load_pretrained,
    uflow_prob_state_dict_from_jax,
)
from arflow_tpu_torch.models.weights import _resnet_from_jax
from torch_mixture_util import (
    COMPONENT_MIXTURE,
    MIXTURE,
    as_f64,
    draw_variables,
    image_pair,
    stats_gap,
)
from torch_port_util import H, W, few_torch_threads  # noqa: F401
from torch_prob_util import GATES_OFF

# float64 on both sides, the same arithmetic in other orders (flax's
# variance is E[x^2] - E[x]^2, the port's two-pass). BatchNorms over few
# values per channel amplify the rounding: at b2 the ResNet's last stage
# normalizes 2 pixels per channel. Measured with these seeds: the ResNet's
# outputs 9.6e-11 in training mode and 5.4e-14 in eval mode, its input
# gradient 1.4e-10 of the largest element, its statistics 4.3e-13
# relative; the weights net's weights 2.0e-11, its statistics 1.4e-12;
# the full models' flows 5.1e-14, statistics 8.7e-12 and weights 3.6e-10.
ATOL, TRAIN_ATOL, STATS_RTOL, GRAD_RTOL, WEIGHTS_ATOL = 1e-10, 1e-9, 1e-10, 1e-9, 1e-8

@pytest.fixture(autouse=True)
def gates_off(monkeypatch):
    for k, v in GATES_OFF.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ARFLOW_TAYLOR_WARP", "0")


def _resnet_port(variables, cin, k):
    sd = {}
    _resnet_from_jax(sd, variables["params"], variables["batch_stats"], "r")
    net = ResNet(cin, k)
    net.load_state_dict({key[2:]: torch.from_numpy(v) for key, v in sd.items()},
                        strict=True)
    return net.double()


def test_resnet_train_step_and_eval_match_flax():
    """b2 at 16x24 (the ELBO crop's level 2 is 64x112): the last stage
    normalizes over 2 pixels per channel."""
    k = 2
    x = np.random.RandomState(0).randn(2, 16, 24, 8 * k) * 1.5 + 0.3
    jnet = JaxResNet(num_classes=k)
    variables = draw_variables(jnet, (jnp.zeros(x.shape, jnp.float32),), seed=1)
    r = np.random.RandomState(2).randn(2, k)

    def train(v, xx):
        y, upd = jnet.apply(v, xx, train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    v64 = as_f64(variables)
    (y_j, stats_j), vjp = jax.vjp(lambda xx: train(v64, xx), jnp.asarray(x))
    (gx_j,) = vjp((jnp.asarray(r), jax.tree_util.tree_map(jnp.zeros_like, stats_j)))
    y_eval_j = jnet.apply({"params": v64["params"], "batch_stats": stats_j},
                          jnp.asarray(x), train=False)

    net = _resnet_port(variables, 8 * k, k)
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    y_t = net(xt, train=True)
    (y_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=0,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(gx_j)).max())
    assert stats_gap(net, stats_j, "") < STATS_RTOL
    with torch.no_grad():
        y_eval = net(xt, train=False)
    np.testing.assert_allclose(y_eval.numpy(), np.asarray(y_eval_j), rtol=0,
                               atol=ATOL)
    # eval mode neither reads nor moves the batch's statistics
    assert stats_gap(net, stats_j, "") < STATS_RTOL
    assert not np.allclose(np.asarray(y_eval_j), np.asarray(y_j))


def test_mixture_weights_net_fw_then_bw_matches_flax():
    """n_flows 1, two pyramids (K = 2) at b2: the weights of (fw, bw, img1,
    img2), then of (bw, fw, img2, img1) after the first call's update; the
    running statistics after both; the weights in eval mode."""
    b, h, w = 2, H // 4, W // 4
    rs = np.random.RandomState(3)
    f12, f21 = (2.5 * rs.randn(b, h, w, 4) for _ in range(2))
    im1, im2 = image_pair(b, seed=4)
    jnet = JaxMixtureWeightsNet(n_flows=1, n_pyramids=2)
    variables = draw_variables(jnet, tuple(jnp.zeros(a.shape, jnp.float32)
                                           for a in (f12, f21, im1, im2)), seed=5)

    @jax.jit
    def both(v, a, bb, i1, i2):
        w12, upd = jnet.apply(v, a, bb, i1, i2, train=True, mutable=["batch_stats"])
        v = {"params": v["params"], **upd}
        w21, upd = jnet.apply(v, bb, a, i2, i1, train=True, mutable=["batch_stats"])
        v = {"params": v["params"], **upd}
        return w12, w21, upd["batch_stats"], jnet.apply(v, a, bb, i1, i2)

    w12_j, w21_j, stats_j, w_eval_j = both(as_f64(variables), *(jnp.asarray(a) for a in
                                                            (f12, f21, im1, im2)))
    sd = {}
    _resnet_from_jax(sd, variables["params"]["resnet"],
                     variables["batch_stats"]["resnet"], "resnet")
    net = MixtureWeightsNet(1, 2)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    net = net.double()
    t = [torch.from_numpy(a) for a in (f12, f21, im1, im2)]
    w12 = net(t[0], t[1], t[2], t[3], train=True)
    w21 = net(t[1], t[0], t[3], t[2], train=True)
    for got, want in ((w12, w12_j), (w21, w21_j)):
        want = np.asarray(want)
        assert want.shape == (b, 2)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=WEIGHTS_ATOL)
        np.testing.assert_allclose(want.sum(-1), 1.0)
    assert stats_gap(net.resnet, stats_j["resnet"], "") < STATS_RTOL
    with torch.no_grad():
        np.testing.assert_allclose(net(*t).numpy(), np.asarray(w_eval_j),
                                   rtol=0, atol=ATOL)


def _model_case(cfg, seed, b=2):
    """JAX variables of ``cfg`` and the port's model with them (float64),
    and a seeded b x 64x96 pair."""
    jmodel = jax_get_model(JaxConfig(cfg))
    im1, im2 = image_pair(b, seed=seed + 1)
    img = jnp.zeros(im1.shape, jnp.float32)
    variables = draw_variables(jmodel, (img, img), seed=seed, with_bk=True)
    convert = (component_state_dict_from_jax if cfg["type"] == "component"
               else uflow_prob_state_dict_from_jax)
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(convert(variables), strict=True)
    return jmodel, variables, model.double(), im1, im2


@pytest.mark.parametrize("cfg", [MIXTURE, COMPONENT_MIXTURE],
                         ids=["pwcprobflow_two_pyramids", "component"])
def test_models_with_mixture_weights_match_jax(cfg):
    """One forward in training mode (dropout off), then one in eval mode:
    every flow, both weights and the ResNet's running statistics."""
    jmodel, variables, model, im1, im2 = _model_case(cfg, seed=6)

    @jax.jit
    def run(v, a, b):
        res, upd = jmodel.apply(v, a, b, with_bk=True, train=True,
                                mutable=["batch_stats"])
        ev = jmodel.apply({"params": v["params"], **upd}, a, b, with_bk=True)
        return res, upd["batch_stats"], ev

    res_j, stats_j, eval_j = run(as_f64(variables), jnp.asarray(im1), jnp.asarray(im2))
    a, b = torch.from_numpy(im1), torch.from_numpy(im2)
    res_t = model(a, b, with_bk=True, train=True)
    with torch.no_grad():
        eval_t = model(a, b, with_bk=True)
    k = 2 if cfg["type"] == "uflow_prob" else 1
    gaps = {"flows": 0.0, "weights": 0.0}
    for got, want in ((res_t, res_j), (eval_t, eval_j)):
        assert sorted(got) == sorted(want) == ["flows_bw", "flows_fw",
                                               "weights_bw", "weights_fw"]
        for key in ("flows_fw", "flows_bw"):
            for ft, fj in zip(got[key], want[key]):
                gaps["flows"] = max(gaps["flows"], float(np.abs(
                    ft.detach().numpy() - np.asarray(fj)).max()))
        for key in ("weights_fw", "weights_bw"):
            assert tuple(got[key].shape) == (2, k)
            gaps["weights"] = max(gaps["weights"], float(np.abs(
                got[key].detach().numpy() - np.asarray(want[key])).max()))
    assert gaps["flows"] < ATOL and gaps["weights"] < WEIGHTS_ATOL, gaps
    net = (model._mixture_weights_net if isinstance(model, PWCProbFlow)
           else model.mixture_weights_net)
    assert stats_gap(net.resnet, stats_j["mixture_weights_net"]["resnet"],
                     "") < STATS_RTOL


@pytest.mark.parametrize("cfg", [MIXTURE, COMPONENT_MIXTURE],
                         ids=["pwcprobflow_two_pyramids", "component"])
def test_converters_equal_jax_export_with_batch_stats(cfg, tmp_path):
    """Key for key and bit for bit, BatchNorm buffers and the int64
    ``num_batches_tracked`` included; ``load_pretrained`` reads the
    ``.pth.tar`` the JAX package writes, strictly."""
    jmodel = jax_get_model(JaxConfig(cfg))
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = draw_variables(jmodel, (img, img), seed=7, with_bk=True)
    component = cfg["type"] == "component"
    convert, export = ((component_state_dict_from_jax, export_component_net)
                       if component else
                       (uflow_prob_state_dict_from_jax, export_uflow_prob))
    ours, ref = convert(variables), export(variables)
    prefix = "mixture_weights_net.resnet." if component else "_mixture_weights_net.resnet."
    resnet_keys = [key for key in ref if key.startswith(prefix)]
    # 20 conv weights, 3 downsample biases, 20 BatchNorms of 5 entries, fc's 2
    assert len(resnet_keys) == 20 + 3 + 20 * 5 + 2
    assert sorted(ours) == sorted(ref)
    for key, v in ref.items():
        assert ours[key].dtype == (torch.int64 if key.endswith("num_batches_tracked")
                                   else torch.float32), key
        np.testing.assert_array_equal(ours[key].numpy(), v, err_msg=key)
    model = get_model(Config(cfg), device="cpu")
    assert isinstance(model, ComponentNet if component else PWCProbFlow)
    assert sorted(model.state_dict()) == sorted(ref)
    path = str(tmp_path / "mixture.pth.tar")
    save_torch_checkpoint(path, variables, JaxConfig(cfg), epoch=1)
    loaded = load_pretrained(path, Config(cfg), device="cpu")
    for key, v in loaded.state_dict().items():
        torch.testing.assert_close(v, ours[key], rtol=0, atol=0, msg=key)


def test_mixture_weights_refuse_with_bk_false_in_both_packages():
    """Both directions feed the weights net: the JAX model fails on the
    missing ``flows_bw`` (a ``KeyError``), the port says why."""
    jmodel, variables, model, im1, im2 = _model_case(MIXTURE, seed=8, b=1)
    img = jax.ShapeDtypeStruct(im1.shape, jnp.float32)
    with pytest.raises(KeyError, match="flows_bw"):  # raised while tracing
        jax.eval_shape(lambda a, b: jmodel.apply(variables, a, b, with_bk=False),
                       img, img)
    a, b = torch.from_numpy(im1), torch.from_numpy(im2)
    with pytest.raises(ValueError, match="mixture_weights needs with_bk=True"):
        model(a, b, with_bk=False)
    comp = get_model(Config(COMPONENT_MIXTURE), device="cpu").double()
    with pytest.raises(ValueError, match="mixture_weights needs with_bk=True"):
        comp(a, b, with_bk=False)
