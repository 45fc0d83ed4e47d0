"""The port's PWCProbFlow for the four shipped approximations' layouts,
the weight converters and checkpoint loading against ``arflow_tpu`` at full
default widths on a 1x64x96 pair, in float64 with the JAX package's TPU
relayouts off. The int schemas, two pyramids and ComponentNet are in
``test_torch_uflow_prob_variants.py``: each file compiles its JAX models
anew, so they are kept apart to keep each file short.

One JAX forward per model, ``with_bk=True``: its forward outputs are also
what ``with_bk=False`` gives (the directions only share the batch axis), so
the port's forward is held to it both ways.
"""

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models.torch_export import (
    export_component_net,
    export_uflow_prob,
    save_torch_checkpoint,
)
from arflow_tpu_torch import Config
from arflow_tpu_torch.models import (
    PWCProbFlow,
    component_state_dict_from_jax,
    get_model,
    load_pretrained,
    uflow_prob_state_dict_from_jax,
)
from torch_port_util import H, W, draw_jax_params, few_torch_threads  # noqa: F401
from torch_prob_util import ATOL, check_channels, forward_gap, model_cfg


@pytest.mark.parametrize("case", ["diag", "nondiag", "nondiag_inv", "lowrank"])
def test_pwcprobflow_matches_jax_f64_gates_off(case, monkeypatch):
    gap, model, flows = forward_gap(case, uflow_prob_state_dict_from_jax, 0,
                                    monkeypatch)
    assert gap < ATOL
    check_channels(model, flows)


@pytest.mark.parametrize("case", ["nondiag", "two_pyramids", "component"])
def test_state_dicts_equal_jax_export(case):
    cfg = model_cfg(case)
    if case == "component":
        convert, export, count = (component_state_dict_from_jax,
                                  export_component_net, 204)
    else:
        convert, export = uflow_prob_state_dict_from_jax, export_uflow_prob
        count = 102 + 30 * (cfg.get("n_pyramids", 1) - 1)
    params = draw_jax_params(cfg, seed=3, with_bk=True)
    ours = convert(params)
    ref = export(params)
    assert len(ours) == len(ref) == count
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # as JAX checkpoints hold them too: {'params': ...}
    assert sorted(convert({"params": params})) == sorted(ref)
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert sorted(model.state_dict()) == sorted(ref)


@pytest.mark.parametrize("case", ["nondiag_inv", "component"])
def test_load_pretrained_strict_round_trip(case, tmp_path):
    """A ``.pth.tar`` as ``arflow-to-torch`` writes it loads strictly."""
    cfg = model_cfg(case)
    params = draw_jax_params(cfg, seed=5, with_bk=True)
    path = str(tmp_path / "prob.pth.tar")
    save_torch_checkpoint(path, params, JaxConfig(cfg), epoch=2)
    model = load_pretrained(path, Config(cfg), device="cpu")
    convert = (component_state_dict_from_jax if case == "component"
               else uflow_prob_state_dict_from_jax)
    expected = convert(params)
    got = model.state_dict()
    assert sorted(got) == sorted(expected)
    for k, v in expected.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_mixture_weights_and_training_refused():
    """``mixture_weights`` reads both directions, so ``with_bk=False``
    raises and says so; training with level dropout needs a generator to
    draw from."""
    model = get_model(Config({"type": "component", "out_channels": [2, 2, 0],
                              "mixture_weights": True}), device="cpu")
    img = torch.zeros((1, H, W, 3))
    with pytest.raises(ValueError, match="mixture_weights needs with_bk=True"):
        model(img, img, with_bk=False)
    model = get_model(Config(dict(model_cfg("diag"), level_dropout=0.5)),
                      device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        model(img, img, train=True)


def test_every_shipped_prob_config_builds():
    """Each shipped ``uflow_prob`` config's model section builds, with
    ``mixture_weights`` (chairs_uflow_elbo_mixture.json) its weights net."""
    import glob
    import os

    from arflow_tpu_torch import load_config

    built, with_weights_net = [], []
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in sorted(glob.glob(os.path.join(repo, "configs", "*.json"))):
        cfg = load_config(path)
        if cfg.model.type != "uflow_prob":
            continue
        model = get_model(cfg.model, device="cpu")
        assert isinstance(model, PWCProbFlow)
        built.append(os.path.basename(path))
        if cfg.model.get("mixture_weights"):
            assert model._mixture_weights_net.k == 2
            with_weights_net.append(built[-1])
    assert with_weights_net == ["chairs_uflow_elbo_mixture.json"]
    assert len(built) == 12
