"""The PWC-Lite family's weights between the packages: the port's
converters against ``arflow_tpu.models.torch_export.export_pwclite`` and
``export_pwclite_uflow`` key for key and bit for bit, the JAX importer's
round trip of the port's ``state_dict``, ``load_pretrained`` of a
reference-format ``.pth.tar`` and of a JAX ``.msgpack``, and
``arflow-torch-to-torch`` against ``arflow-to-torch``. No JAX compile:
the parameter trees come from ``jax.eval_shape``."""

import json

import pytest

pytest.importorskip("flax", reason="the JAX checkpoints are written with flax")

import numpy as np
import torch

from arflow_tpu.cli import to_torch_cli as jax_to_torch_cli
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import torch_import
from arflow_tpu.models.torch_export import (
    export_pwclite,
    export_pwclite_uflow,
    save_torch_checkpoint,
)
from arflow_tpu.training.checkpoint import save_checkpoint
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import to_torch_cli
from arflow_tpu_torch.models import (
    get_model,
    load_pretrained,
    pwclite_state_dict_from_jax,
    pwclite_uflow_state_dict_from_jax,
    state_dict_from_jax,
)
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)
from torch_pwclite_util import draw_params

# (model config, the JAX exporter, the port's converter, state_dict entries)
CASES = {
    "pwclite": ({"type": "pwclite", "n_frames": 2}, export_pwclite,
                pwclite_state_dict_from_jax, 60),
    "pwclite_dense_3frame": (
        {"type": "pwclite", "n_frames": 3, "reduce_dense": False},
        export_pwclite, pwclite_state_dict_from_jax, 60),
    "pwclite_prob": ({"type": "pwclite_prob", "n_frames": 2}, export_pwclite,
                     pwclite_state_dict_from_jax, 60),
    "pwclite_uflow": ({"type": "pwclite_uflow", "n_frames": 2},
                      export_pwclite_uflow, pwclite_uflow_state_dict_from_jax,
                      98),
    "pwclite_uflow_dense": (
        {"type": "pwclite_uflow", "n_frames": 2, "reduce_dense": False},
        export_pwclite_uflow, pwclite_uflow_state_dict_from_jax, 98),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg, export, convert, n = CASES[request.param]
    return cfg, export, convert, n, draw_params(cfg, seed=3)


def test_converter_equals_jax_export_key_for_key(case):
    cfg, export, convert, n, params = case
    ours, ref = convert(params), export(params)
    assert len(ours) == len(ref) == n
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        assert ours[key].dtype == torch.float32
        np.testing.assert_array_equal(ours[key].numpy(), want, err_msg=key)
    # by type, and into the port's model strictly: its keys are the
    # reference's and its shapes the JAX tree's
    assert sorted(state_dict_from_jax({"params": params}, Config(cfg))) == \
        sorted(ref)
    model = get_model(Config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    for key, value in model.state_dict().items():
        assert tuple(value.shape) == ref[key].shape, key


def test_jax_importer_round_trips_the_port_state_dict(case):
    """What the port saves, the JAX package's importer reads back into the
    same parameter tree, bit for bit."""
    cfg, _, convert, _, params = case
    sd = get_model(Config(cfg), device="cpu", seed=2).state_dict()
    reduce_dense = cfg.get("reduce_dense", True)
    tree = (torch_import.import_pwclite_uflow(sd, reduce_dense)
            if cfg["type"] == "pwclite_uflow"
            else torch_import.import_pwclite(sd, reduce_dense))
    back = convert(tree)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


def test_load_pretrained_pth_and_msgpack(case, tmp_path):
    cfg, _, convert, _, params = case
    want = convert(params)
    pth = save_torch_checkpoint(str(tmp_path / "m.pth.tar"), params,
                                JaxConfig(cfg), epoch=4)
    msgpack = save_checkpoint(str(tmp_path), {"epoch": 4, "params": params},
                              "model")
    for path in (pth, msgpack):
        got = load_pretrained(path, Config(cfg), device="cpu").state_dict()
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert torch.equal(got[key], value), (path, key)


def test_to_torch_cli_matches_jax(tmp_path):
    cfg = {"type": "pwclite", "n_frames": 2}
    params = draw_params(cfg, seed=9)
    path = save_checkpoint(str(tmp_path), {"epoch": 2, "params": params},
                           "model")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": cfg}))
    ours, theirs = str(tmp_path / "port.pth.tar"), str(tmp_path / "jax.pth.tar")
    to_torch_cli(["-c", str(cfg_path), "-m", path, "-o", ours])
    jax_to_torch_cli(["-c", str(cfg_path), "-m", path, "-o", theirs])
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    assert list(a["state_dict"]) == list(b["state_dict"])
    for key, want in b["state_dict"].items():
        assert torch.equal(a["state_dict"][key], want), key
    model = load_pretrained(ours, Config(cfg), device="cpu")
    assert len(model.state_dict()) == 60


@pytest.mark.parametrize("kind,n_frames", [
    ("pwclite", 2), ("pwclite", 3), ("pwclite_prob", 2), ("pwclite_uflow", 2)])
def test_init_is_kaiming_normal_from_the_seed(kind, n_frames):
    """``get_model(seed=)``: every conv's weight normal with variance
    2 / fan_in, every transposed conv's xavier-uniform, zero biases; the
    same seed, the same weights."""
    cfg = Config({"type": kind, "n_frames": n_frames})
    a = get_model(cfg, device="cpu", seed=5)
    b = get_model(cfg, device="cpu", seed=5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for m in a.modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            # (I, O, k, k): fan_in O*k*k, fan_out I*k*k
            k2 = m.weight[0, 0].numel()
            limit = np.sqrt(6.0 / (k2 * (m.in_channels + m.out_channels)))
            assert float(m.weight.detach().abs().max()) <= limit
        elif isinstance(m, torch.nn.Conv2d):
            std = np.sqrt(2.0 / m.weight[0].numel())
            if m.weight.numel() >= 2000:
                assert abs(float(m.weight.detach().std()) / std - 1) < 0.1
        else:
            continue
        assert not m.bias.any()
