"""Reading the JAX package's msgpack checkpoints without flax:
``load_jax_checkpoint`` against ``flax.serialization.msgpack_restore`` on
files the JAX ``save_checkpoint`` writes (``uflow``, ``uflow_prob`` with
``batch_stats``, ``component``), ``arflow-torch-to-torch`` against
``arflow-to-torch`` key for key and bit for bit, ``load_pretrained`` and
``arflow-torch-inference -m`` on a ``.msgpack``."""

import json

import pytest

pytest.importorskip("flax", reason="the JAX checkpoints are written with flax")

import flax.serialization
import jax.numpy as jnp
import numpy as np
import torch

from arflow_tpu.cli import to_torch_cli as jax_to_torch_cli
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.training.checkpoint import save_checkpoint
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import to_torch_cli
from arflow_tpu_torch.models import load_pretrained, state_dict_from_jax
from arflow_tpu_torch.training.checkpoint import load_checkpoint, load_jax_checkpoint
from torch_mixture_util import MIXTURE, draw_variables
from torch_port_util import (  # noqa: F401  (fixture: few_torch_threads)
    CFG,
    H,
    W,
    draw_jax_params,
    few_torch_threads,
)

COMPONENT = {"type": "component", "out_channels": [2, 2, 0]}
CASES = ["uflow", "uflow_prob_batch_stats", "component"]


def _state(case):
    """(model config, the checkpoint tree the JAX trainer saves)."""
    if case == "uflow":
        return CFG, {"epoch": 3, "params": draw_jax_params(CFG, with_bk=False)}
    cfg = MIXTURE if case == "uflow_prob_batch_stats" else COMPONENT
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = draw_variables(jax_get_model(JaxConfig(cfg)), (img, img),
                               seed=11, with_bk=True)
    state = {"epoch": 7, "params": variables["params"]}
    if "batch_stats" in variables:
        state["batch_stats"] = variables["batch_stats"]
    # An optimizer state's scalar and a Python value, as the trainer saves.
    state["opt_state"] = {"count": np.int32(5), "lr": 1e-4}
    return cfg, state


@pytest.fixture(scope="module", params=CASES)
def jax_ckpt(request, tmp_path_factory):
    cfg, state = _state(request.param)
    root = tmp_path_factory.mktemp(request.param)
    path = save_checkpoint(str(root), state, "model")
    return request.param, cfg, path, root


def _assert_trees_equal(ours, theirs, where="root"):
    assert type(ours) is type(theirs) or (
        isinstance(ours, np.generic) and isinstance(theirs, np.generic)), where
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), where
        for k in theirs:
            _assert_trees_equal(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(theirs, np.ndarray):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, where
        np.testing.assert_array_equal(ours, theirs, err_msg=where)
    else:
        assert ours == theirs, where


def test_load_jax_checkpoint_matches_flax(jax_ckpt):
    _, _, path, _ = jax_ckpt
    with open(path, "rb") as f:
        theirs = flax.serialization.msgpack_restore(f.read())
    _assert_trees_equal(load_jax_checkpoint(path), theirs)


def test_to_torch_cli_matches_jax_key_for_key(jax_ckpt):
    case, cfg, path, root = jax_ckpt
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps({"model": cfg}))
    ours, theirs = str(root / "port.pth.tar"), str(root / "jax.pth.tar")
    to_torch_cli(["-c", str(cfg_path), "-m", path, "-o", ours])
    jax_to_torch_cli(["-c", str(cfg_path), "-m", path, "-o", theirs])
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert a["epoch"] == b["epoch"] == (3 if case == "uflow" else 7)
    assert list(a["state_dict"]) == list(b["state_dict"])
    for key, want in b["state_dict"].items():
        got = a["state_dict"][key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got, want), key
    # What load_pretrained reads, strictly.
    model = load_pretrained(ours, Config(cfg), device="cpu")
    assert len(model.state_dict()) == len(a["state_dict"])


def test_load_pretrained_reads_a_msgpack(jax_ckpt):
    _, cfg, path, _ = jax_ckpt
    model = load_pretrained(path, Config(cfg), device="cpu")
    want = state_dict_from_jax(load_jax_checkpoint(path), Config(cfg))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_refusals(tmp_path):
    """An orbax directory and a resume from a msgpack (its Adam moments)
    raise, naming the roadmap; a model type neither package builds raises
    (the PWC-Lite types convert: tests/test_torch_pwclite_weights.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_jax_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_checkpoint(str(tmp_path / "model_ckpt.msgpack"))
    with pytest.raises(NotImplementedError, match="flownet_prob"):
        state_dict_from_jax({"params": {}}, Config({"type": "flownet_prob"}))


def test_inference_cli_takes_a_msgpack(tmp_path, monkeypatch):
    """``arflow-torch-inference -m`` on a JAX ``.msgpack`` writes the same
    ``.flo`` as with the converted ``.pth.tar``."""
    from torch_data_util import make_chairs_dir

    from arflow_tpu_torch.cli import inference_cli

    params = draw_jax_params(CFG, with_bk=False)
    ckpt = save_checkpoint(str(tmp_path), {"epoch": 1, "params": params}, "m")
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(0), 20,
                           H, W)  # fids 6 and 18 are the valid split
    outs = {}
    for name, model in (("msgpack", ckpt), ("pth", None)):
        if model is None:
            model = str(tmp_path / "m.pth.tar")
            to_torch_cli(["-c", str(tmp_path / "cfg.json"), "-m", ckpt,
                          "-o", model])
        cfg = {"model": CFG, "loss": {},
               "data": [{"name": "Chairs", "type": "valid", "n_frames": 2,
                         "split": "valid",
                         "root_chairs": str(root),
                         "out_root": str(tmp_path / name)}],
               "inference": {"pretrained_model": "unused", "workers": 1}}
        (tmp_path / "cfg.json").write_text(json.dumps(cfg))
        monkeypatch.chdir(tmp_path)
        written = inference_cli(["-c", str(tmp_path / "cfg.json"), "-m", model,
                                 "--device", "cpu"])
        outs[name] = [open(p, "rb").read() for p in written]
    assert len(outs["msgpack"]) == 2
    assert outs["msgpack"] == outs["pth"]
