"""Reading the JAX package's orbax checkpoint directories without JAX:
``load_orbax_checkpoint`` against ``arflow_tpu.training.checkpoint.
load_checkpoint_orbax`` leaf for leaf and bit for bit, on directories that
the JAX trainer's own ``save_model`` writes under ``checkpoint_backend:
orbax`` (its checkpoint and its best copy): a ``uflow`` model with the
optax chain of ``chairs_uflow.json`` (with weight decay, whose state is
empty) and the mixture config with ``batch_stats``.
``arflow-torch-to-torch -m <dir>`` against the same command on the
``.msgpack`` of the same state and against ``arflow-to-torch -m <dir>``;
``--resume`` and ``-m`` of a directory refuse, as in the JAX package."""

import importlib.util
import json
import logging
import os
import sys

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")
pytest.importorskip("orbax.checkpoint",
                    reason="the JAX package writes its directories with orbax")

import torch

import jax.numpy as jnp

from arflow_tpu.cli import to_torch_cli as jax_to_torch_cli
from arflow_tpu.config import Config as JaxConfig
from arflow_tpu.models import get_model as jax_get_model
from arflow_tpu.training.checkpoint import load_checkpoint_orbax
from arflow_tpu.training.optim import create_optimizer as jax_create_optimizer
from arflow_tpu.training.uflow_elbo_trainer import UFlowElboTrainer as JaxElboTrainer
from arflow_tpu.training.uflow_trainer import UFlowTrainer as JaxUFlowTrainer
from arflow_tpu_torch import Config
from arflow_tpu_torch.cli import to_torch_cli
from arflow_tpu_torch.models import load_pretrained
from arflow_tpu_torch.training.checkpoint import (
    load_checkpoint,
    load_jax_checkpoint,
    load_orbax_checkpoint,
)
from torch_mixture_util import MIXTURE, draw_variables
from torch_port_util import (  # noqa: F401  (fixture: few_torch_threads)
    CFG,
    H,
    W,
    draw_jax_params,
    few_torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_tensorstore = pytest.mark.skipif(
    importlib.util.find_spec("tensorstore") is None,
    reason="load_orbax_checkpoint reads with the tensorstore package")


def _train_section(name, **kw):
    with open(os.path.join(REPO, "configs", name)) as f:
        return dict(json.load(f)["train"], checkpoint_backend="orbax", **kw)


@pytest.fixture(scope="module", params=["uflow", "mixture_batch_stats"])
def saved(request, tmp_path_factory):
    """The JAX trainer's ``save_model`` of one state, as an orbax directory
    (and its best copy) and then as a ``.msgpack``: (model config, config
    file, save root)."""
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "uflow":
        model_cfg, cls = CFG, JaxUFlowTrainer
        train = _train_section("chairs_uflow.json", weight_decay=1e-4)
        variables = {"params": draw_jax_params(CFG, with_bk=False)}
    else:
        model_cfg, cls = MIXTURE, JaxElboTrainer
        train = _train_section("chairs_uflow_elbo_mixture.json")
        img = jnp.zeros((1, H, W, 3), jnp.float32)
        variables = draw_variables(jax_get_model(JaxConfig(MIXTURE)), (img, img),
                                   seed=11, with_bk=True)
    tr = cls([], None, jax_get_model(JaxConfig(model_cfg)), None,
             logging.getLogger("orbax"), str(root), JaxConfig(train),
             model_cfg=JaxConfig(model_cfg))
    params = variables["params"]
    tr.tx = jax_create_optimizer(JaxConfig(train), params, 1000)
    tr.state = {"params": params, "opt_state": tr.tx.init(params),
                "step": jnp.asarray(7, jnp.int32)}
    if "batch_stats" in variables:
        tr._has_batch_stats = True
        tr.state["batch_stats"] = variables["batch_stats"]
    tr.i_epoch, tr.i_iter = 3, 7
    tr.save_model(0.5, "Chairs")  # the best so far: a best copy too
    tr.cfg.checkpoint_backend = "msgpack"
    tr.save_model(0.5, "Chairs")
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": model_cfg}, f)
    return model_cfg, cfg_path, root


def _assert_same_tree(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _has_empty(tree) -> bool:
    return tree == {} or (isinstance(tree, dict)
                          and any(_has_empty(v) for v in tree.values()))


@needs_tensorstore
@pytest.mark.parametrize("name", ["Chairs_ckpt_orbax", "Chairs_model_best_orbax"])
def test_reader_equals_load_checkpoint_orbax(saved, name):
    model_cfg, _, root = saved
    path = str(root / name)
    want = load_checkpoint_orbax(path)
    modules = set(sys.modules)
    got = load_orbax_checkpoint(path)
    assert not [m for m in set(sys.modules) - modules
                if m.split(".")[0] in ("jax", "orbax", "flax")]
    _assert_same_tree(got, want)
    assert {"epoch", "i_iter", "best_error", "params", "opt_state",
            "step"} <= set(got)
    assert got["epoch"].shape == () and int(got["epoch"]) == 3
    assert int(got["step"]) == 7 and float(got["best_error"]) == 0.5
    assert _has_empty(got["opt_state"])  # optax's empty states
    assert ("batch_stats" in got) == (model_cfg is MIXTURE)


@needs_tensorstore
def test_to_torch_of_a_directory_equals_the_msgpack(saved, tmp_path):
    """The same ``state_dict`` and epoch, bit for bit, as from the
    ``.msgpack`` of the same state, and as ``arflow-to-torch`` writes from
    the directory."""
    _, cfg_path, root = saved
    outs = {}
    for key, src, cli in (("orbax", "Chairs_ckpt_orbax", to_torch_cli),
                          ("msgpack", "Chairs_ckpt.msgpack", to_torch_cli),
                          ("jax", "Chairs_ckpt_orbax", jax_to_torch_cli)):
        out = str(tmp_path / f"{key}.pth.tar")
        cli(["-c", cfg_path, "-m", str(root / src), "-o", out])
        outs[key] = torch.load(out, map_location="cpu", weights_only=True)
    want = outs["msgpack"]
    assert want["epoch"] == 3
    for key in ("orbax", "jax"):
        got = outs[key]
        assert got["epoch"] == want["epoch"], key
        assert sorted(got["state_dict"]) == sorted(want["state_dict"]), key
        for k, v in want["state_dict"].items():
            g = torch.as_tensor(got["state_dict"][k])
            assert g.dtype == v.dtype and torch.equal(g, v), (key, k)


def test_resume_and_m_of_a_directory_refuse(saved):
    """As in the JAX package, only ``to-torch`` reads a directory: a
    ``--resume`` (``load_checkpoint``) and ``-m`` (``load_pretrained``) of
    one raise, and say so."""
    model_cfg, _, root = saved
    path = str(root / "Chairs_ckpt_orbax")
    for read in (load_jax_checkpoint, load_checkpoint,
                 lambda p: load_pretrained(p, Config(model_cfg), device="cpu")):
        with pytest.raises(NotImplementedError, match="only in to-torch"):
            read(path)


def test_reader_names_tensorstore_when_absent(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        load_orbax_checkpoint(str(tmp_path))
