"""Package-level rules of the port: it imports no JAX and nothing of
``arflow_tpu`` (nor PIL or cv2 at import), its entry points default to the
CUDA device and raise without one instead of running on the CPU, and what
it does not port yet raises and names the roadmap item."""

import contextlib
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.serving import StreamingFlowEngine
from arflow_tpu_torch.training import get_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two torch threads: the test lane runs several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
CFG = {"type": "uflow", "feature_norm": True}

_CHECK = r"""
import importlib, importlib.util, pkgutil, sys
import arflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(arflow_tpu_torch.__path__,
                                                "arflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "arflow_tpu",
                                    "PIL", "cv2"))
print(" ".join(names), "|", bad)
"""

# The entry points, the host-side pipeline, the probabilistic path, its
# ELBO and MSE training, the export, stream and penalty tools, the native
# library's loader, the augmentation on the card, the flow images and the
# host allocator, which no earlier module imported: they must be among the
# modules checked.
ENTRY_AND_DATA = [
    "arflow_tpu_torch.cli", "arflow_tpu_torch.data",
    "arflow_tpu_torch.data.datasets", "arflow_tpu_torch.data.get_dataset",
    "arflow_tpu_torch.data.loader", "arflow_tpu_torch.data.transforms",
    "arflow_tpu_torch.training.checkpoint", "arflow_tpu_torch.utils.flow_io",
    "arflow_tpu_torch.utils.logger", "arflow_tpu_torch.utils.summary",
    "arflow_tpu_torch.models.uflow_prob", "arflow_tpu_torch.ops.triag",
    "arflow_tpu_torch.training.entropy", "arflow_tpu_torch.utils.gmm",
    "arflow_tpu_torch.utils.metrics", "arflow_tpu_torch.losses.blocks",
    "arflow_tpu_torch.losses.uflow_elbo", "arflow_tpu_torch.ops.penalties",
    "arflow_tpu_torch.training.uflow_elbo_trainer",
    "arflow_tpu_torch.losses.mse", "arflow_tpu_torch.training.mse_trainer",
    "arflow_tpu_torch.serving.export", "arflow_tpu_torch.serving.engine",
    "arflow_tpu_torch.tools", "arflow_tpu_torch.tools.penalty_em",
    "arflow_tpu_torch.models.pwclite", "arflow_tpu_torch.models.pwclite_prob",
    "arflow_tpu_torch.models.pwclite_uflow",
    "arflow_tpu_torch.native", "arflow_tpu_torch.data.device_aug",
    "arflow_tpu_torch.utils.viz", "arflow_tpu_torch.utils.hostmem",
]


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().split(" | ", 1)
    names = names.split()
    assert len(names) >= 40  # every module of the package was imported
    assert set(ENTRY_AND_DATA) <= set(names)
    assert bad == "[]", bad


@pytest.mark.parametrize("model_cfg", [
    CFG, {"type": "pwclite", "n_frames": 2}, {"type": "pwclite", "n_frames": 3},
    {"type": "pwclite_prob", "n_frames": 2},
    {"type": "pwclite_uflow", "n_frames": 2}])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path, model_cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        get_model(cfg)
    sd = get_model(cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingFlowEngine(cfg, sd)
    path = str(tmp_path / "w.pth.tar")
    torch.save({"epoch": 0, "state_dict": sd}, path)
    from arflow_tpu_torch.models import load_pretrained

    with pytest.raises(RuntimeError, match="cuda"):
        load_pretrained(path, cfg)


# The PWC-Lite family is ported; int8 is not, for any model type (the
# PWC-Lite types have no int8 path in the JAX package either).
@pytest.mark.parametrize("model_cfg", [
    {"type": "pwclite", "n_frames": 2, "dtype": "int8"},
    {"type": "pwclite_prob", "n_frames": 2, "dtype": "int8"},
    {"type": "uflow", "dtype": "int8"},
])
def test_unported_configs_raise_and_name_the_roadmap(model_cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(Config(model_cfg), device="cpu")


TRAIN = {"batch_size": 1, "epoch_num": 1, "epoch_size": 1000,
         "valid_size": 0, "valid_freq": 1, "optim": "adam", "lr": 1e-4,
         "lr_decay_start_epoch": 300, "lr_decay_factor": 0.98,
         "print_freq": 100, "record_freq": 100, "save_iter": 10**9,
         "seed": 0}
LOSS = {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0, "smooth_order": 1,
        "edge_constant": 150.0, "with_bk": True}


def _batch(flow=False):
    rs = np.random.RandomState(0)
    b = {"img1": rs.rand(1, 64, 64, 3).astype(np.float32),
         "img2": rs.rand(1, 64, 64, 3).astype(np.float32)}
    if flow:
        b["target"] = {"flow": np.zeros((1, 64, 64, 2), np.float32)}
    return b


@pytest.mark.parametrize("case", [
    "remat", "nan_revert", "resume", "mesh", "stage1", "adamw",
    "device_photometric_aug", "checkpoint_save", "loss_uflow_elbo",
    "trainer_uflow_elbo",
])
def test_training_forward_raises_and_names_the_roadmap(case, tmp_path):
    """Training runs (``train=True`` and the ``uflow`` trainer); each
    feature of the JAX trainer that the port does not have yet raises where
    it would take effect and names its ``ROADMAP.md`` item, instead of
    being skipped: resuming from the JAX package's msgpack checkpoint among
    them. Its orbax checkpoints stay with it, and saving one raises. The
    switches ported since (``remat``, ``nan_revert``, ``stage1``) train
    and take effect (``test_torch_train_switches.py`` holds them), and so
    do ``optim: adamw`` (``test_torch_adamw.py``) and the uflow trainer's
    ``photometric_aug.device`` (``test_torch_device_aug_train.py``); the
    ELBO trainer refuses the latter and names the roadmap."""
    train = dict(TRAIN)
    full = {"model": CFG, "loss": LOSS}
    kwargs, valid = {}, None
    if case in ("remat", "nan_revert"):
        train[case] = True
    elif case == "resume":
        train["resume"] = "ckpt.msgpack"
    elif case == "mesh":
        kwargs["mesh"] = object()
    elif case == "stage1":
        full["stage1"] = {"epoch": 0, "loss": {"w_smooth": 0.0}}
    elif case == "adamw":
        train["optim"] = "adamw"
    elif case == "device_photometric_aug":
        full["data"] = [{"type": "train",
                         "photometric_aug": {"hue": 0.5, "device": True}}]
    elif case == "checkpoint_save":
        train["save_iter"] = 0  # due after the first step's validation
        train["checkpoint_backend"] = "orbax"
        valid = [[_batch(flow=True)]]
    full["train"] = train
    full = Config(full)
    error, match = ((ValueError, "JAX package") if case == "checkpoint_save"
                    else (NotImplementedError, "ROADMAP.md"))
    trainer_name = "uflow"
    if case == "trainer_uflow_elbo":  # the ELBO trainer refuses it too
        trainer_name = "uflow_elbo"
        full["data"] = [{"type": "train",
                         "photometric_aug": {"hue": 0.5, "device": True}}]
    ported = case in ("remat", "nan_revert", "stage1", "adamw",
                      "device_photometric_aug")
    with (contextlib.nullcontext() if ported
          else pytest.raises(error, match=match)):
        if case == "loss_uflow_elbo":  # the opt-in Taylor warp
            get_loss(Config({"type": "uflow_elbo", "taylor_warp": True}))
        model = get_model(full.model, device="cpu")
        trainer = get_trainer(trainer_name)(
            [_batch()], valid, model, get_loss(full.loss),
            logging.getLogger("test"), str(tmp_path), full.train,
            model_cfg=full.model, full_cfg=full, **kwargs)
        trainer.train()
    if ported:
        assert trainer.i_iter == 1 and trainer.nan_skips == 0
        assert trainer.loss_func.cfg.w_smooth == (0.0 if case == "stage1"
                                                  else 4.0)
