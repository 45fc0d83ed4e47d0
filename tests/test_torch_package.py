"""Package-level rules of the port: it imports no JAX and nothing of
``arflow_tpu``, and its entry points default to the CUDA device and raise
without one instead of running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models.uflow import PWCFlow
from arflow_tpu_torch.serving import StreamingFlowEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "arflow_tpu"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15  # every module of the package was imported
    assert bad == "[]", bad


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(CFG)
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


@pytest.mark.parametrize("model_cfg", [
    {"type": "pwclite", "n_frames": 2},
    {"type": "uflow_prob", "out_channels": [2, 2, 0]},
    {"type": "uflow", "dtype": "bfloat16"},
])
def test_unported_configs_raise_and_name_the_roadmap(model_cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(Config(model_cfg), device="cpu")


def test_training_forward_raises_and_names_the_roadmap():
    model = PWCFlow()
    img = torch.from_numpy(np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model(img, img, train=True)
