"""The image summaries of one validation of each port trainer on the CPU at
64x128 b2, against the tags that the JAX trainers write at the same point:

- ``uflow`` with ``UFlowLoss``: ``Valid/gt``, ``Valid/pred_{i}`` and
  ``Valid/mask_{i}`` (arflow_tpu/training/uflow_trainer.py:197-209);
- ``pwclite`` with ``unflow``: the same without the mask, which the loss
  does not return (the JAX trainer raises a ``KeyError`` there);
- ``uflow_elbo`` with the mixture and ``track_auc``: ``Valid/gt_{i}``,
  ``Valid/pred_{i}_{k}`` per component, ``Valid/entropy_{i}``,
  ``Valid/sample_flows_{i}``, ``Valid/occu_masks_{i}``,
  ``Valid/valid_masks_{i}`` and ``Valid/splot_{i}``
  (arflow_tpu/training/uflow_elbo_trainer.py:236-311);
- ``mse``: ``Valid/gt_{i}`` and ``Valid/pred_{i}``
  (arflow_tpu/training/mse_trainer.py:173-182).

Each image of a batch is its own tag ``{tag}/{b}``, a PNG under
``save_root/images``.
"""

import json
import logging
import os
import sys

import numpy as np
import pytest

from arflow_tpu_torch import Config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.training import get_trainer
from torch_port_util import few_torch_threads  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 128
TRAIN = {"batch_size": B, "epoch_num": 1, "epoch_size": 1000, "valid_size": 0,
         "valid_freq": 1, "optim": "adam", "lr": 1e-4, "beta1": 0.9,
         "beta2": 0.999, "weight_decay": 0.0, "bias_decay": 0.0,
         "lr_decay_start_epoch": 300, "lr_decay_factor": 0.98,
         "print_freq": 100, "record_freq": 100, "save_iter": 10**9, "seed": 0,
         "sp_samples": 11}
UFLOW = ({"type": "uflow", "feature_norm": True},
         {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0, "smooth_order": 1,
          "edge_constant": 150.0, "with_bk": True})
PWCLITE_UNFLOW = (
    {"type": "pwclite", "n_frames": 2, "upsample": True, "reduce_dense": True},
    {"type": "unflow", "occ_from_back": True, "w_l1": 0.15, "w_ssim": 0.85,
     "w_ternary": 0.0, "w_smooth": 75.0, "smooth_2nd": True, "alpha": 10,
     "w_scales": [1.0, 1.0, 1.0, 1.0, 0.0, 0.0],
     "w_sm_scales": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0], "warp_pad": "border",
     "with_bk": True})
log = logging.getLogger("test")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Kept from importing: tensorboardX imports TensorFlow."""
    for mod in ("tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, mod, None)


def _sections(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        full = json.load(f)
    return full["model"], full["loss"]


def _setups():
    mix_model, mix_loss = _sections("chairs_uflow_elbo_mixture.json")
    mse_model, mse_loss = _sections("chairs_uflow_mse.json")
    return {
        "uflow": ("uflow", *UFLOW, {}),
        "pwclite_unflow": ("uflow", *PWCLITE_UNFLOW, {}),
        "uflow_elbo_mixture": ("uflow_elbo", mix_model,
                               dict(mix_loss, n_samples=2), {"track_auc": True}),
        "mse": ("mse", mse_model, mse_loss, {}),
    }


def _want(name):
    per_image = {
        "uflow": ["Valid/gt", "Valid/pred_0", "Valid/mask_0"],
        "pwclite_unflow": ["Valid/gt", "Valid/pred_0"],
        "uflow_elbo_mixture": ["Valid/gt_0", "Valid/pred_0_0", "Valid/pred_0_1",
                               "Valid/entropy_0", "Valid/sample_flows_0",
                               "Valid/occu_masks_0", "Valid/valid_masks_0"],
        "mse": ["Valid/gt_0", "Valid/pred_0"],
    }[name]
    tags = [f"{t}/{b}" for t in per_image for b in range(B)]
    return tags + (["Valid/splot_0"] if name == "uflow_elbo_mixture" else [])


@pytest.mark.parametrize("name", ["uflow", "pwclite_unflow",
                                  "uflow_elbo_mixture", "mse"])
def test_validation_writes_the_jax_tags(tmp_path, name):
    pytest.importorskip("PIL")
    pytest.importorskip("matplotlib")
    trainer_name, model_c, loss_c, train = _setups()[name]
    cfg = Config({"model": model_c, "loss": loss_c,
                  "train": dict(TRAIN, **train)})
    rs = np.random.RandomState(0)
    img1 = rs.rand(B, H, W, 3).astype(np.float32)
    batch = {"img1": img1, "img2": np.roll(img1, 2, axis=2),
             "target": {"flow": (rs.randn(B, H, W, 2) * 2).astype(np.float32)}}
    model = get_model(cfg.model, device="cpu", seed=0)
    trainer = get_trainer(trainer_name)(
        [batch], [[batch]], model, get_loss(cfg.loss), log, str(tmp_path),
        cfg.train, model_cfg=cfg.model, full_cfg=cfg)
    trainer._ensure_init()
    trainer.i_epoch = 1
    trainer._validate_with_gt()
    with open(tmp_path / "events.jsonl") as f:
        rows = [r for r in map(json.loads, f) if "image" in r]
    assert sorted(r["tag"] for r in rows) == sorted(_want(name))
    for r in rows:
        assert r["step"] == 1
        assert r["image"] == os.path.join(
            str(tmp_path), "images", f"{r['tag'].replace('/', '_')}_1.png")
        assert os.path.getsize(r["image"]) > 0
    assert sorted(os.listdir(tmp_path / "images")) == sorted(
        os.path.basename(r["image"]) for r in rows)
