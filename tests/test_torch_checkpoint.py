"""The port's ``.pth.tar`` checkpoints: the save/load round trip with the
best-error copy, a resumed CPU run equal bit for bit to an unbroken one,
the JAX package's importer reading a port checkpoint, and the formats the
port refuses."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model, load_pretrained
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from torch_data_util import few_torch_threads, make_chairs_dir  # noqa: F401

H, W = 64, 96
log = logging.getLogger("test")
MODEL = {"type": "uflow", "feature_norm": True, "level_dropout": 0.1}
LOSS = {"type": "uflow", "w_census": 1.0, "w_smooth": 4.0, "smooth_order": 1,
        "edge_constant": 150.0, "with_bk": True}
TRAIN = {"batch_size": 2, "epoch_num": 2, "epoch_size": 1000, "valid_size": 0,
         "valid_freq": 1, "optim": "adam", "lr": 1e-4, "beta1": 0.9,
         "beta2": 0.999, "eps": 1e-8, "weight_decay": 0.0, "bias_decay": 0.0,
         "lr_decay_start_epoch": 1, "lr_decay_factor": 0.5, "print_freq": 1,
         "record_freq": 1, "save_iter": 0, "workers": 2, "clip": -1.0}


def _trainer(save_root, **train):
    cfg = Config({"model": MODEL, "loss": LOSS,
                  "train": {**TRAIN, "epoch_num": 1, **train}})
    model = get_model(cfg.model, device="cpu", seed=0)
    rs = np.random.RandomState(0)
    batch = {k: rs.rand(1, H, W, 3).astype(np.float32) for k in ("img1", "img2")}
    return get_trainer("uflow")([batch], None, model, get_loss(cfg.loss), log,
                                str(save_root), cfg.train, model_cfg=cfg.model,
                                full_cfg=cfg)


def assert_state_equal(a, b, where):
    """Equal nested dicts/lists of tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            assert_state_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_state_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0, msg=where)
    else:
        assert a == b, where


def test_save_load_round_trip_and_best_copy(tmp_path):
    tr = _trainer(tmp_path)
    tr.train()  # one step, no validation loader
    ckpt_path = tmp_path / "Chairs_ckpt.pth.tar"
    best_path = tmp_path / "Chairs_model_best.pth.tar"
    # (iteration, error, the best save's iteration and error after it)
    for i_iter, error, best_iter, best_error in ((1, 5.0, 1, 5.0),
                                                 (2, 7.0, 1, 5.0),
                                                 (3, 3.0, 3, 3.0)):
        tr.i_iter = i_iter
        tr.save_model(error, name="Chairs")
        ckpt = load_checkpoint(str(ckpt_path))
        assert ckpt["i_iter"] == i_iter and ckpt["epoch"] == 1
        assert ckpt["best_error"] == tr.best_error == best_error
        assert load_checkpoint(str(best_path))["i_iter"] == best_iter
    assert sorted(ckpt) == ["best_error", "epoch", "generator", "i_iter",
                            "opt_count", "optimizer", "state_dict"]
    assert_state_equal(ckpt["state_dict"], tr.model.state_dict(), "state_dict")
    assert_state_equal(ckpt["optimizer"], tr.optimizer.optimizer.state_dict(),
                       "optimizer")
    assert ckpt["opt_count"] == tr.optimizer.count == 1
    assert_state_equal(ckpt["generator"], tr.generator.get_state(), "generator")
    loaded = load_pretrained(str(ckpt_path), Config(MODEL), device="cpu")
    assert_state_equal(loaded.state_dict(), tr.model.state_dict(), "load_pretrained")


def _run(root, save_root, epoch_num, resume=None):
    """train_main on the CPU over ``root`` with no augmentation."""
    data = [{"root_chairs": str(root), "type": t, "name": "Chairs",
             "n_frames": 2} for t in ("train", "valid")]
    cfg = Config({"seed": 0, "save_root": str(save_root), "trainer": "uflow",
                  "data": data, "model": MODEL, "loss": LOSS,
                  "train": dict(TRAIN, epoch_num=epoch_num)})
    if resume:
        cfg.train.resume = str(resume)
    return cli.train_main(cfg, log, device="cpu")


def _events(save_root):
    """(tag, step, value) of each scalar row and (tag, step, file name) of
    each image row."""
    with open(os.path.join(save_root, "events.jsonl")) as f:
        return sorted((r["tag"], r["step"],
                       r["value"] if "value" in r else os.path.basename(r["image"]))
                      for r in map(json.loads, f))


def test_resume_continues_bit_for_bit(tmp_path):
    """Two epochs unbroken (A) against one epoch (B) and a resume of B's
    checkpoint for the second (C): Adam, the schedule's second-epoch decay
    and level dropout's draws included."""
    # fids 1-6: fid 6 is the valid split, 5 train pairs make 2 batches of 2
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(4), 6, H, W)
    tr_a = _run(root, tmp_path / "a", epoch_num=2)
    tr_b = _run(root, tmp_path / "b", epoch_num=1)
    tr_c = _run(root, tmp_path / "c", epoch_num=2,
                resume=tmp_path / "b" / "Chairs_ckpt.pth.tar")
    assert (tr_a.i_epoch, tr_a.i_iter) == (tr_c.i_epoch, tr_c.i_iter) == (2, 4)
    assert (tr_b.i_epoch, tr_b.i_iter) == (1, 2)
    events_a, events_c = _events(tmp_path / "a"), _events(tmp_path / "c")
    # C trained iterations 2-3 and validated epoch 2, with A's metric rows
    # (Train_* are logged per iteration, Valid_EPE_0 per epoch) and image
    # rows (Valid/gt, pred_0 and mask_0 of the one valid pair, per epoch)
    assert events_c == [e for e in events_a if e[1] >= 2]
    assert len(events_c) == 2 * 4 + 1 + 3
    assert_state_equal(tr_c.model.state_dict(), tr_a.model.state_dict(), "weights")
    assert_state_equal(tr_c.optimizer.optimizer.state_dict(),
                       tr_a.optimizer.optimizer.state_dict(), "adam")
    assert tr_c.optimizer.count == tr_a.optimizer.count == 4
    assert_state_equal(tr_c.generator.get_state(), tr_a.generator.get_state(),
                       "generator")
    assert tr_c.best_error == tr_a.best_error
    # and the unbroken run's first epoch differs from its second: the
    # comparison above is not of two untrained runs
    assert not torch.equal(load_checkpoint(
        str(tmp_path / "b" / "Chairs_ckpt.pth.tar"))["state_dict"][
            "_refine_model.0.weight"], tr_a.model.state_dict()["_refine_model.0.weight"])


def test_jax_package_reads_a_port_checkpoint(tmp_path):
    """``arflow_tpu``'s ``load_pretrained`` reads the port's ``.pth.tar``;
    turned back by the port's converter, the weights are the saved ones bit
    for bit, but for ``_context_up_layers.0``: the reference builds that
    deconv and never applies it, the port initializes it with the rest,
    and the converter writes zeros."""
    pytest.importorskip("flax", reason="arflow_tpu.models needs flax")
    from arflow_tpu.config import Config as JaxConfig
    from arflow_tpu.training.checkpoint import load_pretrained as jax_load_pretrained
    from arflow_tpu_torch.models import uflow_state_dict_from_jax

    tr = _trainer(tmp_path)
    tr.train()
    tr.save_model(1.0, name="Chairs")
    saved = load_checkpoint(str(tmp_path / "Chairs_ckpt.pth.tar"))["state_dict"]
    params = jax_load_pretrained(str(tmp_path / "Chairs_ckpt.pth.tar"),
                                 JaxConfig(MODEL))
    back = uflow_state_dict_from_jax(params)
    assert sorted(back) == sorted(saved)
    unused = [k for k in saved if k.startswith("_context_up_layers.0.")]
    assert len(unused) == 2 and not any(back[k].any() for k in unused)
    assert saved["_context_up_layers.0.weight"].any()
    assert_state_equal({k: v for k, v in back.items() if k not in unused},
                       {k: v for k, v in saved.items() if k not in unused},
                       "jax round trip")


def test_refused_checkpoint_formats(tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        _trainer(tmp_path, checkpoint_backend="orbax")
    orbax = tmp_path / "Chairs_ckpt_orbax"  # the JAX package's directory
    orbax.mkdir()
    tr = _trainer(tmp_path, resume=str(orbax))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tr.train()
