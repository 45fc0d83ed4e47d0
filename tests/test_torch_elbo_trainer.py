"""The port's ``UFlowElboTrainer`` on the CPU at 64x96 (its lockstep
against the JAX trainer is in ``test_torch_elbo_lockstep.py``):

- validation: its names, and its values against the JAX package's numpy
  metrics (EPE with KITTI's masks, AUC) on the same predictions and
  entropies, and the loss terms against the loss on the same draws;
- the best checkpoint chosen on the validation ``Loss``;
- a resumed ``train_main`` run equal bit for bit to an unbroken one, with
  level dropout and the loss's draws from the checkpointed generator;
- ``train_main`` with ``configs/chairs_uflow_elbo.json`` on a FlyingChairs
  directory, and ``-e`` setting ``track_auc``.
"""

import json
import logging
import os

import pytest

pytest.importorskip("flax", reason="arflow_tpu.models needs flax")

import numpy as np
import torch

from arflow_tpu.utils import metrics as jax_metrics
from arflow_tpu_torch import Config, cli, load_config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from arflow_tpu_torch.training.entropy import extract_uv_entropy
from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer
from test_torch_checkpoint import assert_state_equal
from torch_data_util import make_shifted_chairs_dir
from torch_port_util import H, W, few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow_elbo.json")
B, EPOCHS = 2, 2
KEYS = ("total", "l_ph", "l_sm", "entropy", "l_oof")
log = logging.getLogger("test")


def sections():
    """chairs_uflow_elbo.json's model (dropout off), loss and train
    sections, with the loss named by ``type``."""
    with open(CONFIG) as f:
        full = json.load(f)
    model = dict(full["model"], level_dropout=0.0)
    loss = dict(full["loss"], type="uflow_elbo")
    train = dict(full["train"], batch_size=B, epoch_num=EPOCHS, epoch_size=1000,
                 lr=1e-7, lr_decay_start_epoch=1, lr_decay_factor=0.5,
                 weight_decay=1e-2, print_freq=100, record_freq=1,
                 save_iter=10**9, valid_freq=10**9, seed=0)
    return model, loss, train


def _valid_batches(rs, n):
    """KITTI-style ground truth: flow, occ mask and noc mask."""
    out = []
    for _ in range(n):
        gt = np.concatenate([rs.randn(B, H, W, 2) * 2,
                             np.ones((B, H, W, 1)),
                             (rs.rand(B, H, W, 1) > 0.3).astype(np.float64)], -1)
        out.append({"img1": rs.rand(B, H, W, 3).astype(np.float32),
                    "img2": rs.rand(B, H, W, 3).astype(np.float32),
                    "target": {"flow": gt.astype(np.float32)}})
    return out


def _port_trainer(tmp_path, train_batches, valid, approx="diag", **train):
    model_c, loss_c, train_c = sections()
    model_c["level_dropout"] = 0.1
    loss_c["approx"] = approx
    if approx == "mixture":
        model_c.update(n_pyramids=2)
        loss_c.update(n_components=2, closed_form_smooth=False, n_samples=2)
    train_c.update(dict(dict(lr=1e-4, valid_size=10, valid_masks=True,
                             track_auc=True, track_cc=True, sp_samples=11,
                             save_iter=0), **train))
    cfg = Config({"model": model_c, "loss": loss_c, "train": train_c})
    model = get_model(cfg.model, device="cpu", seed=0)
    return get_trainer("uflow_elbo")(train_batches, valid, model,
                                     get_loss(cfg.loss), log, str(tmp_path),
                                     cfg.train, model_cfg=cfg.model, full_cfg=cfg)


@pytest.mark.parametrize("approx", ["diag", "mixture"])
def test_validation_names_values_and_files(approx, tmp_path):
    rs = np.random.RandomState(1)
    valid = _valid_batches(rs, 2)
    train = [{k: v for k, v in valid[0].items() if k != "target"}]
    tr = _port_trainer(tmp_path, train, [valid], approx=approx, epoch_num=1)
    assert isinstance(tr, UFlowElboTrainer)
    tr.train()  # one step, then validation (which saves)
    errors, names = tr._validate_with_gt()
    assert names == [f"{n}_0" for n in ("Loss", "l_ph", "l_sm", "entropy", "l_oof",
                                        "EPE", "E_noc", "E_occ", "F1_all",
                                        "AUC", "AUC_diff")]
    # The same values from the port's model and loss with the draws of a
    # generator seeded as validation seeds its own at each batch, and from
    # the JAX package's numpy metrics on the same predictions and entropies.
    gen = torch.Generator()
    terms, flows, gts, preds, ents = [], [], [], [], []
    with torch.no_grad():
        for v in valid:
            gen.manual_seed(0)
            img1, img2 = (torch.from_numpy(v[k]) for k in ("img1", "img2"))
            res = tr.model(img1, img2, with_bk=True)
            out = tr.loss_func(res, img1, img2, generator=gen)
            ents.append(extract_uv_entropy(res["flows_fw"], tr.loss_func.cfg, res,
                                           generator=gen).numpy())
            terms.append([float(out[k]) for k in KEYS])
            preds.append(res["flows_fw"][0][..., :2].numpy())
            gts.append(v["target"]["flow"])
            flows.append(res["flows_fw"][2].numpy())
    want = list(np.mean(terms, axis=0))
    want += list(np.mean([jax_metrics.evaluate_flow(list(g), list(p))
                          for g, p in zip(gts, preds)], axis=0))
    want += list(np.mean([jax_metrics.evaluate_uncertainty(
        list(g), list(p), list(e), sp_samples=11)[0]
        for g, p, e in zip(gts, preds, ents)], axis=0))
    # float32 sums in another order on the loss terms; EPE and AUC are the
    # same numpy on the same arrays, up to the resize helpers' rounding
    np.testing.assert_allclose(errors, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(errors).all()
    np.testing.assert_array_equal(np.load(tmp_path / "flow_fw_l2_1.npy"), flows[-1])


def test_best_checkpoint_chosen_on_the_validation_loss(tmp_path):
    rs = np.random.RandomState(2)
    valid = _valid_batches(rs, 1)
    train = [{k: v for k, v in valid[0].items() if k != "target"}]
    tr = _port_trainer(tmp_path, train, [valid], epoch_num=1, track_auc=False,
                       track_cc=False)
    tr.train()  # one step; this config validates at no epoch
    errors, _ = tr._validate_with_gt()
    best = load_checkpoint(str(tmp_path / "Chairs_model_best.pth.tar"))
    first = tr.best_error
    assert first == best["best_error"] == errors[0]  # Loss, not EPE
    assert errors[0] != errors[5]
    # A worse Loss (the same model, its total raised by 1) saves the
    # checkpoint but keeps the best one, whatever the EPE does.
    loss = tr.loss_func

    def worse(*args, **kwargs):
        out = loss(*args, **kwargs)
        return dict(out, total=out["total"] + 1.0)

    worse.cfg = loss.cfg
    tr.loss_func = worse
    tr.i_iter += 1
    errors2, _ = tr._validate_with_gt()
    np.testing.assert_allclose(errors2[0], errors[0] + 1.0, rtol=1e-6)
    assert errors2[5] == errors[5]
    assert tr.best_error == first
    assert load_checkpoint(str(tmp_path / "Chairs_ckpt.pth.tar"))["i_iter"] == tr.i_iter
    assert load_checkpoint(str(tmp_path / "Chairs_model_best.pth.tar"))["i_iter"] == best["i_iter"]


def _chairs_cfg(root, save_root, epoch_num, resume=None, augment=False):
    """chairs_uflow_elbo.json over ``root``: batch 2, every epoch validates
    and saves; without augmentation unless asked (a resume restores the
    generator, not the augmentation's draws)."""
    cfg = load_config(CONFIG)
    for entry in cfg.data:
        entry.root_chairs = str(root)
    if augment:
        cfg.data[0].geometric_aug.crop_size = [64, 96]
    else:
        del cfg.data[0]["geometric_aug"], cfg.data[0]["photometric_aug"]
    cfg.save_root = str(save_root)
    cfg.train.update(batch_size=2, valid_batch_size=2, epoch_num=epoch_num,
                     valid_freq=1, save_iter=0, workers=2, print_freq=1,
                     record_freq=1, lr_decay_start_epoch=1)
    if resume is not None:
        cfg.train.resume = str(resume)
    return cfg


def test_resume_continues_bit_for_bit(tmp_path):
    """Two epochs unbroken (A) against one (B) and a resume of B's
    checkpoint (C): Adam, the schedule, level dropout and the loss's draws
    from the one generator the checkpoint holds."""
    # fids 1-6: fid 6 is the valid split, 5 train pairs make 2 batches of 2
    root = make_shifted_chairs_dir(tmp_path / "chairs", np.random.RandomState(3),
                                   6, H, W)
    tr_a = cli.train_main(_chairs_cfg(root, tmp_path / "a", 2), log, device="cpu")
    cli.train_main(_chairs_cfg(root, tmp_path / "b", 1), log, device="cpu")
    tr_c = cli.train_main(_chairs_cfg(root, tmp_path / "c", 2,
                                      resume=tmp_path / "b" / "Chairs_ckpt.pth.tar"),
                          log, device="cpu")
    assert (tr_a.i_epoch, tr_a.i_iter) == (tr_c.i_epoch, tr_c.i_iter) == (2, 4)
    assert_state_equal(tr_c.model.state_dict(), tr_a.model.state_dict(), "weights")
    assert_state_equal(tr_c.optimizer.optimizer.state_dict(),
                       tr_a.optimizer.optimizer.state_dict(), "adam")
    assert_state_equal(tr_c.generator.get_state(), tr_a.generator.get_state(),
                       "generator")
    assert tr_c.best_error == tr_a.best_error
    np.testing.assert_array_equal(np.load(tmp_path / "c" / "flow_fw_l2_2.npy"),
                                  np.load(tmp_path / "a" / "flow_fw_l2_2.npy"))


def test_train_main_chairs_uflow_elbo_and_evaluate_flag(tmp_path, monkeypatch):
    """The shipped config with its augmentation (the crop cut to 64x96 on
    96x128 pairs): two epochs that validate and save, the best checkpoint
    on the validation Loss; ``-e`` sets ``track_auc``."""
    root = make_shifted_chairs_dir(tmp_path / "chairs", np.random.RandomState(4),
                                   7, 96, 128)
    cfg = _chairs_cfg(root, tmp_path / "run", 2, augment=True)
    tr = cli.train_main(cfg, log, device="cpu")
    assert isinstance(tr, UFlowElboTrainer)
    assert (tr.i_epoch, tr.i_iter) == (2, 6)
    with open(tmp_path / "run" / "events.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["value"] for r in recs if r["tag"] == "Valid_Loss_0"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tr.best_error == min(losses)
    assert len([r for r in recs if r["tag"] == "Train_entropy"]) == 6
    for name in ("Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar",
                 "flow_fw_l2_1.npy", "flow_fw_l2_2.npy"):
        assert (tmp_path / "run" / name).is_file(), name

    seen = {}
    monkeypatch.setattr(cli, "train_main",
                        lambda cfg, log, device: seen.update(cfg=cfg))
    monkeypatch.chdir(tmp_path)
    cli.train_cli(["-c", CONFIG, "-e", "--device", "cpu"])
    assert seen["cfg"].train.track_auc is True
    assert seen["cfg"].trainer == "uflow_elbo"


@pytest.mark.parametrize("name", [
    "chairs_uflow_elbo.json", "kitti_uflow_elbo.json", "sintel_uflow_elbo.json",
    "things_uflow_elbo.json", "chairs_uflow_elbo_nondiag.json",
    "chairs_uflow_elbo_lowrank.json",
    "chairs_uflow_elbo_mixture.json", "chairs_uflow_elbo_nondiag_inv.json",
])
def test_train_main_shipped_elbo_configs(name, tmp_path):
    """Each shipped ``uflow_elbo`` config's model, loss and train sections
    train (two steps, given a FlyingChairs directory for its data, and the
    fine-tuning configs a checkpoint to start from; the mixture config with
    its weights net), but for the sparse precision ELBO, which raises and
    names its roadmap item."""
    root = make_shifted_chairs_dir(tmp_path / "chairs", np.random.RandomState(5),
                                   4, H, W)
    cfg = load_config(os.path.join(REPO, "configs", name))
    assert cfg.trainer == "uflow_elbo"
    cfg.data = [{"root_chairs": str(root), "type": "train", "name": "Chairs",
                 "n_frames": 2}]
    cfg.save_root = str(tmp_path / "run")
    cfg.train.update(batch_size=2, epoch_num=1, epoch_size=1, workers=1,
                     record_freq=1, print_freq=1)
    if cfg.train.get("pretrained_model"):  # the fine-tuning configs
        path = str(tmp_path / "pretrained.pth.tar")
        torch.save({"epoch": 0, "state_dict": get_model(
            cfg.model, device="cpu", seed=1).state_dict()}, path)
        cfg.train.pretrained_model = path
    if name == "chairs_uflow_elbo_nondiag_inv.json":
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 3, 'the "
                           "sparse precision ELBO'"):
            cli.train_main(cfg, log, device="cpu")
        return
    tr = cli.train_main(cfg, log, device="cpu")
    assert isinstance(tr, UFlowElboTrainer) and tr.i_iter == 2
    with open(tmp_path / "run" / "events.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "Train_Loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
