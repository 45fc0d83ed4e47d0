"""The port's entry points on the CPU: ``train_main`` on a synthetic
FlyingChairs directory with ``configs/chairs_uflow.json``'s data and train
sections, ``inference_main`` against the JAX ``inference_main`` on the same
``.pth.tar`` (``uflow``, and ``uflow_prob`` with its entropy maps),
``evaluate_flo_cli`` against the JAX one on those outputs, and the CLIs'
refusals without a card."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from arflow_tpu_torch import Config, cli
from arflow_tpu_torch.data import Chairs
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.ops.cuda import KERNELS
from arflow_tpu_torch.utils.flow_io import read_flo
from torch_data_util import (  # noqa: F401  (few_torch_threads: fixture)
    few_torch_threads,
    make_chairs_dir,
    make_shifted_chairs_dir,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow.json")
H, W = 64, 96
log = logging.getLogger("test")


def chairs_cfg(root, save_root, **train):
    """chairs_uflow.json with both data roots at ``root``, the loss's
    smooth_order set (the config has none, and the loss no default), batch
    2, and one epoch that validates and saves."""
    with open(CONFIG) as f:
        d = json.load(f)
    for entry in d["data"]:
        entry["root_chairs"] = str(root)
    d["loss"]["smooth_order"] = 1
    d["save_root"] = str(save_root)
    d["train"].update(batch_size=2, epoch_num=1, valid_freq=1, save_iter=0,
                      workers=2, print_freq=1, record_freq=1)
    d["train"].update(train)
    return Config(d)


def events(save_root):
    with open(os.path.join(save_root, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_main_one_epoch_on_cpu(tmp_path):
    # fids 1-7: fid 6 is the valid split, 6 train pairs make 3 batches of 2
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(0), 7, H, W)
    save_root = tmp_path / "run"
    before = [k.launches for k in KERNELS]
    trainer = cli.train_main(chairs_cfg(root, save_root), log, device="cpu")
    assert [k.launches for k in KERNELS] == before
    assert trainer.i_epoch == 1 and trainer.i_iter == 3
    assert trainer.cfg.epoch_size == 3 and trainer.cfg.valid_size == 1
    assert trainer.device == torch.device("cpu")
    recs = events(save_root)
    epe = [r["value"] for r in recs if r["tag"] == "Valid_EPE_0"]
    losses = [r["value"] for r in recs if r["tag"] == "Train_Loss"]
    assert len(epe) == 1 and np.isfinite(epe[0])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert trainer.best_error == epe[0]
    for name in ("Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar"):
        ckpt = torch.load(save_root / name, weights_only=True)
        assert ckpt["epoch"] == 1 and ckpt["i_iter"] == 3
        assert ckpt["best_error"] == epe[0]


def test_train_main_lowers_the_loss_on_cpu(tmp_path):
    # The chip phase's convergence bound, small: after 2 epochs of 3 steps
    # the model's loss on one unaugmented batch of train pairs is below
    # that of the untrained model train_main starts from.
    root = make_shifted_chairs_dir(tmp_path / "chairs",
                                   np.random.RandomState(1), 7, H, W)
    cfg = chairs_cfg(root, tmp_path / "run", epoch_num=2)
    untrained = get_model(cfg.model, device="cpu", seed=cfg.seed)
    trainer = cli.train_main(cfg, log, device="cpu")
    pairs = Chairs(str(root), split="train")
    img1, img2 = (torch.from_numpy(np.stack([pairs[i][k] for i in range(4)]))
                  for k in ("img1", "img2"))

    def fixed_batch_loss(model):
        with torch.no_grad():
            res = model(img1, img2, with_bk=True)
            return float(trainer.loss_func(res, img1, img2)["total"])

    assert trainer.optimizer.count == 6
    assert fixed_batch_loss(trainer.model) < fixed_batch_loss(untrained)


def _inference_cfg(module_config, root, out_root, ckpt, model=None, loss=None):
    return module_config({
        "seed": 0,
        "data": [{"root_chairs": str(root), "type": "valid", "name": "Chairs",
                  "n_frames": 2, "split": "trainval",
                  "test_shape": [H, W], "out_root": str(out_root)}],
        "model": model or {"type": "uflow", "feature_norm": True,
                           "level_dropout": 0.0},
        "loss": loss or {"type": "uflow"},
        "inference": {"pretrained_model": str(ckpt), "valid_batch_size": 2,
                      "workers": 2},
    })


# The port's f32 flows against the JAX package's at 64x96 (its TPU
# relayouts on): 1.5e-5 px (tests/test_torch_uflow_f32.py). Rescaled by up
# to 80/64 and resized to 80x112, where the JAX function resizes with cv2
# and the port with the 2-tap numpy gather, the .flo files differed by at
# most 1.62e-5 px in this test (the .npy files by 3e-8); 5e-5 leaves room
# for other hosts' cv2.
FLO_ATOL = 5e-5


def test_inference_main_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("flax", reason="arflow_tpu.models needs flax")
    import arflow_tpu.native
    from arflow_tpu.cli import inference_main as jax_inference_main
    from arflow_tpu.config import Config as JaxConfig

    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)
    # originals larger than test_shape: the flow is rescaled and resized
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(1),
                           3, 80, 112)
    model = get_model(Config({"type": "uflow"}), device="cpu", seed=3)
    ckpt = tmp_path / "uflow.pth.tar"
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)

    written = cli.inference_main(
        _inference_cfg(Config, root, tmp_path / "port", ckpt), log, device="cpu")
    jax_inference_main(_inference_cfg(JaxConfig, root, tmp_path / "jax", ckpt), log)
    assert [os.path.basename(p) for p in written] == [
        f"{fid:05d}_img1.flo" for fid in (1, 2, 3)]
    for path in written:
        name = os.path.basename(path)
        port, jax_flow = read_flo(path), read_flo(str(tmp_path / "jax" / name))
        assert port.shape == jax_flow.shape == (80, 112, 2)
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, jax_flow, rtol=0, atol=FLO_ATOL)
        ent = np.load(path[:-4] + ".npy")
        ent_jax = np.load(str(tmp_path / "jax" / name)[:-4] + ".npy")
        # zero entropy plus the resize's log-scale correction, 2 log(112/96)
        # and 2 log(80/64), constant over the map
        np.testing.assert_allclose(ent, ent_jax, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            ent[0, 0], [2 * np.log(112 / 96), 2 * np.log(80 / 64)], rtol=1e-6)


# sintel_uflow_elbo_inference.json's model and the loss keys inference reads
PROB_MODEL = {"type": "uflow_prob", "feature_norm": True, "level_dropout": 0.1,
              "out_channels": [2, 2, 0], "inv_cov": False, "n_pyramids": 1,
              "mixture_weights": False}
PROB_LOSS = {"type": "uflow_elbo", "approx": "diag", "n_components": 1,
             "inv_cov": False}
# The f32 uflow_prob model against the JAX one with its inference defaults
# (H-fold on); rescaled and resized as above: in this test the .flo files
# differed by at most 2.1e-5 px and the .npy entropies by 1.9e-6.
PROB_ATOL = 5e-5


def _prob_outputs(tmp_path, monkeypatch):
    """Both packages' inference_main on one uflow_prob checkpoint: the
    port's .flo paths, the JAX output root and the data root."""
    import arflow_tpu.native
    from arflow_tpu.cli import inference_main as jax_inference_main
    from arflow_tpu.config import Config as JaxConfig

    monkeypatch.setattr(arflow_tpu.native, "available", lambda: False)
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(2),
                           3, 80, 112)
    model = get_model(Config(PROB_MODEL), device="cpu", seed=4)
    ckpt = tmp_path / "prob.pth.tar"
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)
    written = cli.inference_main(
        _inference_cfg(Config, root, tmp_path / "port", ckpt, PROB_MODEL,
                       PROB_LOSS), log, device="cpu")
    jax_inference_main(_inference_cfg(JaxConfig, root, tmp_path / "jax", ckpt,
                                      PROB_MODEL, PROB_LOSS), log)
    return written, tmp_path / "jax", root


def test_inference_main_prob_matches_jax_and_evaluates(tmp_path, monkeypatch,
                                                       capsys):
    pytest.importorskip("flax", reason="arflow_tpu.models needs flax")
    from arflow_tpu.cli import evaluate_flo_cli as jax_evaluate_flo_cli

    written, jax_root, root = _prob_outputs(tmp_path, monkeypatch)
    assert len(written) == 3
    for path in written:
        name = os.path.basename(path)
        for ext in (".flo", ".npy"):
            ours = (read_flo(path) if ext == ".flo" else np.load(path[:-4] + ext))
            theirs = (read_flo(str(jax_root / name)) if ext == ".flo"
                      else np.load(str(jax_root / name)[:-4] + ext))
            assert ours.shape == theirs.shape == (80, 112, 2)
            assert np.isfinite(ours).all()
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=PROB_ATOL)

    # evaluate-flo over the port's outputs, ground truth the data's .flo
    gt_root = tmp_path / "gt"
    gt_root.mkdir()
    for path in written:
        name = os.path.basename(path)
        (gt_root / name).write_bytes(
            (root / name.replace("_img1.flo", "_flow.flo")).read_bytes())
    capsys.readouterr()
    args = ["--pred_root", str(tmp_path / "port"), "--gt_root", str(gt_root),
            "--sp_samples", "11"]
    out = cli.evaluate_flo_cli(args)
    printed = capsys.readouterr().out
    jax_evaluate_flo_cli(args)
    assert printed == capsys.readouterr().out
    assert printed.startswith("EPE: ") and "AUC: " in printed
    assert out["files"] == 3 and np.isfinite([out["epe"], out["auc"]]).all()
    assert printed.splitlines()[0] == f"EPE: {out['epe']:.4f} over 3 files"
    cli.main(["evaluate-flo", *args])  # python -m arflow_tpu_torch.cli
    assert capsys.readouterr().out == printed


def test_entry_points_refuse_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.train_cli(["-c", CONFIG])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", "-c", CONFIG])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.inference_cli(["-c", CONFIG, "-m", "w.pth.tar"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.train_main(chairs_cfg(tmp_path, tmp_path), log)
    assert os.listdir(tmp_path) == []  # refused before writing anything
    with pytest.raises(ValueError, match="--process_id"):
        cli.train_cli(["-c", CONFIG, "--coordinator", "localhost:1234",
                       "--num_processes", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["evaluate"])
    cfg = chairs_cfg(tmp_path, tmp_path)
    cfg.model.dtype = "int8"
    with pytest.raises(ValueError, match="int8"):
        cli.train_main(cfg, log, device="cpu")
    # the mixture weights net (chairs_uflow_elbo_mixture.json) reads both
    # directions, and inference runs the forward one alone: refused before
    # any pair is read (the JAX inference_main fails on it at the first)
    cfg = _inference_cfg(Config, tmp_path, tmp_path, "w.pth.tar",
                         dict(PROB_MODEL, mixture_weights=True, n_pyramids=2),
                         dict(PROB_LOSS, approx="mixture", n_components=2))
    with pytest.raises(ValueError, match="mixture_weights needs with_bk=True"):
        cli.inference_main(cfg, log, device="cpu")
