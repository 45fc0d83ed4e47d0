"""Command-line entry points of the port: training, inference and the
offline evaluation of its outputs, as ``arflow_tpu/cli.py`` has them.

    arflow-torch-train -c configs/chairs_uflow.json [--device cpu]
    arflow-torch-train -c configs/chairs_uflow_elbo.json [--device cpu]
    arflow-torch-train -c configs/chairs_uflow_mse.json [--device cpu]
    arflow-torch-inference -c cfg.json -m ckpt.pth.tar [--device cpu]
    arflow-torch-evaluate-flo --pred_root out/ --gt_root gt/
    python -m arflow_tpu_torch.cli train|inference|evaluate-flo ...

Training and inference run on the CUDA device unless ``--device``
(``device=``) says otherwise, and raise without a card instead of dropping
to the CPU; the evaluation is numpy on the host.
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import pprint
import random
import sys
import time

import numpy as np
import torch

from arflow_tpu_torch.config import load_config
from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.utils.logger import init_logger


def seed_everything(seed: int):
    np.random.seed(seed)
    random.seed(seed)


def build_loaders(cfg, log):
    from arflow_tpu_torch.data import DataLoader, get_dataset

    train_set, valid_set = get_dataset(cfg, seed=cfg.seed)
    valid_len = sum(len(s) for s in valid_set)
    log.info(
        "%d samples found, %d train samples and %d test samples",
        valid_len + (len(train_set) if train_set else 0),
        len(train_set) if train_set else 0,
        valid_len,
    )
    train_loader = (
        DataLoader(
            train_set,
            batch_size=cfg.train.batch_size,
            num_workers=cfg.train.workers,
            shuffle=True,
            drop_last=True,
            seed=cfg.seed,
        )
        if train_set
        else None
    )
    valid_batch_size = cfg.train.get("valid_batch_size", 1)
    valid_loader = [
        DataLoader(
            s,
            batch_size=valid_batch_size,
            num_workers=min(4, cfg.train.workers),
            shuffle=False,
        )
        for s in valid_set
    ]
    return train_loader, valid_loader


def train_main(cfg, log, device="cuda"):
    """Build the loaders, model, loss and trainer of ``cfg`` on ``device``
    and train; returns the trainer."""
    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.training import get_trainer

    if cfg.model.get("dtype") == "int8":
        raise ValueError(
            "model.dtype 'int8' is a serving-only mode of the JAX package: "
            "the quantization round has zero gradient, so the feature "
            "pyramid would receive no training.")
    dev = resolve_device(device)
    seed_everything(cfg.seed)
    train_loader, valid_loader = build_loaders(cfg, log)

    if cfg.train.epoch_size == 0 or cfg.train.epoch_size < 0:
        cfg.train.epoch_size = len(train_loader) if train_loader else 0
    if train_loader:
        cfg.train.epoch_size = min(cfg.train.epoch_size, len(train_loader))
    valid_size = sum(len(l) for l in valid_loader)
    if cfg.train.valid_size == 0:
        cfg.train.valid_size = valid_size
    cfg.train.valid_size = min(cfg.train.valid_size, valid_size)
    cfg.train.seed = cfg.seed

    model = get_model(cfg.model, device=dev, seed=cfg.seed)
    loss = get_loss(cfg.loss)
    trainer = get_trainer(cfg.trainer)(
        train_loader,
        valid_loader,
        model,
        loss,
        log,
        cfg.save_root,
        cfg.train,
        model_cfg=cfg.model,
        full_cfg=cfg,
    )
    trainer.train()
    return trainer


def train_cli(argv=None):
    parser = argparse.ArgumentParser(prog="arflow-torch-train")
    parser.add_argument("-c", "--config", default="configs/sintel_uflow.json")
    parser.add_argument("-e", "--evaluate", action="store_true")
    parser.add_argument("-m", "--model", default=None)
    parser.add_argument("--resume", default=None,
                        help="checkpoint to resume from (weights, optimizer "
                             "state, schedule, dropout generator, epoch, "
                             "iteration and best error)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host training: not ported yet")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    if args.coordinator is not None:
        raise NotImplementedError(
            "multi-host training (--coordinator) is not ported yet: "
            "ROADMAP.md queue 1, 'parallel'")
    resolve_device(args.device)

    cfg = load_config(args.config)
    if args.evaluate:
        cfg.train.update(
            {
                "batch_size": 16,
                "valid_batch_size": 16,
                "epoch_num": 1,
                "epoch_size": -1,
                "valid_size": 0,
                "workers": 1,
                "valid_freq": 1,
                "track_auc": True,
            }
        )
    if args.model is not None:
        cfg.train.pretrained_model = args.model
    if args.resume is not None:
        cfg.train.resume = args.resume

    curr_time = datetime.datetime.now().strftime("%y%m%d%H%M%S")
    cfg.save_root = os.path.join(
        "./outputs/checkpoints", curr_time[:6], curr_time[6:]
    )
    os.makedirs(cfg.save_root, exist_ok=True)

    log = init_logger(log_dir=cfg.save_root, filename=curr_time[6:] + ".log")
    log.info("=> will save everything to %s", cfg.save_root)
    log.info("=> configurations \n %s", pprint.pformat(cfg))
    return train_main(cfg, log, device=args.device)


def inference_main(cfg, log, device="cuda"):
    """Write a ``.flo`` flow and a ``.npy`` entropy map per sample of each
    valid dataset of ``cfg`` under its ``out_root``, at the sample's
    original size, from the ``cfg.inference.pretrained_model`` weights.
    Returns the ``.flo`` paths.

    The entropy is ``extract_uv_entropy`` of ``cfg.loss.approx`` (a
    (u, v) log-std map), zero where the config has no ``approx`` (the
    deterministic ``uflow`` model); resizing it to the original size adds
    the log-scale terms ``-2 log w + 2 log ww`` (and for v, of h), as the
    JAX package writes it. The ``mixture`` approximation draws its
    Monte-Carlo samples from a generator seeded 0 for each batch, as the
    JAX one does from ``PRNGKey(0)``; the two draw different numbers, so
    their ``.npy`` differ by Monte-Carlo noise.

    The model runs with ``with_bk=False``, so ``mixture_weights`` raises
    here, before any pair is read, as the JAX ``inference_main`` fails on
    it at the first pair."""
    from arflow_tpu_torch.data import DataLoader, get_dataset
    from arflow_tpu_torch.models import load_pretrained
    from arflow_tpu_torch.models.uflow_prob import MIXTURE_NEEDS_BK
    from arflow_tpu_torch.ops.resize import resize_bilinear_np
    from arflow_tpu_torch.training.entropy import extract_uv_entropy
    from arflow_tpu_torch.utils.flow_io import write_flo
    from arflow_tpu_torch.utils.meters import AverageMeter

    if cfg.model.get("mixture_weights"):
        raise ValueError(f"inference_main: {MIXTURE_NEEDS_BK}")
    dev = resolve_device(device)
    _, valid_set = get_dataset(cfg, seed=cfg.get("seed", 0))
    valid_batch_size = cfg.inference.get("valid_batch_size", 1)
    loaders = [
        DataLoader(s, batch_size=valid_batch_size,
                   num_workers=min(4, cfg.inference.get("workers", 2)))
        for s in valid_set
    ]
    model = load_pretrained(cfg.inference.pretrained_model, cfg.model,
                            device=dev).eval()
    has_entropy = "approx" in cfg.loss

    # get_dataset makes a valid set of each entry whose type is not train
    valid_cfgs = [d for d in cfg.data if d.type != "train"]
    written = []
    batch_time = AverageMeter()
    for (i_set, loader), dataset_cfg in zip(enumerate(loaders), valid_cfgs):
        for i_step, data in enumerate(loader):
            end = time.time()
            img1, img2 = (torch.as_tensor(data[k], dtype=torch.float32,
                                          device=dev) for k in ("img1", "img2"))
            with torch.no_grad():
                res = model(img1, img2, with_bk=False)
                flows = res["flows_fw"]
                pred = flows[0][..., :2]
                ent = (extract_uv_entropy(
                    flows, cfg.loss, res,
                    generator=torch.Generator(device=dev).manual_seed(0))
                    if has_entropy else torch.zeros_like(pred))
            pred_np, ent_np = pred.cpu().numpy(), ent.cpu().numpy()

            for pred_flow, pred_entropy, orgsize, rpath in zip(
                pred_np, ent_np, data["img1_orgsize"], data["img1_rpath"]
            ):
                orgsize = np.asarray(orgsize).squeeze()
                hh, ww = int(orgsize[0]), int(orgsize[1])
                h, w = pred_flow.shape[:2]
                pred_flow = pred_flow.copy()
                pred_flow[:, :, 0] *= ww / w
                pred_flow[:, :, 1] *= hh / h
                pred_flow = resize_bilinear_np(pred_flow, (hh, ww))
                pred_entropy = pred_entropy.copy()
                pred_entropy[:, :, 0] += -2 * math.log(w) + 2 * math.log(ww)
                pred_entropy[:, :, 1] += -2 * math.log(h) + 2 * math.log(hh)
                pred_entropy = resize_bilinear_np(pred_entropy, (hh, ww))

                stem = os.path.join(dataset_cfg.out_root,
                                    os.path.splitext(str(rpath))[0])
                os.makedirs(os.path.dirname(stem), exist_ok=True)
                write_flo(stem + ".flo", pred_flow)
                np.save(stem + ".npy", pred_entropy)
                written.append(stem + ".flo")

            batch_time.update(time.time() - end)
            log.info(
                "Inference: %d[%d/%d] Time %s",
                i_set, i_step, len(loader), batch_time,
            )
    return written


def inference_cli(argv=None):
    parser = argparse.ArgumentParser(prog="arflow-torch-inference")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-m", "--model", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    cfg = load_config(args.config)
    if args.model is not None:
        cfg.inference.pretrained_model = args.model
    log = init_logger(log_dir=".", filename="inference.log")
    log.info("=> configurations \n %s", pprint.pformat(cfg))
    return inference_main(cfg, log, device=args.device)


def evaluate_flo_cli(argv=None):
    """Mean EPE, and where every ``.flo`` has its ``.npy`` entropy beside
    it the sparsification AUC, over the ``.flo`` files under
    ``--pred_root`` that have a ground truth at the same relative path
    under ``--gt_root``. Prints both as the JAX package's
    ``evaluate_flo_cli`` does; returns ``{'files', 'epe', 'auc',
    'auc_diff'}`` (the AUCs None without entropies)."""
    from pathlib import Path

    from arflow_tpu_torch.utils.flow_io import read_flo
    from arflow_tpu_torch.utils.metrics import evaluate_flow, evaluate_uncertainty

    parser = argparse.ArgumentParser(prog="arflow-torch-evaluate-flo")
    parser.add_argument("--pred_root", required=True)
    parser.add_argument("--gt_root", required=True)
    parser.add_argument("--sp_samples", type=int, default=25)
    args = parser.parse_args(argv)

    preds, gts, ents = [], [], []
    for pred_path in sorted(Path(args.pred_root).rglob("*.flo")):
        gt_path = Path(args.gt_root) / pred_path.relative_to(args.pred_root)
        if not gt_path.is_file():
            continue
        preds.append(read_flo(str(pred_path)))
        gts.append(read_flo(str(gt_path)))
        ent_path = pred_path.with_suffix(".npy")
        if ent_path.is_file():
            ents.append(np.load(ent_path))
    epe = evaluate_flow(gts, preds)
    print(f"EPE: {epe[0]:.4f} over {len(preds)} files")
    out = {"files": len(preds), "epe": float(epe[0]), "auc": None,
           "auc_diff": None}
    if ents and len(ents) == len(preds):
        auc, _, _ = evaluate_uncertainty(gts, preds, ents, args.sp_samples)
        print(f"AUC: {auc[0]:.4f} AUC_diff: {auc[1]:.4f}")
        out.update(auc=float(auc[0]), auc_diff=float(auc[1]))
    return out


def main(argv=None):
    """``python -m arflow_tpu_torch.cli train|inference|evaluate-flo
    [options]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"train": train_cli, "inference": inference_cli,
                "evaluate-flo": evaluate_flo_cli}
    if not argv or argv[0] not in commands:
        raise SystemExit("usage: python -m arflow_tpu_torch.cli "
                         "{train,inference,evaluate-flo} [options]")
    commands[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
