"""Command-line entry points of the port: training, inference and the
offline evaluation of its outputs, as ``arflow_tpu/cli.py`` has them.

    arflow-torch-train -c configs/chairs_uflow.json [--device cpu]
    arflow-torch-train -c configs/chairs_uflow_elbo.json [--device cpu]
    arflow-torch-train -c configs/chairs_uflow_mse.json [--device cpu]
    arflow-torch-inference -c cfg.json -m ckpt.pth.tar [--device cpu]
    arflow-torch-evaluate-flo --pred_root out/ --gt_root gt/
    arflow-torch-export -c cfg.json -m ckpt -o model.afx [--streaming]
    arflow-torch-stream -c cfg.json -m ckpt --frames dir/ [--out flo/] [--bw]
    arflow-torch-stream --artifact model.afx --frames dir/ [--out flo/]
    arflow-torch-fit-penalty -c cfg.json --penalty smooth|data
    arflow-torch-to-torch -c cfg.json -m ckpt.msgpack -o ckpt.pth.tar
    arflow-torch-to-torch -c cfg.json -m Chairs_ckpt_orbax/ -o ckpt.pth.tar
    python -m arflow_tpu_torch.cli train|inference|evaluate-flo|export|stream|fit-penalty|to-torch ...

Data-parallel training runs one process per card, each started with the
same config and its own ``--process_id`` (``parallel/mesh.py``):

    arflow-torch-train -c cfg.json --coordinator host0:8476 \
        --num_processes N --process_id i     # i = 0 .. N-1, one per card

``train.batch_size`` stays the global batch; rank i trains on
``cuda:{LOCAL_RANK}`` (or ``cuda:{i % device_count}``); rank 0's
``save_root`` is every rank's, and rank 0 alone writes into it. ``--resume``
takes a ``.pth.tar`` of the port or the JAX package's ``.msgpack``.

Every command that runs a model or a loss does so on the CUDA device unless
``--device`` (``device=``) says otherwise, and raises without a card instead
of dropping to the CPU; the evaluation and the conversion are host code. A
checkpoint given with ``-m`` is a ``.pth(.tar)`` or the JAX package's
``.msgpack``; ``to-torch`` also takes the JAX package's orbax directory
(with the ``tensorstore`` package), the one command of the JAX package
that reads one. Inference, export, streaming and conversion serve every model
type of ``models/__init__.py``, the PWC-Lite family included (a ``model``
section with ``"type": "pwclite"`` and its ``n_frames``, ``"pwclite_prob"``
or ``"pwclite_uflow"``; ``-m`` a reference ``.pth.tar``); the 3-frame
``pwclite`` streams its window with ``arflow-torch-stream`` and exports it
with ``--streaming``.
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


def build_loaders(cfg, log, mesh=None):
    """The train loader (global batches of ``train.batch_size``; with a
    ``mesh``, this rank's rows of each) and the valid loaders (with a
    ``mesh``, this rank's whole batches)."""
    from arflow_tpu_torch.data import DataLoader, get_dataset

    shard = {} if mesh is None else dict(num_replicas=mesh.size, rank=mesh.rank)

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
            **shard,
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
            partition="batches",
            **shard,
        )
        for s in valid_set
    ]
    return train_loader, valid_loader


def train_main(cfg, log, device="cuda"):
    """Build the loaders, model, loss and trainer of ``cfg`` on ``device``
    and train; returns the trainer. Where ``torch.distributed`` is
    initialized (``initialize_multihost``), the trainer gets the run's
    mesh and each rank its share of the data."""
    import torch.distributed as dist

    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.parallel import make_mesh
    from arflow_tpu_torch.training import get_trainer

    if (cfg.model.get("dtype") == "int8"
            or os.environ.get("ARFLOW_INT8_PYRAMID") == "1"):
        raise ValueError(
            "int8 pyramid (model.dtype 'int8' / ARFLOW_INT8_PYRAMID=1) is a "
            "serving-only mode: the quantization round has zero gradient, "
            "so the feature pyramid would receive no training. Train with "
            "'bfloat16' and switch the inference or serving config to "
            "'int8'.")
    dev = resolve_device(device)
    mesh = make_mesh(dev) if dist.is_initialized() else None
    seed_everything(cfg.seed)
    train_loader, valid_loader = build_loaders(cfg, log, mesh)

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
        mesh=mesh,
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
                             "iteration and best error): the port's "
                             ".pth.tar or the JAX package's .msgpack")
    parser.add_argument("--n_gpu", type=int, default=None,
                        help="kept for parity with the JAX CLI; the ranks "
                             "are --num_processes, one per card")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 for a data-parallel run")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="ranks of the run, one per card")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda; "
                             "a rank takes its card, see parallel/mesh.py)")
    args = parser.parse_args(argv)

    resolve_device(args.device)
    device = args.device
    if args.coordinator is not None or (args.num_processes or 1) > 1:
        import torch.distributed as dist

        from arflow_tpu_torch.parallel import initialize_multihost, local_device

        if args.process_id is None and (args.num_processes or 1) > 1:
            raise ValueError("--num_processes > 1 needs --process_id")
        device = local_device(args.process_id or 0, args.device)
        initialize_multihost(args.coordinator, args.num_processes or 1,
                             args.process_id or 0, device=device)

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
    rank = 0
    if args.coordinator is not None or (args.num_processes or 1) > 1:
        # every rank writes into rank 0's save_root, named by rank 0's clock
        shared = [curr_time]
        dist.broadcast_object_list(shared, src=0)
        curr_time, rank = shared[0], dist.get_rank()
    cfg.save_root = os.path.join(
        "./outputs/checkpoints", curr_time[:6], curr_time[6:]
    )
    os.makedirs(cfg.save_root, exist_ok=True)

    log = init_logger(log_dir=cfg.save_root, filename=curr_time[6:] + (
        f"_rank{rank}.log" if rank else ".log"))
    log.info("=> will save everything to %s", cfg.save_root)
    log.info("=> configurations \n %s", pprint.pformat(cfg))
    return train_main(cfg, log, device=device)


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


def fit_penalty_cli(argv=None):
    """Fit a GMM penalty: sample data or smoothness residuals with the
    ground-truth flow of the config's dataset (its train set, else its
    first valid set; each sample needs ``flow`` and ``flow_bw``, as
    ``Chairs2``'s valid split has them), fit a K-component mixture by
    variational EM and print the ``(pi, beta)`` arrays for the config's
    ``penalty_{smooth,census}_{pi,beta}``, as the JAX package's
    ``fit_penalty_cli`` prints them. Returns ``{'samples', 'objectives',
    'pi', 'beta', 'scale', 'collect_s', 'em_s'}``."""
    parser = argparse.ArgumentParser(prog="arflow-torch-fit-penalty")
    parser.add_argument("-c", "--config", required=True,
                        help="training config providing data + loss sections")
    parser.add_argument("--penalty", choices=["data", "smooth"], default="smooth")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--n_iter", type=int, default=30)
    parser.add_argument("--n_samples", type=float, default=3e6)
    parser.add_argument("--subsample", type=float, default=0.95)
    parser.add_argument(
        "--init_vars", type=float, nargs="+",
        default=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from arflow_tpu_torch.data import DataLoader, get_dataset
    from arflow_tpu_torch.tools.penalty_em import (
        EM,
        abs_robust_loss_fwhm,
        collect_residuals,
        fwhm_scale,
        robust_l1_fwhm,
    )

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    train_set, valid_set = get_dataset(cfg, seed=cfg.get("seed", 0))
    dataset = train_set if train_set is not None else valid_set[0]
    loader = DataLoader(dataset, batch_size=cfg.train.get("batch_size", 4),
                        num_workers=cfg.train.get("workers", 2), shuffle=True)

    t0 = time.perf_counter()
    x0 = collect_residuals(loader, cfg.loss, penalty=args.penalty,
                           subsample=args.subsample,
                           n_samples=args.n_samples, device=dev)
    t1 = time.perf_counter()
    print(f"collected {x0.size} residual samples")
    em = EM(k=args.k, init_vars=args.init_vars, device=dev)
    objectives = em.fit(x0, n_iter=args.n_iter)
    for j, obj in enumerate(objectives):
        print(f"update {j}: objective {obj:.2f}")
    t2 = time.perf_counter()

    pi = em.state.pi.cpu().numpy()
    beta = em.state.beta.cpu().numpy()
    ref_fwhm = (abs_robust_loss_fwhm() if args.penalty == "data"
                else robust_l1_fwhm())
    scale = fwhm_scale(pi, np.zeros_like(pi), beta, ref_fwhm)
    print("Pi: ", pi.tolist())
    print("Beta: ", beta.tolist())
    print("Scaling factor: ", scale)
    print("Beta scaled: ", (beta * scale).tolist())
    return {"samples": int(x0.size), "objectives": objectives, "pi": pi,
            "beta": beta, "scale": float(scale), "collect_s": t1 - t0,
            "em_s": t2 - t1}


def _size(text):
    """``"HxW"`` -> (H, W)."""
    return tuple(int(v) for v in text.lower().split("x"))


def _checkpoint(parser, cfg, model):
    ckpt = model or cfg.get("inference", {}).get("pretrained_model")
    if not ckpt:
        parser.error("no checkpoint: pass -m or set inference.pretrained_model")
    return ckpt


def export_cli(argv=None):
    """Export the serving forward of a config and checkpoint to a
    ``torch.export`` artifact (``serving/export.py``): monolithic, or with
    ``--streaming`` the engine's pyramid and decoder programs. An artifact
    runs only on the device it was exported for (``--device``). Returns
    the header written."""
    parser = argparse.ArgumentParser(prog="arflow-torch-export")
    parser.add_argument("-c", "--config", required=True,
                        help="training/inference config (model + loss)")
    parser.add_argument("-m", "--model", default=None,
                        help="checkpoint (overrides cfg.inference.pretrained_model)")
    parser.add_argument("-o", "--output", required=True,
                        help="artifact file to write (e.g. model.afx)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--size", default="384x640",
                        help="HxW input size (default 384x640)")
    parser.add_argument("--device", default="cuda",
                        help="device the artifact runs on (default: cuda)")
    parser.add_argument("--streaming", action="store_true",
                        help="export the split pyramid+decoder programs "
                             "(one pyramid per frame; run with "
                             "arflow-torch-stream --artifact)")
    args = parser.parse_args(argv)

    from arflow_tpu_torch.models import load_pretrained
    from arflow_tpu_torch.serving.export import (
        export_inference,
        export_streaming,
        save_artifact,
        save_streaming_artifact,
    )

    resolve_device(args.device)
    cfg = load_config(args.config)
    ckpt = _checkpoint(parser, cfg, args.model)
    sd = load_pretrained(ckpt, cfg.model, device="cpu").state_dict()
    export, save = ((export_streaming, save_streaming_artifact) if args.streaming
                    else (export_inference, save_artifact))
    exported, meta = export(cfg, sd, args.batch, _size(args.size),
                            device=args.device)
    meta["checkpoint"] = str(ckpt)
    save(args.output, exported, meta)
    print(f"wrote {args.output}: {meta}")
    return meta


def stream_cli(argv=None):
    """Streaming video inference: one pyramid per frame, a ``.flo`` per
    pair. Frames are read in sorted order from ``--frames`` (a directory of
    PNG/PPM/JPEG files, or a glob); the flow of the pair (t-1, t) is
    written as ``<stem_t>.flo`` under ``--out`` (``<stem_t>_bw.flo`` with
    ``--bw``). Returns ``run_stream``'s statistics."""
    parser = argparse.ArgumentParser(prog="arflow-torch-stream")
    parser.add_argument("-c", "--config", default=None)
    parser.add_argument("-m", "--model", default=None)
    parser.add_argument("--artifact", default=None,
                        help="streaming artifact (arflow-torch-export "
                             "--streaming); replaces -c/-m")
    parser.add_argument("--frames", required=True,
                        help="directory of frames or a glob pattern")
    parser.add_argument("--out", default=None, help="output dir for .flo")
    parser.add_argument("--size", default=None,
                        help="HxW inference size (default: the frames' own; "
                             "an artifact uses its exported size)")
    parser.add_argument("--bw", action="store_true",
                        help="also compute the backward flow "
                             "(<stem>_bw.flo)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run -c/-m on (default: cuda)")
    args = parser.parse_args(argv)

    import glob

    from arflow_tpu_torch.serving.engine import StreamingFlowEngine, run_stream

    if args.artifact is None:
        if args.config is None:
            parser.error("pass --artifact or -c/--config")
        resolve_device(args.device)
        cfg = load_config(args.config)
        ckpt = _checkpoint(parser, cfg, args.model)
    if os.path.isdir(args.frames):
        paths = sorted(
            p for p in glob.glob(os.path.join(args.frames, "*"))
            if p.lower().endswith((".png", ".ppm", ".jpg", ".jpeg")))
    else:
        paths = sorted(glob.glob(args.frames))
    if len(paths) < 2:
        parser.error(f"need >=2 frames, found {len(paths)} in {args.frames}")

    size_hw = _size(args.size) if args.size else None
    if args.artifact is not None:
        from arflow_tpu_torch.serving.export import load_streaming_artifact

        engine = load_streaming_artifact(args.artifact)
        engine.with_bw = args.bw
        # The programs have static shapes: frames are resized to them.
        size_hw = (engine.meta["height"], engine.meta["width"])
    else:
        from arflow_tpu_torch.models import load_pretrained

        sd = load_pretrained(ckpt, cfg.model, device="cpu").state_dict()
        engine = StreamingFlowEngine(cfg.model, sd, with_bw=args.bw,
                                     device=args.device,
                                     loss_cfg=cfg.get("loss"))
    stats = run_stream(engine, paths, size_hw=size_hw, out_root=args.out)
    print(f"{stats['flows']} flows from {stats['frames']} frames: "
          f"{stats['flows_per_sec']:.2f} flows/s steady-state")
    return stats


def to_torch_cli(argv=None):
    """Convert the JAX package's checkpoint, a msgpack file or an orbax
    directory, into a reference-format ``.pth.tar`` (``{'epoch',
    'state_dict'}``), as ``arflow-to-torch`` writes it; ``load_pretrained``
    and the reference's strict ``load_state_dict`` read it. Needs neither
    flax nor a card; an orbax directory needs the ``tensorstore`` package.
    Returns the path written."""
    parser = argparse.ArgumentParser(prog="arflow-torch-to-torch")
    parser.add_argument("-c", "--config", required=True,
                        help="config naming the model family (cfg.model)")
    parser.add_argument("-m", "--model", required=True,
                        help="the JAX package's checkpoint (.msgpack) or "
                             "orbax directory (needs tensorstore)")
    parser.add_argument("-o", "--output", required=True,
                        help=".pth(.tar) file to write")
    args = parser.parse_args(argv)

    from arflow_tpu_torch.models.weights import jax_variables, save_torch_checkpoint
    from arflow_tpu_torch.training.checkpoint import (
        load_jax_checkpoint,
        load_orbax_checkpoint,
    )

    cfg = load_config(args.config)
    state = (load_orbax_checkpoint(args.model) if os.path.isdir(args.model)
             else load_jax_checkpoint(args.model))
    epoch = int(state.get("epoch", 0))
    save_torch_checkpoint(args.output, jax_variables(state), cfg.model,
                          epoch=epoch)
    print(f"wrote {args.output} (epoch {epoch}, model type {cfg.model.type})")
    return args.output


COMMANDS = {"train": train_cli, "inference": inference_cli,
            "evaluate-flo": evaluate_flo_cli, "export": export_cli,
            "stream": stream_cli, "fit-penalty": fit_penalty_cli,
            "to-torch": to_torch_cli}


def main(argv=None):
    """``python -m arflow_tpu_torch.cli <command> [options]``, a command of
    ``COMMANDS``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: python -m arflow_tpu_torch.cli "
                         f"{{{','.join(COMMANDS)}}} [options]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
