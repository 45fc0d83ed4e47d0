#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``arflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port from ``arflow_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version, runs UFlow 2-frame inference at the full width of
``configs/chairs_uflow.json`` (random weights from a seed), the 2-frame
streaming engine, training steps of that model and its ``UFlowLoss``
through ``UFlowTrainer``, and the entry points a user calls: ``train_main``
on a FlyingChairs-format directory (written here from a seed) with its
data pipeline, checkpoints and a resume, and ``inference_main`` writing
``.flo`` files; and the probabilistic UFlow path at Sintel's size: five
model setups of shipped configs with their entropy maps, the batch rate,
the stream with entropy, and ``inference_main`` plus ``evaluate_flo_cli``
on a Sintel-format tree; and ELBO training of that model: both kernels
at the ELBO step's level shapes, one step of four shipped ELBO setups
against the plain cost volume and float64, steps through
``UFlowElboTrainer``, and ``train_main`` with chairs_uflow_elbo.json with
validation, a resume and an overfit check; training of the mixture
weights net (chairs_uflow_elbo_mixture.json) and supervised MSE training
(chairs_uflow_mse.json at 384x512 b16): one step each against the plain
cost volume and float64, steps through their trainers, ``train_main`` with
a resume, the triangular solve's time; and the serving and tool entry
points: ``torch.export`` artifacts of the 384x640 b8 forward, its b1
streaming programs and setup (a) at 448x1024 b8 with its entropy, each
loaded in a fresh interpreter that imports no model code and held to the
eager model with 4 cost-volume launches per forward (phase export);
``stream_cli`` over 24 PNG frames with ``-c/-m``, ``--bw`` and
``--artifact`` held to ``StreamingFlowEngine.push`` (phase stream_cli);
``fit_penalty_cli`` for both penalties on a Chairs2-format directory
(phase fit_penalty); and the config switches: ``model.dtype`` bfloat16
(phase bf16: the 384x640 b8 forward beside float32 from one set of weights,
with the conv FLOPs and the top kernels of each, the kernel against the
plain cost volume behind the same float32 round trip, the round trip's
casts, setup (a) at 448x1024 b8 with its entropy, the b1 stream, an
artifact, and the uflow and ELBO (a) train steps beside float32) and the
trainer switches (phase train_switches: ``nan_revert`` on a NaN batch,
``remat`` against the plain step with level dropout on, with the peak
memory of each, and ``stage1``); and the PWC-Lite family (phase
pwclite_kernels: the forward kernel at every level shape of the PWCLite at
384x640 b8 and b1 and 448x1024 b1 and of the PWCLiteUflow at 384x640 b8;
pwclite_inference: ``pwclite``, ``pwclite_prob`` and ``pwclite_uflow`` at
384x640 b8 against the plain cost volume, timed and profiled, b1 forwards
with ``align_corners: false`` and ``warp_pad: border``, a bf16 forward;
pwclite_serving: the 3-frame window of ``StreamingFlowEngine`` over 12 b1
frames against the monolithic 3-frame forward, flows/s, and a 5-frame
forward against its windows; and in phase export the b8 ``pwclite``
artifact and the 3-frame streaming artifact); and the PWC-Lite family's
training (phase pwclite_train_kernels: both kernels at every level shape
of the pwclite and pwclite_uflow train steps at 256x448 b8;
pwclite_train: one step each of ``pwclite`` with the ``unflow`` loss,
``pwclite_uflow`` with ``fullres`` and ``pwclite_prob`` with ``elbo``
under injected noise against the plain cost volume and float64, 10 steps
of the first two through ``UFlowTrainer`` with the reference's AdamW,
timed and profiled, and ``train.remat``'s step; pwclite_cli:
``train_main`` with that configuration, validation EPE, a resume and an
overfit check); and the training input path (phase input_path, at
384x512: the native host library against the numpy hue and decode, the
host's ms per sample by stage with the hue in numpy and native, the
photometric augmentation on the card against the CPU's with its launches,
a ``uflow`` step and a resume with it, and bf16 ``train_main`` with each
of the three input paths). The ``train_main`` phases also check the image
summaries their validations write. It checks the outputs, and
times the kernels, the forwards, the streams, the train steps and the
entry points. Each phase prints
one JSON line; any failure raises and the script exits non-zero. It prints
the card's name and power limit (``nvidia-smi``) and ends with one line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

Imports nothing of JAX or of ``arflow_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import cProfile
import importlib
import importlib.util
import json
import logging
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from arflow_tpu_torch import Config, load_config, native
from arflow_tpu_torch.cli import (
    evaluate_flo_cli,
    fit_penalty_cli,
    inference_main,
    stream_cli,
    train_main,
)
from arflow_tpu_torch.data import Chairs, ConcatDataset
from arflow_tpu_torch.data import transforms as host_transforms
from arflow_tpu_torch.data.datasets import read_pnm
from arflow_tpu_torch.data.device_aug import make_photometric
from arflow_tpu_torch.data.get_dataset import get_dataset
from arflow_tpu_torch.data.loader import DataLoader
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.losses import blocks as elbo_blocks_module
from arflow_tpu_torch.losses import mse as mse_loss_module
from arflow_tpu_torch.losses import uflow as uflow_loss_module
from arflow_tpu_torch.models import get_model, load_pretrained
from arflow_tpu_torch.models import pwclite as pwclite_module
from arflow_tpu_torch.models import uflow as uflow_module
from arflow_tpu_torch.models import uflow_prob as uflow_prob_module
from arflow_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from arflow_tpu_torch.ops.cuda.build import build, build_log
from arflow_tpu_torch.ops.cuda.cost_volume import (
    COST_VOLUME,
    COST_VOLUME_BWD,
    compute_cost_volume_reference,
    cost_volume_blocks,
    cost_volume_grad_blocks,
    cost_volume_grad_kernel,
    cost_volume_grad_reference,
    cost_volume_kernel,
)
from arflow_tpu_torch.ops.triag import backward_substitution, inverse_diagonal
from arflow_tpu_torch.serving import StreamingFlowEngine
from arflow_tpu_torch.serving.export import (
    export_inference,
    export_streaming,
    save_artifact,
    save_streaming_artifact,
)
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.checkpoint import load_checkpoint
from arflow_tpu_torch.training.entropy import extract_uv_entropy
from arflow_tpu_torch.training.trainer import BaseTrainer
from arflow_tpu_torch.training.mse_trainer import MseTrainer
from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer
from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer
from arflow_tpu_torch.utils.flow_io import read_flo, write_flo
from arflow_tpu_torch.utils.metrics import evaluate_flow

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow.json")
SEED = 0
B, H, W = 8, 384, 640  # inference cell: 384x640, batch 8, float32
TB, TH, TW = 8, 256, 448  # train cell: 256x448, batch 8, float32
TRAIN_STEPS = 20
STREAM_FRAMES = 12
MD = 4
# cli cell: FlyingChairs' own 384x512, the config's batch 8; fids 6 and 18
# are the valid split, so 30 train pairs make 3 batches with drop_last.
CH, CW = 384, 512
CLI_PAIRS = 32
CLI_EPOCHS = 2
CLI_LONG_REPEATS = 5  # a further epoch over the train pairs 5 times: 18 steps

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): memory
# 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Kernel against plain: float32 sums over C in another order than the plain
# version's mean; a few ulp of the partial sums at C=32.
KERNEL_ATOL = 5e-6
# Backward kernel against plain, relative to the largest gradient value: the
# same float32 products summed over k with one division by C at the end,
# where the plain version divides each term; a few ulp.
GRAD_RTOL = 1e-5
# Flows through 4 decoder levels from cost volumes that differ by the
# above, relative to the largest flow value of the run.
FLOW_RTOL = 1e-4
# One train step with the kernels against the plain cost volume, forward
# and backward, with cuDNN's deterministic algorithms. Two float32 models
# round differently, and a parameter whose gradient sums terms that nearly
# cancel (a decoder bias) shows it: kernel and plain differ by up to 1.6e-3
# of such a gradient's norm, while two runs of one model agree within
# 1e-6. So both are held to the plain model in float64: per parameter and
# over all together, the kernel model's relative L2 error must be at most
# twice the plain float32 model's, plus 1e-5; and the two float32 models'
# gradients over all parameters, and their losses, must agree within the
# tolerances below.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# The mixture weights net's BatchNorm running statistics after that step,
# kernel model against plain model (relative L2 per buffer).
BN_STATS_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds per call of ``fn``: CUDA events around
    replays of a CUDA graph that holds ``launches`` calls, so the host's
    time per call (Python, ctypes) is not in it, as it is in ``cuda_ms``
    when the host is slower than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def profile_window(fn, n: int, untraced_ms: float, groups=None) -> dict:
    """Where the device time of ``n`` calls of ``fn`` goes (torch.profiler):
    kernel time per call, the top kernels by it, and the device's busy
    share against ``untraced_ms``, the call's time without the profiler
    (whose own host overhead inflates the traced wall time). ``groups``
    maps a label to the names of profiler events (operators or
    ``record_function`` ranges) whose device time, children included, is
    reported per call under ``<label>_ms`` and as a share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # A record_function range (ours, or the optimizer's step) also shows on
    # the device timeline as an annotation; it is no kernel.
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if not dev_ms > 0:
        raise RuntimeError("the profiler recorded no device time")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    cv_ms = {part: sum(e.self_device_time_total for e in kernels
                       if f"cost_volume{part}_kernel" in e.key) / 1e3 / n
             for part in ("_fwd", "_bwd")}
    # Device time under the cuDNN (transposed) convolution ops.
    conv_ms = sum(e.device_time_total for e in events
                  if e.key in ("aten::cudnn_convolution",
                               "aten::cudnn_convolution_transpose")) / 1e3 / n
    out = {"device_ms_per_call": dev_ms, "untraced_ms_per_call": untraced_ms,
           "busy_share": dev_ms / untraced_ms,
           "kernel_launches_per_call": sum(e.count for e in kernels) / n,
           "cost_volume_ms_per_call": cv_ms["_fwd"] + cv_ms["_bwd"],
           "cost_volume_fwd_ms_per_call": cv_ms["_fwd"],
           "cost_volume_bwd_ms_per_call": cv_ms["_bwd"],
           "cost_volume_fwd_share": cv_ms["_fwd"] / dev_ms,
           "cost_volume_bwd_share": cv_ms["_bwd"] / dev_ms,
           "conv_ms_per_call": conv_ms,
           "top_kernels": [[e.key[:96], e.count / n,
                            e.self_device_time_total / 1e3 / n]
                           for e in kernels[:10]]}
    for label, names in (groups or {}).items():
        ms = sum(e.device_time_total for e in events
                 if e.key in names and e.device_type == DeviceType.CPU) / 1e3 / n
        out[f"{label}_ms"] = ms
        out[f"{label}_share"] = ms / dev_ms
    return out


def texture(n, h, w, gen, dev):
    """Smooth random RGB texture in [0, 1], (n, 3, h, w)."""
    base = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                      device=dev)
    return F.interpolate(base, size=(h, w), mode="bicubic",
                         align_corners=False).clamp_(0.0, 1.0)


def shifted_pair(n, h, w, dy, dx, gen, dev):
    """NHWC pair: a texture and its copy moved by (dy, dx) pixels."""
    m = 16
    tex = texture(n, h + 2 * m, w + 2 * m, gen, dev)
    a = tex[:, :, m:m + h, m:m + w]
    b = tex[:, :, m - dy:m - dy + h, m - dx:m - dx + w]
    return (a.permute(0, 2, 3, 1).contiguous(),
            b.permute(0, 2, 3, 1).contiguous())


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def rel_l2(a, b) -> float:
    return float((a.double() - b).norm() / b.norm().clamp_min(1e-300))


def cost_volume_bound_ms(b, c, h, w, md=MD):
    """Least time on the card: f1, f2 read once and the output written once
    (bytes), or 2*C multiply-adds per displacement (float32 operations)."""
    k = (2 * md + 1) ** 2
    nbytes = 4 * b * h * w * (2 * c + k)
    flops = 2 * b * h * w * c * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def phase_device():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    line = smi_line()
    emit({"phase": "device", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return line


def demangle(name: str) -> str:
    """``kernel<4, true>`` for an Itanium-mangled template kernel whose
    template arguments are ints and bools; other names as they are."""
    head, sep, tail = name.partition("IL")
    args = re.findall(r"L([ib])(\d+)E", sep + tail)
    for m in re.finditer(r"\d+", head):
        for j in range(m.start(), m.end()):
            if int(head[j:m.end()]) == len(head) - m.end() and args:
                return head[m.end():] + "<" + ", ".join(
                    v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in args) + ">"
    return name


def ptxas_entries(log: str) -> list:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: its name, registers,
    spills and the 'Used' line."""
    entries = []
    for chunk in log.split("Compiling entry function '")[1:]:
        used = re.search(r"Used (\d+) registers.*", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        entries.append({"entry": demangle(chunk.split("'", 1)[0]),
                        "registers": int(used.group(1)) if used else None,
                        "spill_stores": int(spill.group(1)) if spill else None,
                        "spill_loads": int(spill.group(2)) if spill else None,
                        "used": used.group(0) if used else None})
    return entries


def phase_build():
    """One nvcc per source, all started together."""
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip((k.name for k in KERNELS),
                        pool.map(build, (k.name for k in KERNELS))))
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": {n: os.path.relpath(p, REPO) for n, p in libs.items()},
          "ptxas": {k.name: ptxas_entries(build_log(k.name)) for k in KERNELS}})


def level_shapes(b, h=H, w=W):
    """The cost volume's (B, C, H, W) at UFlow levels 1-4 of an hxw input."""
    return [(b, 32, h // 2 ** (lv + 1), w // 2 ** (lv + 1)) for lv in (1, 2, 3, 4)]


def cost_volume_grad_bound_ms(b, c, h, w, md=MD):
    """Least time on the card for both gradients: g, f1 and f2 read once,
    the two gradients written once (bytes), or 2*2 multiply-adds per
    displacement and channel (float32 operations)."""
    k = (2 * md + 1) ** 2
    nbytes = 4 * b * h * w * (k + 4 * c)
    flops = 2 * 2 * b * h * w * c * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


# Ragged shapes, (B,C,H,W), md, offset in floats from a 16-byte aligned
# allocation: C not a multiple of the channel chunk, W not a multiple of 4,
# maps smaller than md, md 1-3, inputs one or two floats off alignment; and
# shapes that cross the backward kernel's tiles and 32-channel block (W =
# 65, 63, 66 and 68, H = 5 and 9, C = 33 and 9).
RAGGED = [((3, 20, 13, 37), MD, 0), ((1, 32, 2, 3), MD, 0),
          ((2, 32, 1, 1), MD, 0), ((2, 3, 6, 6), 1, 0),
          ((2, 5, 9, 16), 2, 0), ((1, 7, 11, 3), 3, 0),
          ((1, 32, 12, 20), MD, 1),
          ((2, 33, 5, 65), MD, 0), ((1, 9, 5, 63), MD, 0),
          ((2, 33, 5, 68), MD, 0), ((1, 9, 5, 63), 1, 0),
          ((2, 33, 5, 65), 2, 0), ((1, 9, 6, 63), 3, 0),
          ((1, 32, 12, 20), MD, 2), ((8, 9, 9, 65), MD, 0),
          ((8, 33, 9, 66), 2, 0)]


def randn_at(shape, offset, gen, dev):
    n = torch.Size(shape).numel()
    return torch.randn(n + offset, generator=gen, device=dev)[offset:].view(shape)


def check_forward(checks, gen, dev) -> float:
    """The forward kernel against its plain version at each (shape, md,
    offset) of ``checks``; the largest error."""
    max_err = 0.0
    for shape, md, offset in checks:
        f1 = randn_at(shape, offset, gen, dev)
        f2 = randn_at(shape, offset, gen, dev)
        out = cost_volume_kernel(f1, f2, md)
        torch.cuda.synchronize()
        err = max_abs(out, compute_cost_volume_reference(f1, f2, md))
        emit({"phase": "kernel_check", "kernel": "cost_volume", "shape": shape,
              "md": md, "aligned16": f1.data_ptr() % 16 == 0,
              "blocks": cost_volume_blocks(shape, md),
              "max_abs_err": err, "atol": KERNEL_ATOL})
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"cost_volume {shape} md={md}: err {err} > {KERNEL_ATOL}")
        max_err = max(max_err, err)
    return max_err


def time_forward(levels, gen, dev, smi) -> dict:
    """``kernel_time`` rows of the forward kernel at each cell's level
    shapes: graph-timed and eager kernel, plain version, bound."""
    per_level = {key: [] for key in levels}
    for key, shapes in levels.items():
        for level, shape in enumerate(shapes, 1):
            f1 = torch.randn(shape, generator=gen, device=dev)
            f2 = torch.randn(shape, generator=gen, device=dev)
            ms = graph_ms(lambda: cost_volume_kernel(f1, f2, MD))
            eager_ms = cuda_ms(lambda: cost_volume_kernel(f1, f2, MD), iters=200)
            plain_ms = cuda_ms(lambda: compute_cost_volume_reference(f1, f2, MD),
                               iters=10)
            bound_ms, bound_by, nbytes = cost_volume_bound_ms(*shape)
            row = {"level": level, "batch": shape[0], "shape": shape,
                   "blocks": cost_volume_blocks(shape, MD), "ms": ms,
                   "eager_ms": eager_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                   "share_of_bound": bound_ms / ms, "library_ms": None}
            per_level[key].append(row)
            emit({"phase": "kernel_time", "kernel": "cost_volume", "cell": key,
                  **row, "card": smi})
    return per_level


def phase_kernels(dev, smi):
    """The forward kernel against its plain version, then timed, at the
    shapes the main paths give it: the four UFlow levels at 384x640, batch
    8 (2-frame inference) and batch 1 (one streamed flow), and at 256x448,
    batch 8 (training; W = 112 ... 14, where 14 takes the 4-byte copies);
    and checked at the levels of the cli phase's 384x512 b8 and at the
    ragged shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = {"b8": level_shapes(B), "b1": level_shapes(1),
              "train": level_shapes(TB, TH, TW)}
    checks = ([(shape, MD, 0) for shapes in levels.values() for shape in shapes]
              + [(shape, MD, 0) for shape in level_shapes(TB, CH, CW)]
              + RAGGED)
    return check_forward(checks, gen, dev), time_forward(levels, gen, dev, smi)


def check_grad(checks, gen, dev):
    """The backward kernel against its plain version at each (shape, md,
    offset) of ``checks``, both gradients and each alone; the largest error
    and the inputs of the aligned md=MD shapes."""
    max_err = 0.0
    inputs = {}
    for shape, md, offset in checks:
        b, _, h, w = shape
        f1 = randn_at(shape, offset, gen, dev)
        f2 = randn_at(shape, offset, gen, dev)
        g = randn_at((b, (2 * md + 1) ** 2, h, w), offset, gen, dev)
        both = cost_volume_grad_kernel(g, f1, f2, md)
        only1, _ = cost_volume_grad_kernel(g, f1, f2, md, True, False)
        _, only2 = cost_volume_grad_kernel(g, f1, f2, md, False, True)
        torch.cuda.synchronize()
        ref = cost_volume_grad_reference(g, f1, f2, md)
        err = max(max_abs(x, r) for x, r in zip(both, ref))
        scale = max(float(r.abs().max()) for r in ref)
        alone = max(max_abs(only1, both[0]), max_abs(only2, both[1]))
        tol = GRAD_RTOL * scale
        emit({"phase": "kernel_check", "kernel": "cost_volume_bwd",
              "shape": shape, "md": md, "aligned16": f1.data_ptr() % 16 == 0,
              "blocks": cost_volume_grad_blocks(shape, md),
              "max_abs_err": err, "max_abs_grad": scale, "atol": tol,
              "each_alone_vs_both": alone})
        if not (err <= tol and alone == 0.0):
            raise AssertionError(f"cost_volume_bwd {shape} md={md}: err {err} "
                                 f"> {tol} or alone differs by {alone}")
        max_err = max(max_err, err)
        if offset == 0 and md == MD:
            inputs[shape] = (g, f1, f2)
    return max_err, inputs


def time_grad(shapes, inputs, smi, cell) -> list:
    """``kernel_time`` rows of the backward kernel at a cell's level
    shapes: graph-timed and eager kernel, plain version, bound."""
    rows = []
    for level, shape in enumerate(shapes, 1):
        g, f1, f2 = inputs[shape]
        ms = graph_ms(lambda: cost_volume_grad_kernel(g, f1, f2, MD))
        eager_ms = cuda_ms(lambda: cost_volume_grad_kernel(g, f1, f2, MD),
                           iters=100)
        plain_ms = cuda_ms(lambda: cost_volume_grad_reference(g, f1, f2, MD),
                           iters=5)
        bound_ms, bound_by, nbytes = cost_volume_grad_bound_ms(*shape)
        row = {"level": level, "batch": shape[0], "shape": shape,
               "blocks": cost_volume_grad_blocks(shape, MD), "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "share_of_bound": bound_ms / ms, "library_ms": None}
        rows.append(row)
        emit({"phase": "kernel_time", "kernel": "cost_volume_bwd", "cell": cell,
              **row, "card": smi})
    return rows


def phase_grad_kernels(dev, smi):
    """The backward kernel against its plain version at the training level
    shapes of 256x448 b8 (the main path), the b8 levels of 384x640 and of
    the cli phase's 384x512, and the ragged shapes, both gradients and each
    alone; then timed at the training levels."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    train_levels = level_shapes(TB, TH, TW)
    checks = ([(shape, MD, 0) for shape in
               train_levels + level_shapes(B) + level_shapes(TB, CH, CW)]
              + RAGGED)
    max_err, inputs = check_grad(checks, gen, dev)
    return max_err, time_grad(train_levels, inputs, smi, "train")


def phase_inference(cfg, dev, smi):
    """The main path: full-width UFlow 2-frame inference, 384x640 b8."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = get_model(cfg.model, device=dev, seed=SEED)
    img1, img2 = shifted_pair(B, H, W, 2, 3, gen, dev)
    with torch.inference_mode():
        reset_launch_counts()
        res = model(img1, img2, with_bk=False)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        flows = res["flows_fw"]
        shapes = [tuple(f.shape) for f in flows]
        want = [(B, H // 2 ** i, W // 2 ** i, 2) for i in range(6)]
        if shapes != want:
            raise AssertionError(f"flow shapes {shapes} != {want}")
        if not all(bool(torch.isfinite(f).all()) for f in flows):
            raise AssertionError("non-finite flow")
        if launches["cost_volume"] != 4:
            raise AssertionError(f"cost_volume launched {launches} times, not 4")

        # The same model with the plain cost volume, swapped in explicitly.
        with mock.patch.object(uflow_module, "compute_cost_volume",
                               compute_cost_volume_reference):
            ref = model(img1, img2, with_bk=False)["flows_fw"]
        torch.cuda.synchronize()
        if COST_VOLUME.launches != 4:
            raise AssertionError("the plain run launched the kernel")
        scale = float(ref[0].abs().max())
        err = max_abs(flows[0], ref[0])
        tol = FLOW_RTOL * max(scale, 1.0)
        emit({"phase": "inference", "shape": [B, H, W], "launches": launches,
              "flow_shapes": shapes, "max_abs_flow": scale,
              "flow0_vs_plain_max_abs_err": err, "atol": tol})
        if not err <= tol:
            raise AssertionError(f"flows[0] kernel vs plain: {err} > {tol}")

        # A small input against the same weights on the CPU, whose plain
        # path the CPU tests hold to the JAX package.
        a, b = shifted_pair(1, 64, 96, 1, 2, gen, dev)
        cpu_model = get_model(cfg.model, device="cpu", seed=SEED)
        small = model(a, b, with_bk=True)
        small_cpu = cpu_model(a.cpu(), b.cpu(), with_bk=True)
        err_small = max(max_abs(x.cpu(), y)
                        for key in ("flows_fw", "flows_bw")
                        for x, y in zip(small[key], small_cpu[key]))
        scale_small = max(float(y.abs().max()) for y in small_cpu["flows_fw"])
        tol_small = FLOW_RTOL * max(scale_small, 1.0)
        emit({"phase": "inference_small_vs_cpu", "shape": [1, 64, 96],
              "max_abs_err": err_small, "atol": tol_small})
        if not err_small <= tol_small:
            raise AssertionError(f"cuda vs cpu at 64x96: {err_small} > {tol_small}")

        ms = cuda_ms(lambda: model(img1, img2, with_bk=False), iters=20)
        emit({"phase": "inference_time", "shape": [B, H, W], "dtype": "float32",
              "ms_per_batch": ms, "maps_per_s": B / (ms / 1e3), "card": smi})
        emit({"phase": "inference_profile", "shape": [B, H, W],
              **profile_window(lambda: model(img1, img2, with_bk=False), 3, ms),
              "card": smi})
    return model, launches


def phase_serving(cfg, model, dev, smi):
    """2-frame streaming, b1: one pyramid per frame, flows equal to the
    monolithic forward on the same pair."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    m = 4 * STREAM_FRAMES
    tex = texture(1, H + m, W + m, gen, dev)
    seq = [tex[:, :, 2 * t:2 * t + H, 3 * t:3 * t + W].permute(0, 2, 3, 1).contiguous()
           for t in range(STREAM_FRAMES)]
    state = model.state_dict()
    counts = {}
    for with_bw in (False, True):
        engine = StreamingFlowEngine(cfg.model, state, with_bw=with_bw, device=dev)
        reset_launch_counts()
        outs = [engine.push(f) for f in seq]
        torch.cuda.synchronize()
        counts[with_bw] = COST_VOLUME.launches
        flows = [o for o in outs if o is not None]
        if outs[0] is not None or len(flows) != STREAM_FRAMES - 1:
            raise AssertionError("streaming: wrong number of outputs")
        if engine.pyramids_computed != STREAM_FRAMES:
            raise AssertionError(f"{engine.pyramids_computed} pyramids computed")
        want = 4 * (STREAM_FRAMES - 1) * (2 if with_bw else 1)
        if counts[with_bw] != want:
            raise AssertionError(f"streaming launched the kernel {counts[with_bw]} "
                                 f"times, not {want}")
        err, scale = 0.0, 1.0
        with torch.inference_mode():
            for t, out in enumerate(flows):
                mono = model(seq[t], seq[t + 1], with_bk=with_bw)
                err = max(err, max_abs(out["flow"], mono["flows_fw"][0]))
                scale = max(scale, float(mono["flows_fw"][0].abs().max()))
                if with_bw:
                    err = max(err, max_abs(out["flow_bw"], mono["flows_bw"][0]))
        tol = FLOW_RTOL * scale
        emit({"phase": "serving", "with_bw": with_bw, "frames": STREAM_FRAMES,
              "flows": len(flows), "pyramids": engine.pyramids_computed,
              "launches": counts[with_bw], "vs_monolithic_max_abs_err": err,
              "atol": tol})
        if not all(bool(torch.isfinite(o["flow"]).all()) for o in flows):
            raise AssertionError("non-finite streaming flow")
        if not err <= tol:
            raise AssertionError(f"streaming vs monolithic: {err} > {tol}")

    engine = StreamingFlowEngine(cfg.model, state, device=dev)
    for f in seq[:3]:  # warm-up
        engine.push(f)
    torch.cuda.synchronize()
    rounds = 5
    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in seq:
            engine.push(f)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = rounds * STREAM_FRAMES
    emit({"phase": "serving_time", "shape": [1, H, W], "flows": n,
          "seconds": dt, "flows_per_s": n / dt, "card": smi})
    frames = iter(seq * 2)
    emit({"phase": "serving_profile", "shape": [1, H, W],
          **profile_window(lambda: engine.push(next(frames)), STREAM_FRAMES,
                           1e3 * dt / n),
          "card": smi})
    return counts


class RecordingTrainer(UFlowTrainer):
    """Keeps each step's metric row (total, l_ph, l_sm, flow_mean)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rows = []

    def _queue_step_metrics(self, metrics, *args):
        self.rows.append(metrics)
        super()._queue_step_metrics(metrics, *args)


def named_range(name, fn):
    """``fn`` inside a profiler range named ``name``."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def phase_train(cfg, dev, smi):
    """The training path: the chairs_uflow.json model (level dropout 0.1)
    and UFlowLoss at full width, 256x448 b8, float32, Adam, through the
    port's UFlowTrainer. The config sets no smooth_order, on which the loss
    (like the JAX one) has no default; 1 is set here, as the JAX package's
    bench.py does for its train step."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    loss_cfg = cfg.loss.copy()
    loss_cfg.smooth_order = 1
    loss = get_loss(loss_cfg)
    model = get_model(cfg.model, device=dev, seed=SEED)
    # Seeded textures and copies moved by a few pixels; the _ph images are
    # a fixed photometric change of them (tests/test_training_e2e.py).
    batches = []
    for dy, dx in ((1, 2), (2, -3), (-3, 1), (4, 4)):
        a, b = shifted_pair(TB, TH, TW, dy, dx, gen, dev)
        batches.append({"img1": a, "img2": b,
                        "img1_ph": (a * 1.1).clamp(0.0, 1.0),
                        "img2_ph": (b * 1.1).clamp(0.0, 1.0)})
    x = batches[0]

    # One step's loss and gradients, kernels against the plain cost volume
    # (forward and backward by autograd through its shifted products), with
    # the same dropout draws.
    drop = torch.Generator(device=dev).manual_seed(SEED)
    draws = drop.get_state()

    def step_grads(net, inputs, plain: bool):
        drop.set_state(draws)
        net.zero_grad(set_to_none=True)
        swap = (mock.patch.object(uflow_module, "compute_cost_volume",
                                  compute_cost_volume_reference)
                if plain else contextlib.nullcontext())
        with swap:
            res = net(inputs["img1_ph"], inputs["img2_ph"], with_bk=True,
                      train=True, generator=drop)
            out = loss(res, inputs["img1"], inputs["img2"])
            out["total"].backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()
                 if p.grad is not None}
        net.zero_grad(set_to_none=True)
        return float(out["total"].detach()), grads

    torch.backends.cudnn.deterministic = True
    reset_launch_counts()
    total, grads = step_grads(model, x, False)
    step_launches = {k.name: k.launches for k in KERNELS}
    total_again, grads_again = step_grads(model, x, False)
    total_plain, grads_plain = step_grads(model, x, True)
    total64, grads64 = step_grads(
        copy.deepcopy(model).double(),
        {k: v.double() for k, v in x.items()}, True)
    torch.backends.cudnn.deterministic = False
    if COST_VOLUME.launches != 16 or COST_VOLUME_BWD.launches != 16:
        raise AssertionError("the plain runs launched a kernel")
    if not (sorted(grads) == sorted(grads_again) == sorted(grads_plain)
            == sorted(grads64)):
        raise AssertionError("different parameters have gradients")

    def cat(g):
        return torch.cat([g[n].flatten().double() for n in sorted(g)])

    err64 = {n: (rel_l2(grads[n], grads64[n]), rel_l2(grads_plain[n], grads64[n]))
             for n in grads}
    err64["all"] = (rel_l2(cat(grads), cat(grads64)),
                    rel_l2(cat(grads_plain), cat(grads64)))
    over = {n: e for n, e in err64.items() if e[0] > 2 * e[1] + 1e-5}
    worst = sorted(err64.items(), key=lambda kv: -kv[1][0])[:5]
    grad_err = rel_l2(cat(grads), cat(grads_plain))
    loss_err = abs(total - total_plain) / abs(total_plain)
    emit({"phase": "train_step_check", "shape": [TB, TH, TW],
          "launches": step_launches, "params_with_grad": len(grads),
          "loss": total, "loss_plain": total_plain, "loss_plain_f64": total64,
          "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_rel_l2_vs_plain": grad_err, "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_rel_l2_vs_f64": err64["all"][0],
          "plain_grad_rel_l2_vs_f64": err64["all"][1],
          "kernel_run_to_run_loss_rel": abs(total - total_again) / abs(total),
          "kernel_run_to_run_grad_rel_l2": rel_l2(cat(grads), cat(grads_again)),
          "worst_params_vs_f64_kernel_and_plain": worst,
          "params_over_tolerance": over})
    if step_launches != {"cost_volume": 8, "cost_volume_bwd": 8}:
        raise AssertionError(f"a train step launched {step_launches}, not 8 + 8")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL
            and not over):
        raise AssertionError(f"train step kernels vs plain: loss {loss_err}, "
                             f"gradients {grad_err}, parameters {over}")

    # TRAIN_STEPS steps through UFlowTrainer.train() on an in-memory list:
    # one epoch (the config's 400 cut to 1) of TRAIN_STEPS batches.
    train_cfg = cfg.train.copy()
    train_cfg.epoch_num = 1
    if get_trainer(cfg.trainer) is not UFlowTrainer:
        raise AssertionError(f"{CONFIG} names trainer {cfg.trainer!r}")
    trainer = RecordingTrainer(
        [batches[i % len(batches)] for i in range(TRAIN_STEPS)], None, model,
        loss, logging.getLogger("chip_smoke"),
        os.path.join(REPO, "outputs", "chip_smoke"), train_cfg,
        model_cfg=cfg.model, full_cfg=cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    rows = torch.stack(trainer.rows).cpu()
    emit({"phase": "train", "shape": [TB, TH, TW], "steps": trainer.i_iter,
          "seconds_incl_first_steps": seconds, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "losses": rows[:, 0].tolist(), "l_ph": rows[:, 1].tolist(),
          "l_sm": rows[:, 2].tolist(), "flow_mean": rows[:, 3].tolist()})
    if trainer.i_iter != TRAIN_STEPS or len(rows) != TRAIN_STEPS:
        raise AssertionError(f"{trainer.i_iter} steps, not {TRAIN_STEPS}")
    if not bool(torch.isfinite(rows).all()):
        raise AssertionError("non-finite training metrics")
    want = 8 * TRAIN_STEPS
    if launches != {"cost_volume": want, "cost_volume_bwd": want}:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {launches}, "
                             f"not {want} + {want}")

    def one_step():
        trainer.train_step(x["img1"], x["img2"], x["img1_ph"], x["img2_ph"])

    ms = cuda_ms(one_step, iters=10, warmup=2)
    emit({"phase": "train_time", "shape": [TB, TH, TW], "dtype": "float32",
          "ms_per_step": ms, "steps_per_s": 1e3 / ms,
          "samples_per_s": TB * 1e3 / ms, "card": smi})
    emit({"phase": "train_profile", "shape": [TB, TH, TW],
          **train_step_profile(one_step, ms), "card": smi})
    return launches


def train_step_profile(one_step, ms,
                       census=(uflow_loss_module, "census_loss"),
                       ranges=None, extra_groups=None) -> dict:
    """``profile_window`` over 3 train steps, with the device time of the
    convolutions (forward, backward), the census forward (the function
    ``census`` names, in its module), the range map and the
    ``grid_sample`` backward; of each function of ``ranges`` ({label:
    (module, name)}), called in a profiler range of that label; and of
    the events of ``extra_groups``."""
    groups = {
        "conv_fwd": ("aten::cudnn_convolution",
                     "aten::cudnn_convolution_transpose"),
        "conv_bwd": ("aten::convolution_backward",),
        "census_fwd": ("census_loss",),
        "range_map": ("aten::index_add",),
        # cuDNN's sampler where it takes the call (bilinear, zeros,
        # align_corners), ATen's otherwise.
        "grid_sample_bwd": ("aten::cudnn_grid_sampler_backward",
                            "aten::grid_sampler_2d_backward"),
    }
    wrap = {"census_loss": census} if census else {}
    for label, target in (ranges or {}).items():
        groups[label] = (label,)
        wrap[label] = target
    groups.update(extra_groups or {})
    with contextlib.ExitStack() as stack:
        for label, (module, name) in wrap.items():
            stack.enter_context(mock.patch.object(
                module, name, named_range(label, getattr(module, name))))
        return profile_window(one_step, 3, ms, groups)


def write_ppm(path, img) -> None:
    """(H, W, 3) uint8 -> binary PPM (P6), written with numpy."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img).tobytes())


def write_chairs_dir(root, dev, pairs=CLI_PAIRS) -> int:
    """``pairs`` FlyingChairs-format pairs at CH x CW in ``root``: img1 a
    smooth seeded texture, img2 the same texture moved by a per-pair
    (dy, dx) in [-4, 4], and the .flo that shift, (u, v) = (dx, dy).
    Returns the bytes written."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for fid in range(1, pairs + 1):
        dy, dx = (3 * fid) % 9 - 4, (5 * fid) % 9 - 4
        pair = shifted_pair(1, CH, CW, dy, dx, gen, dev)
        for i, img in enumerate(pair, 1):
            px = (img[0] * 255).round().to(torch.uint8).cpu().numpy()
            write_ppm(os.path.join(root, f"{fid:05d}_img{i}.ppm"), px)
        write_flo(os.path.join(root, f"{fid:05d}_flow.flo"),
                  np.tile(np.float32([dx, dy]), (CH, CW, 1)))
    return sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))


def cli_config(root, save_root, epochs, resume=None):
    """``configs/chairs_uflow.json`` with both data roots at ``root``, the
    loss's smooth_order set to 1 (as in the train phase), and ``epochs``
    epochs that each validate and save; the rest (hflip, hue 0.5, swapped
    channels, batch 8, Adam, 4 workers) as the config has it."""
    cfg = load_config(CONFIG)
    for entry in cfg.data:
        entry.root_chairs = root
    cfg.loss.smooth_order = 1
    cfg.save_root = save_root
    cfg.train.update(epoch_num=epochs, valid_freq=1, save_iter=0)
    if resume is not None:
        cfg.train.resume = resume
    return cfg


class PerSampleDraws:
    """The augmentation's draws as a function of the sample, not of the
    loader threads' order: a stand-in for the ``RandomState`` that
    ``get_dataset`` shares among the transforms. With the shared one, which
    sample gets which draws depends on the order in which the threads reach
    it, and the short runs' losses swing with it (PERF.md). Here each
    outermost ``ConcatDataset`` lookup seeds its thread's own
    ``RandomState`` from (seed, index, the times that dataset has served the
    index) and the transforms draw from it; outside a lookup they draw from
    one ``RandomState(seed)``."""

    def __init__(self, seed):
        self.base_seed = seed
        self._local = threading.local()
        self._lock = threading.Lock()
        self._served = weakref.WeakKeyDictionary()
        self._fallback = np.random.RandomState(seed)

    def __getattr__(self, name):
        rng = getattr(self._local, "rng", None)
        return getattr(self._fallback if rng is None else rng, name)

    @contextlib.contextmanager
    def active(self):
        draws = self
        get_item = ConcatDataset.__getitem__
        factory = importlib.import_module("arflow_tpu_torch.data.get_dataset")
        geometric = factory.get_geometric_transforms
        photometric = factory.get_photometric_transforms

        def seeded_get_item(dataset, idx):
            if getattr(draws._local, "rng", None) is not None:  # nested
                return get_item(dataset, idx)
            with draws._lock:
                served = draws._served.setdefault(dataset, collections.Counter())
                n = served[int(idx)]
                served[int(idx)] += 1
            draws._local.rng = np.random.RandomState([draws.base_seed, int(idx), n])
            try:
                return get_item(dataset, idx)
            finally:
                draws._local.rng = None

        with mock.patch.object(ConcatDataset, "__getitem__", seeded_get_item), \
                mock.patch.object(factory, "get_geometric_transforms",
                                  lambda cfg, rng=None: geometric(cfg, draws)), \
                mock.patch.object(factory, "get_photometric_transforms",
                                  lambda cfg, rng=None: photometric(cfg, draws)):
            yield


class EntryPointProbe:
    """While active: each train step's iteration, metric row and the
    trainer's own data and batch laps (``am_data_time``, ``am_batch_time``);
    each wait of a loader's consumer for a batch; and the synchronized wall
    time of each validation and each checkpoint save, of ``trainer_cls``
    and its subclasses."""

    def __init__(self, trainer_cls=UFlowTrainer):
        self.trainer_cls = trainer_cls
        self.steps, self.waits = [], []
        self.seconds = {"_validate_with_gt": [], "save_model": []}

    @contextlib.contextmanager
    def active(self):
        probe, cls = self, self.trainer_cls
        queue = cls._queue_step_metrics
        loader_iter = DataLoader.__iter__

        def queue_step(trainer, metrics, batch_size, i_step, *rest):
            am_batch_time, am_data_time = rest[-2:]
            probe.steps.append({"i_iter": trainer.i_iter, "i_step": i_step,
                                "metrics": metrics,
                                "data_s": am_data_time.val[0],
                                "batch_s": am_batch_time.val[0]})
            return queue(trainer, metrics, batch_size, i_step, *rest)

        def timed_iter(loader):
            batches = loader_iter(loader)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    return
                probe.waits.append((loader.shuffle, time.perf_counter() - t0))
                yield batch

        def timed(name):
            method = getattr(cls, name)

            def wrapped(trainer, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = method(trainer, *args, **kwargs)
                torch.cuda.synchronize()
                probe.seconds[name].append(time.perf_counter() - t0)
                return out
            return wrapped

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                cls, "_queue_step_metrics", queue_step))
            stack.enter_context(mock.patch.object(DataLoader, "__iter__", timed_iter))
            for name in self.seconds:
                stack.enter_context(mock.patch.object(cls, name, timed(name)))
            yield self


def same_state(a, b) -> bool:
    """Equal nested dicts/lists of tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        return (sorted(a, key=str) == sorted(b, key=str)
                and all(same_state(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_state, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def trainer_state(trainer) -> dict:
    """What a checkpoint restores, copied: the augmentation generator's
    state too where the trainer augments on the card."""
    state = {
        "state_dict": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.optimizer.state_dict(),
        "opt_count": trainer.optimizer.count,
        "generator": trainer.generator.get_state(),
        "epoch": trainer.i_epoch, "i_iter": trainer.i_iter,
        "best_error": trainer.best_error}
    if trainer.aug_generator is not None:
        state["aug_generator"] = trainer.aug_generator.get_state()
    return copy.deepcopy(state)


def events_of(save_root, tag) -> list:
    """The values of the scalar ``tag`` in ``save_root``'s events.jsonl."""
    with open(os.path.join(save_root, "events.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == tag]


def check_valid_images(tag, save_root, want, epochs) -> dict:
    """The image summaries of ``save_root``'s validations: at each epoch in
    ``epochs`` exactly the tags ``want`` (a batch's images as
    ``{tag}/{b}``, a plot as its tag), each row's PNG file written.
    Returns their count and tags; raises where they differ."""
    with open(os.path.join(save_root, "events.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "image" in r]
    got = collections.defaultdict(set)
    for r in rows:
        got[r["step"]].add(r["tag"] if r["tag"] in want
                           else r["tag"].rsplit("/", 1)[0])
    missing = [r["image"] for r in rows if not os.path.isfile(r["image"])
               or os.path.getsize(r["image"]) == 0]
    if dict(got) != {e: set(want) for e in epochs} or missing:
        raise AssertionError(f"({tag}) validation images: {dict(got)}, not "
                             f"{sorted(want)} at epochs {list(epochs)}; "
                             f"files missing: {missing}")
    return {"image_rows": len(rows), "image_tags": sorted(want)}


def matplotlib_imports() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def stacked_pairs(root, split, n, dev) -> list:
    """The first ``n`` pairs of ``split`` as the dataset decodes them,
    without augmentation: img1, img2 and the ground-truth flow, each
    stacked (n, H, W, C) on ``dev``."""
    pairs = Chairs(root, split=split)
    items = [pairs[i] for i in range(n)]
    return [torch.from_numpy(np.stack([it[k] for it in items])).to(dev)
            for k in ("img1", "img2")] + [
        torch.from_numpy(np.stack([it["target"]["flow"] for it in items])).to(dev)]


@torch.no_grad()
def fixed_batch_loss(model, loss_func, img1, img2) -> float:
    """The training loss of ``model`` on one batch, with neither
    augmentation nor level dropout."""
    return float(loss_func(model(img1, img2, with_bk=True), img1, img2)["total"])


@torch.no_grad()
def pair_epes(model, img1, img2, gt) -> list:
    """EPE of ``flows_fw[0]`` per pair, as validation measures it."""
    return [evaluate_flow(gt[i:i + 1], model(img1[i:i + 1], img2[i:i + 1],
                                             with_bk=False)["flows_fw"][0])[0]
            for i in range(len(gt))]


def phase_cli(dev, smi):
    """The main path through the entry points a user calls, on a
    FlyingChairs-format directory written here: ``train_main`` with
    chairs_uflow.json (its data pipeline, augmentation, validation and
    checkpoints), a resume of a checkpoint, and ``inference_main`` writing
    ``.flo`` files. The augmentation draws per sample (``PerSampleDraws``),
    so that the convergence check sees the same data in every run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with PerSampleDraws(SEED).active():
            return run_cli_phase(tmp, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cli_phase(tmp, dev, smi):
    log = logging.getLogger("chip_smoke")
    root = os.path.join(tmp, "chairs")
    os.makedirs(root)
    t0 = time.perf_counter()
    nbytes = write_chairs_dir(root, dev)
    emit({"phase": "cli_data", "pairs": CLI_PAIRS, "shape": [CH, CW],
          "bytes": nbytes, "seconds": time.perf_counter() - t0})
    n_valid, steps_per_epoch = 2, (CLI_PAIRS - 2) // TB
    n_steps = CLI_EPOCHS * steps_per_epoch

    # Run A: CLI_EPOCHS epochs through train_main, unbroken.
    dir_a = os.path.join(tmp, "a")
    probe = EntryPointProbe()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with probe.active():
        run_a = train_main(cli_config(root, dir_a, CLI_EPOCHS), log, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps_a, epochs_a = run_a.i_iter, run_a.i_epoch
    launches = {k.name: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = torch.stack([s["metrics"] for s in probe.steps]).cpu()
    epes = events_of(dir_a, "Valid_EPE_0")
    files = sorted(os.listdir(dir_a))
    # validation: a forward per pair, and one in both directions of its
    # last batch for the occlusion mask's image
    want = {"cost_volume": 8 * n_steps + (4 * n_valid + 8) * CLI_EPOCHS,
            "cost_volume_bwd": 8 * n_steps}
    valid_images = check_valid_images("cli", dir_a, {"Valid/gt", "Valid/pred_0",
                                               "Valid/mask_0"},
                                range(1, CLI_EPOCHS + 1))
    # The trainer's laps: data = the wait for the loader plus the copy to
    # the card, which waits for the previous step's kernels; batch = the
    # host's time to queue the step. A first step of an epoch also waits
    # for the loader's threads to decode their first batches.
    laps = [s["data_s"] + s["batch_s"] for s in probe.steps]
    steady = [s for s in probe.steps if s["i_step"] > 0]
    steady_laps = sum(s["data_s"] + s["batch_s"] for s in steady)
    waits = [w for shuffled, w in probe.waits if shuffled]
    valid_s = sum(probe.seconds["_validate_with_gt"])
    save_s = sum(probe.seconds["save_model"])

    # Convergence. A few Adam steps from random weights need not bring the
    # EPE down (PERF.md: here the flows grow at first), but they must bring
    # the loss down: each trained model's loss on one unaugmented batch of
    # train pairs must be below the untrained model's (the seeded init that
    # train_main starts from). A trainer that diverges fails this.
    fixed = stacked_pairs(root, "train", TB, dev)[:2]
    valid = stacked_pairs(root, "valid", n_valid, dev)
    untrained = get_model(run_a.model_cfg, device=dev, seed=SEED)
    fit = {"untrained": fixed_batch_loss(untrained, run_a.loss_func, *fixed),
           "A": fixed_batch_loss(run_a.model, run_a.loss_func, *fixed)}
    fit_steps = {"untrained": 0, "A": run_a.optimizer.count}
    epe_untrained = pair_epes(untrained, *valid)
    del untrained

    batch = next(iter(run_a.train_loader))
    imgs = [run_a._to_device(batch[k]) for k in ("img1", "img2", "img1_ph", "img2_ph")]
    step_ms = cuda_ms(lambda: run_a.train_step(*imgs), iters=5, warmup=1)
    emit({"phase": "cli_train_profile", "shape": [TB, CH, CW],
          **train_step_profile(lambda: run_a.train_step(*imgs), step_ms),
          "card": smi})

    # 3-step epochs never reach the loader's steady state: each starts with
    # a wait for a whole batch decoded on one thread. A further epoch of
    # run A's trainer over the train pairs repeated does.
    train_loader = run_a.train_loader
    run_a.train_loader = DataLoader(
        ConcatDataset([train_loader.dataset] * CLI_LONG_REPEATS), batch_size=TB,
        num_workers=train_loader.num_workers, shuffle=True, drop_last=True,
        seed=SEED)
    run_a.cfg.epoch_size = len(run_a.train_loader)
    probe_long = EntryPointProbe()
    with probe_long.active():
        run_a._run_one_epoch()
    torch.cuda.synchronize()
    run_a.train_loader = train_loader
    # run A further: the profile's steps on one batch and the long epoch
    fit["A_further"] = fixed_batch_loss(run_a.model, run_a.loss_func, *fixed)
    fit_steps["A_further"] = run_a.optimizer.count
    # steady: after the batches the loader's threads had begun at its start
    long_steady = probe_long.steps[train_loader.num_workers + 1:]
    long_laps = sum(s["data_s"] + s["batch_s"] for s in long_steady)
    long_waits = [w for shuffled, w in probe_long.waits if shuffled][
        train_loader.num_workers + 1:]
    t1 = time.perf_counter()
    n_batches = sum(1 for _ in run_a.train_loader)
    loader_ms = 1e3 * (time.perf_counter() - t1) / n_batches
    # One host thread's time per sample in each stage of the pipeline.
    chairs = run_a.train_loader.dataset.datasets[0]
    stage_s = {"decode": 0.0, "geometric": 0.0, "photometric": 0.0}
    for sample in chairs.samples[:TB]:
        t1 = time.perf_counter()
        images, _ = chairs._load_sample(sample)
        t2 = time.perf_counter()
        images = chairs.geometric_transform(images)
        t3 = time.perf_counter()
        chairs.photometric_transform(images)
        t4 = time.perf_counter()
        for key, dt in zip(stage_s, (t2 - t1, t3 - t2, t4 - t3)):
            stage_s[key] += dt
    emit({"phase": "cli_train", "run": "A", "shape": [TB, CH, CW],
          "epochs": epochs_a, "steps": steps_a, "launches": launches,
          "launches_want": want, "losses": rows[:, 0].tolist(),
          "valid_epe": epes, "files": files,
          "seconds_train_main": seconds, "step_laps_s": laps,
          "samples_per_s": TB * len(laps) / sum(laps),
          "samples_per_s_steady": TB * len(steady) / steady_laps,
          "data_time_share": sum(s["data_s"] for s in probe.steps) / sum(laps),
          "data_time_share_steady": sum(s["data_s"] for s in steady) / steady_laps,
          "loader_wait_s": waits, "loader_wait_share": sum(waits) / sum(laps),
          "device_bound_ms_per_step": step_ms,
          "long_epoch_steps": len(probe_long.steps),
          "long_epoch_steady_steps": len(long_steady),
          "long_epoch_steady_samples_per_s": TB * len(long_steady) / long_laps,
          "long_epoch_steady_data_time_share":
              sum(s["data_s"] for s in long_steady) / long_laps,
          "long_epoch_steady_loader_wait_share": sum(long_waits) / long_laps,
          "long_epoch_step_laps_s": [s["data_s"] + s["batch_s"]
                                     for s in probe_long.steps],
          "loader_alone_ms_per_batch": loader_ms,
          "host_ms_per_sample": {k: 1e3 * v / TB for k, v in stage_s.items()},
          "validation_ms_per_pair": 1e3 * (valid_s - save_s) / (n_valid * CLI_EPOCHS),
          "save_ms": 1e3 * save_s / len(probe.seconds["save_model"]),
          **valid_images, "peak_memory_gb": peak_gb, "card": smi})
    if steps_a != n_steps or epochs_a != CLI_EPOCHS or len(rows) != n_steps:
        raise AssertionError(f"run A: {steps_a} steps in {epochs_a} epochs, "
                             f"not {n_steps} in {CLI_EPOCHS}")
    if launches != want:
        raise AssertionError(f"run A launched {launches}, not {want}")
    if not (bool(torch.isfinite(rows).all()) and len(epes) == CLI_EPOCHS
            and all(np.isfinite(epes))):
        raise AssertionError(f"run A: non-finite losses or EPE {epes}")
    missing = {"Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar",
               "events.jsonl"} - set(files)
    if missing:
        raise AssertionError(f"run A wrote no {sorted(missing)}")

    loss_func = run_a.loss_func
    del run_a, imgs

    # Runs B and C: one epoch that saves, then a resume of its checkpoint.
    dir_b, dir_c = os.path.join(tmp, "b"), os.path.join(tmp, "c")
    run_b = train_main(cli_config(root, dir_b, 1), log, device=dev)
    ckpt_b = os.path.join(dir_b, "Chairs_ckpt.pth.tar")
    restored = {}
    restore = BaseTrainer._restore_resume

    def restore_and_copy(trainer):
        restore(trainer)
        restored.update(trainer_state(trainer))

    probe_c = EntryPointProbe()
    with mock.patch.object(BaseTrainer, "_restore_resume", restore_and_copy), \
            probe_c.active():
        run_c = train_main(cli_config(root, dir_c, CLI_EPOCHS, resume=ckpt_b),
                           log, device=dev)
    want_b = trainer_state(run_b)
    differ = sorted(k for k in want_b if not same_state(restored.get(k), want_b[k]))
    iters = [s["i_iter"] for s in probe_c.steps]
    emit({"phase": "cli_resume", "checkpoint_epoch": load_checkpoint(ckpt_b)["epoch"],
          "restored": sorted(restored), "differ_from_saved": differ,
          "resumed_iters": iters, "final_iter": run_c.i_iter,
          "final_epoch": run_c.i_epoch, "valid_epe": events_of(dir_c, "Valid_EPE_0")})
    if not restored or differ:
        raise AssertionError(f"resume restored {sorted(restored)}; differs: {differ}")
    if iters != list(range(steps_per_epoch, n_steps)) or (
            run_c.i_iter, run_c.i_epoch) != (n_steps, CLI_EPOCHS):
        raise AssertionError(f"resumed run: iterations {iters}, ended at "
                             f"{run_c.i_iter} in epoch {run_c.i_epoch}")
    fit["C"] = fixed_batch_loss(run_c.model, loss_func, *fixed)
    fit_steps["C"] = run_c.optimizer.count
    emit({"phase": "cli_convergence", "fixed_batch": [TB, CH, CW],
          "fixed_batch_loss": fit, "optimizer_steps": fit_steps,
          "valid_epe_untrained": epe_untrained, "valid_epe_A": epes,
          "valid_epe_C": events_of(dir_c, "Valid_EPE_0")})
    if not all(np.isfinite(v) and v < fit["untrained"]
               for k, v in fit.items() if k != "untrained"):
        raise AssertionError(f"training did not lower the loss: {fit}")
    del run_b, run_c

    # inference_main on the valid split with run A's best checkpoint.
    best = os.path.join(dir_a, "Chairs_model_best.pth.tar")
    cfg = load_config(CONFIG)
    cfg.data = [e for e in cfg.data if e.type == "valid"]
    cfg.data[0].update(root_chairs=root, out_root=os.path.join(tmp, "out"))
    cfg.inference = {"pretrained_model": best, "valid_batch_size": 1, "workers": 2}
    stamps = []

    def write_and_stamp(path, flow):
        write_flo(path, flow)
        stamps.append(time.perf_counter())

    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch("arflow_tpu_torch.utils.flow_io.write_flo", write_and_stamp):
        written = inference_main(cfg, log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inf_launches = {k.name: k.launches for k in KERNELS}

    model = load_pretrained(best, cfg.model, device=dev)
    pairs = Chairs(root, split="valid")
    errs, tols, gt_epe = [], [], []
    for i, path in enumerate(written):
        flow = read_flo(path)
        if flow.shape != (CH, CW, 2) or not np.isfinite(flow).all():
            raise AssertionError(f"{path}: shape {flow.shape} or non-finite")
        item = pairs[i]
        img1, img2 = (torch.from_numpy(item[k])[None].to(dev) for k in ("img1", "img2"))
        with torch.no_grad(), mock.patch.object(
                uflow_module, "compute_cost_volume", compute_cost_volume_reference):
            ref = model(img1, img2, with_bk=False)["flows_fw"][0][0].cpu().numpy()
        errs.append(float(np.abs(flow - ref).max()))
        tols.append(FLOW_RTOL * max(float(np.abs(ref).max()), 1.0))
        gt = item["target"]["flow"]
        gt_epe.append(float(np.sqrt(((flow - gt) ** 2).sum(-1)).mean()))
    emit({"phase": "cli_inference", "pairs": len(written), "shape": [CH, CW],
          "launches": inf_launches, "flo_vs_plain_max_abs_err": errs,
          "atol": tols, "epe_vs_ground_truth": gt_epe,
          "wall_ms_per_pair": 1e3 * wall / max(len(written), 1),
          "ms_first_pair_incl_load": 1e3 * (stamps[0] - t0) if stamps else None,
          "ms_next_pairs": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])],
          "card": smi})
    if len(written) != n_valid:
        raise AssertionError(f"inference wrote {len(written)} .flo, not {n_valid}")
    if inf_launches != {"cost_volume": 4 * n_valid, "cost_volume_bwd": 0}:
        raise AssertionError(f"inference launched {inf_launches}")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError(f".flo vs the plain cost volume: {errs} > {tols}")
    return launches, inf_launches


# The training input path (phase input_path): the native library on this
# host, the host's time per sample by stage, the photometric augmentation
# on the card, and bf16 train_main with each of the three input paths. The
# train entry of chairs_uflow.json is listed INPUT_REPEATS times, so that
# one epoch over the cli phase's 30 train pairs has 18 steps of 8.
INPUT_REPEATS = 5
INPUT_HOST_SAMPLES = 16
INPUT_HUE_SHIFTS = (-0.5, -0.37, -1e-9, 0.0, 0.21, 0.4999)
DECODE_ATOL = 6e-8  # px * (1/255) against px / 255: half an ulp at 1.0
AUG_ATOL = 1e-6
ALL_PHOTOMETRIC = {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
                   "hue": 0.5, "gamma": 1, "swap_channels": True}


def phase_input_path(dev, smi):
    """The training input path at FlyingChairs' 384x512 on the cli phase's
    directory (written anew): (a) the native library on the card's host against
    the numpy paths, (b) one host thread's ms per sample by stage for
    chairs_uflow.json's augmentation with the hue in numpy and native, (c)
    ``photometric_aug.device``: ``apply``'s device ms and launches at b8,
    the card's output against the CPU's, one ``uflow`` step with 8 + 8
    cost-volume launches, a resume restoring both generators; (d) bf16
    ``train_main`` at b8 with the host augmentation in numpy, native, and on
    the card. Under ``PerSampleDraws``, as the cli phase."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_input_")
    try:
        with PerSampleDraws(SEED).active():
            return run_input_path_phase(tmp, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def numpy_hue(x, d):
    hsv = host_transforms._rgb_to_hsv(x)
    hsv[..., 0] = (hsv[..., 0] + d) % 1.0
    return host_transforms._hsv_to_rgb(hsv)


def native_pinned(on: bool):
    """The native library as built (on) or held off (numpy/PIL paths)."""
    if on:
        return contextlib.nullcontext()
    return mock.patch.object(native, "available", lambda: False)


def input_native_checks(root, smi) -> bool:
    """(a): whether the library built, the compiler, and where it did,
    its hue against the numpy hue bit for bit and its decode against
    ``px / 255.0`` (the numpy PPM reader, PIL for a PNG)."""
    try:
        cxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        cxx = f"g++ unavailable: {e}"
    avail = native.available()
    row = {"phase": "input_native", "native_available": avail,
           "build_error": native.build_error(), "compiler": cxx}
    if not avail:
        row["note"] = ("the native library did not build on the card's host: the "
                       "host's input path below is numpy only")
        emit(row)
        return False
    rs = np.random.RandomState(SEED)
    x = rs.rand(2, CH, CW, 3).astype(np.float32)
    x[1] = (rs.randint(0, 256, x[1].shape) / 255.0).astype(np.float32)
    x[0, :8] = x[0, :8, :, :1]  # grey rows
    x[1, 0, :3] = [[1.0, 0.0, 0.0], [1.0, 0.0, 1e-7], [0.5, 0.5, 0.25]]
    t0 = time.perf_counter()
    hue = {str(d): native.hue_shift(x, d) for d in INPUT_HUE_SHIFTS}
    native_hue_ms = 1e3 * (time.perf_counter() - t0) / len(INPUT_HUE_SHIFTS)
    t0 = time.perf_counter()
    ref = {str(d): numpy_hue(x, d) for d in INPUT_HUE_SHIFTS}
    numpy_hue_ms = 1e3 * (time.perf_counter() - t0) / len(INPUT_HUE_SHIFTS)
    mismatches = {d: int((hue[d] != ref[d]).sum()) for d in hue}
    ppms = sorted(f for f in os.listdir(root) if f.endswith(".ppm"))[:4]
    decode = [(native.load_image(os.path.join(root, f)),
               read_pnm(os.path.join(root, f))) for f in ppms]
    row["has_png"] = native.has_png()  # libpng's headers on the card's host
    if row["has_png"] and importlib.util.find_spec("PIL") is not None:
        from PIL import Image

        png = os.path.join(root, "check.png")
        Image.fromarray((x[1] * 255).round().astype(np.uint8)).save(png)
        with Image.open(png) as im:
            decode.append((native.load_image(png),
                           np.asarray(im.convert("RGB"), np.float32) / 255.0))
        os.remove(png)
    decode_err = max(max_abs(torch.from_numpy(a), torch.from_numpy(b))
                     for a, b in decode)
    row.update(hue_shape=list(x.shape),
               hue_mismatches=mismatches,
               hue_bit_equal=not any(mismatches.values()),
               native_hue_ms_per_call=native_hue_ms,
               numpy_hue_ms_per_call=numpy_hue_ms,
               decode_files=len(decode), decode_max_abs_err=decode_err,
               decode_values_differing=int(sum((a != b).sum() for a, b in decode)),
               decode_atol=DECODE_ATOL, card=smi)
    emit(row)
    if not row["hue_bit_equal"]:
        raise AssertionError(f"native hue differs from numpy: {mismatches}")
    if not decode_err <= DECODE_ATOL:
        raise AssertionError(f"native decode {decode_err} from px/255")
    return True


def host_stage_ms(root, save_root, on: bool) -> dict:
    """(b): one host thread's ms per sample in each stage of chairs_uflow.json's
    train augmentation (decode, geometric: hflip, photometric: hue 0.5 and
    swapped channels) over INPUT_HOST_SAMPLES samples."""
    with native_pinned(on):
        train_set, _ = get_dataset(cli_config(root, save_root, 1), seed=SEED)
        chairs = train_set.datasets[0]
        stage_s = {"decode": 0.0, "geometric": 0.0, "photometric": 0.0}
        for sample in chairs.samples[:INPUT_HOST_SAMPLES]:
            t1 = time.perf_counter()
            images, _ = chairs._load_sample(sample)
            t2 = time.perf_counter()
            images = chairs.geometric_transform(images)
            t3 = time.perf_counter()
            chairs.photometric_transform(images)
            t4 = time.perf_counter()
            for key, dt in zip(stage_s, (t2 - t1, t3 - t2, t4 - t3)):
                stage_s[key] += dt
    out = {k: 1e3 * v / INPUT_HOST_SAMPLES for k, v in stage_s.items()}
    out["total"] = sum(out.values())
    return out


def device_aug_rows(root, dev, smi) -> list:
    """(c): ``apply`` at a b8 pair batch for chairs_uflow.json's
    augmentation and for every op: device ms (CUDA events and the
    profiler's kernel time), launches, the bound, and the card's output
    against the CPU's on the same params."""
    img1, img2, _ = stacked_pairs(root, "train", TB, dev)
    x = torch.stack([img1, img2], dim=1)  # (8, 2, 384, 512, 3)
    ph = dict(load_config(CONFIG).data[0].photometric_aug)
    rows = []
    for name, cfg in (("chairs_uflow", ph), ("all_ops", ALL_PHOTOMETRIC)):
        sample_params, apply = make_photometric(cfg)
        params = sample_params(torch.Generator(device=dev).manual_seed(SEED),
                               TB, dev)
        with torch.no_grad():
            ms = cuda_ms(lambda: apply(x, params), iters=20)
            prof = profile_window(lambda: apply(x, params), 5, ms)
            got = apply(x, params).cpu()
            want = apply(x.cpu(), {k: v.cpu() for k, v in params.items()})
        err = max_abs(got, want)
        # one read of the pair batch and one write of its augmented copy
        bound_ms = 1e3 * 2 * x.numel() * 4 / PEAK_BYTES_PER_S
        rows.append({"config": name, "ops": sorted(cfg), "shape": list(x.shape),
                     "ms": ms, "device_ms": prof["device_ms_per_call"],
                     "launches": prof["kernel_launches_per_call"],
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "top_kernels": prof["top_kernels"][:5],
                     "max_abs_err_vs_cpu": err, "atol": AUG_ATOL})
        if not err <= AUG_ATOL:
            raise AssertionError(f"apply on the card ({name}) {err} from the CPU's")
    emit({"phase": "input_device_aug", "rows": rows, "card": smi})
    return rows


def device_aug_config(root, save_root, epochs, resume=None):
    cfg = cli_config(root, save_root, epochs, resume)
    cfg.data[0].photometric_aug.device = True
    return cfg


def device_aug_step(root, tmp, dev, smi) -> dict:
    """(c): one float32 ``uflow`` step augmenting on the card, its
    launches and ms beside the step fed the plain pair as ``_ph``; then
    ``train_main`` B (1 epoch, saves) and C (its resume), which must
    restore both generators bit for bit."""
    log = logging.getLogger("chip_smoke")
    cfg = device_aug_config(root, os.path.join(tmp, "step"), 1)
    img1, img2, _ = stacked_pairs(root, "train", TB, dev)
    batch = {"img1": img1, "img2": img2}
    model = get_model(cfg.model, device=dev, seed=SEED)
    trainer = UFlowTrainer([batch], None, model, get_loss(cfg.loss), log,
                           cfg.save_root, cfg.train, model_cfg=cfg.model,
                           full_cfg=cfg)
    trainer._ensure_init()
    inputs = trainer._batch_inputs(batch)
    reset_launch_counts()
    row = trainer.train_step(*inputs).cpu()
    launches = {k.name: k.launches for k in KERNELS}
    step_ms = cuda_ms(lambda: trainer.train_step(*inputs), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: trainer.train_step(img1, img2, img1, img2),
                       iters=5, warmup=1)
    del trainer, model

    dir_b, dir_c = os.path.join(tmp, "b"), os.path.join(tmp, "c")
    run_b = train_main(device_aug_config(root, dir_b, 1), log, device=dev)
    ckpt_b = os.path.join(dir_b, "Chairs_ckpt.pth.tar")
    restored = {}
    restore = BaseTrainer._restore_resume

    def restore_and_copy(trainer):
        restore(trainer)
        restored.update(trainer_state(trainer))

    with mock.patch.object(BaseTrainer, "_restore_resume", restore_and_copy):
        run_c = train_main(device_aug_config(root, dir_c, CLI_EPOCHS, ckpt_b),
                           log, device=dev)
    want_b = trainer_state(run_b)
    differ = sorted(k for k in want_b if not same_state(restored.get(k), want_b[k]))
    out = {"phase": "input_device_step", "shape": [TB, CH, CW],
           "metrics": row.tolist(), "launches": launches,
           "step_ms": step_ms, "step_ms_without_aug": plain_ms,
           "resume_restored": sorted(restored), "resume_differ": differ,
           "resumed_to": [run_c.i_epoch, run_c.i_iter], "card": smi}
    emit(out)
    if not bool(torch.isfinite(row).all()):
        raise AssertionError(f"device-augmented step: non-finite {row.tolist()}")
    if launches != {"cost_volume": 8, "cost_volume_bwd": 8}:
        raise AssertionError(f"device-augmented step launched {launches}")
    if "aug_generator" not in restored or differ:
        raise AssertionError(f"resume restored {sorted(restored)}; differs: {differ}")
    return launches


def input_run_config(root, save_root, device_aug):
    """chairs_uflow.json in bf16, its train entry INPUT_REPEATS times, one
    epoch without validation; the photometric augmentation on the card
    where ``device_aug``."""
    cfg = device_aug_config(root, save_root, 1) if device_aug else \
        cli_config(root, save_root, 1)
    cfg.model.dtype = "bfloat16"
    cfg.train.update(valid_freq=10**9)
    cfg.data = [cfg.data[0]] * INPUT_REPEATS + [
        e for e in cfg.data if e.type == "valid"]
    return cfg


def input_train_main(root, tmp, dev, smi, mode) -> dict:
    """(d): bf16 train_main at b8 with the host augmentation in numpy
    ("numpy"), native ("native") or on the card ("device"): steady
    samples/s and loader-wait share after the batches the loader's threads
    had begun at its start."""
    log = logging.getLogger("chip_smoke")
    probe = EntryPointProbe()
    reset_launch_counts()
    with native_pinned(mode != "numpy"), probe.active():
        trainer = train_main(input_run_config(root, os.path.join(tmp, mode),
                                              mode == "device"), log, device=dev)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    workers = trainer.train_loader.num_workers
    steady = probe.steps[workers + 1:]
    laps = sum(st["data_s"] + st["batch_s"] for st in steady)
    waits = [w for shuffled, w in probe.waits if shuffled][workers + 1:]
    batch = next(iter(trainer.train_loader))
    inputs = trainer._batch_inputs(batch)
    step_ms = cuda_ms(lambda: trainer.train_step(*inputs), iters=5, warmup=1)
    rows = torch.stack([st["metrics"] for st in probe.steps]).cpu()
    b = trainer.cfg.batch_size
    out = {"mode": mode, "steps": len(probe.steps), "steady_steps": len(steady),
           "samples_per_s_steady": b * len(steady) / laps,
           "loader_wait_share_steady": sum(waits) / laps,
           "data_time_share_steady": sum(st["data_s"] for st in steady) / laps,
           "step_laps_s": [st["data_s"] + st["batch_s"] for st in probe.steps],
           "device_bound_ms_per_step": step_ms,
           "device_bound_samples_per_s": 1e3 * b / step_ms,
           "launches": launches, "losses": rows[:, 0].tolist()}
    if not bool(torch.isfinite(rows).all()) or len(steady) < 10:
        raise AssertionError(f"input run {mode}: {len(probe.steps)} steps, "
                             f"losses {rows[:, 0].tolist()}")
    n = len(probe.steps)
    if launches != {"cost_volume": 8 * n, "cost_volume_bwd": 8 * n}:
        raise AssertionError(f"input run {mode} launched {launches} in {n} steps")
    return out


def run_input_path_phase(tmp, dev, smi):
    root = os.path.join(tmp, "chairs")
    os.makedirs(root)
    write_chairs_dir(root, dev)
    avail = input_native_checks(root, smi)
    modes = ("numpy", "native") if avail else ("numpy",)
    stages = {m: host_stage_ms(root, os.path.join(tmp, "stages"), m == "native")
              for m in modes}
    emit({"phase": "input_host_stages", "shape": [CH, CW],
          "samples": INPUT_HOST_SAMPLES, "host_ms_per_sample": stages,
          "card": smi})
    device_aug_rows(root, dev, smi)
    step_launches = device_aug_step(root, tmp, dev, smi)
    runs = {m: input_train_main(root, tmp, dev, smi, m)
            for m in modes + ("device",)}
    emit({"phase": "input_train_main", "shape": [TB, CH, CW],
          "dtype": "bfloat16", "native_available": avail, "runs": runs,
          "card": smi})
    return {"device_aug_step": step_launches,
            **{f"train_main_{m}": r["launches"] for m, r in runs.items()}}


# The probabilistic UFlow path at the shape sintel_uflow_elbo_inference.json
# gives the model (test_shape 448x1024), and Sintel's own 436x1024 frames.
PH, PW = 448, 1024
PB = 8  # the batch of the timing cell
SH, SW = 436, 1024
# Each model setup of a shipped config: (key, config, model overrides).
# (e) runs two pyramids without its mixture weights net, which reads both
# directions, where inference runs the forward one alone (the net is
# trained in phase mixture_train).
PROB_SETUPS = [
    ("a", "sintel_uflow_elbo_inference.json", {}),
    ("b", "chairs_uflow_elbo_nondiag.json", {}),
    ("c", "chairs_uflow_elbo_nondiag_inv.json", {}),
    ("d", "chairs_uflow_elbo_lowrank.json", {}),
    ("e", "chairs_uflow_elbo_mixture.json", {"mixture_weights": False}),
]
# Random weights give (c) a factor L whose inverse overflows float32 (NaN
# entropy at any size): its log-diagonal reaches -2.8 where the couplings
# reach 0.8. A trained precision factor is diagonally dominant, so (c) adds
# this to the refinement's log-diagonal bias: exp(log-diagonal) then stays
# above about 3.3, several times the couplings.
INV_COV_LOG_DIAG_SHIFT = 4.0
# Entropy maps with the kernels against the plain cost volume, relative to
# the largest |entropy| (at least 1): measured at most 1.9e-6 (setup c,
# 6.7e-6 on 3.5; PERF.md), so the flows' bound holds with a margin of 50.
ENTROPY_RTOL = 1e-4


def prob_config(name, overrides):
    cfg = load_config(os.path.join(REPO, "configs", name))
    cfg.model.update(overrides)
    return cfg


def plain_prob_cost_volume():
    """The plain cost volume swapped into the probabilistic model."""
    return mock.patch.object(uflow_prob_module, "compute_cost_volume",
                             compute_cost_volume_reference)


def prob_model(cfg, dev):
    """The config's model from seed 0; (c)'s log-diagonal shifted (above)."""
    model = get_model(cfg.model, device=dev, seed=SEED)
    if cfg.model.get("inv_cov"):
        l_ch, m_ch, _ = model.out_channels
        with torch.no_grad():
            model._refine_model[-1].bias[l_ch:l_ch + m_ch] += INV_COV_LOG_DIAG_SHIFT
    return model


def seeded(dev):
    return torch.Generator(device=dev).manual_seed(SEED)


def entropy_of(res, loss_cfg, dev):
    return extract_uv_entropy(res["flows_fw"], loss_cfg, res, generator=seeded(dev))


def phase_prob_kernels(dev, smi):
    """The forward kernel against its plain version, then timed, at the
    level shapes of 448x1024, batch 1 (one pyramid), batch 2 (two
    pyramids' components in one decoder pass) and batch 8 (the timing
    cell)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    levels = {"prob_b1": level_shapes(1, PH, PW), "prob_b2": level_shapes(2, PH, PW),
              "prob_b8": level_shapes(PB, PH, PW)}
    checks = [(shape, MD, 0) for shapes in levels.values() for shape in shapes]
    return check_forward(checks, gen, dev), time_forward(levels, gen, dev, smi)


def phase_prob_inference(dev, smi):
    """Each model setup at 448x1024 b1: outputs and entropy with the
    kernels against the plain cost volume, launches, device times."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    img1, img2 = shifted_pair(1, PH, PW, 2, 3, gen, dev)
    launches = {}
    for key, name, overrides in PROB_SETUPS:
        cfg = prob_config(name, overrides)
        model = prob_model(cfg, dev)
        l_ch, m_ch, n_ch = model.out_channels
        k = model.n_pyramids
        with torch.inference_mode():
            reset_launch_counts()
            res = model(img1, img2, with_bk=False)
            ent = entropy_of(res, cfg.loss, dev)
            torch.cuda.synchronize()
            launches[key] = COST_VOLUME.launches
            flows = res["flows_fw"]
            want = [(1, PH // 2 ** i, PW // 2 ** i,
                     k * (l_ch + m_ch + (n_ch if i < 3 else 0))) for i in range(6)]
            if [tuple(f.shape) for f in flows] != want:
                raise AssertionError(f"({key}) shapes {[f.shape for f in flows]}")
            if tuple(ent.shape) != (1, PH, PW, 2):
                raise AssertionError(f"({key}) entropy shape {ent.shape}")
            with plain_prob_cost_volume():
                ref = model(img1, img2, with_bk=False)
                ent_ref = entropy_of(ref, cfg.loss, dev)
            torch.cuda.synchronize()
            if COST_VOLUME.launches != launches[key]:
                raise AssertionError(f"({key}) the plain run launched the kernel")
            mean, mean_ref = flows[0][..., :k * l_ch], ref["flows_fw"][0][..., :k * l_ch]
            scale = float(mean_ref.abs().max())
            err = max_abs(mean, mean_ref)
            tol = FLOW_RTOL * max(scale, 1.0)
            ent_scale = float(ent_ref.abs().max())
            ent_err = max_abs(ent, ent_ref)
            ent_tol = ENTROPY_RTOL * max(ent_scale, 1.0)
            finite = all(bool(torch.isfinite(t).all()) for t in (*flows, ent))
            fwd_ms = cuda_ms(lambda: model(img1, img2, with_bk=False), iters=10)
            fwd = profile_window(lambda: model(img1, img2, with_bk=False), 3, fwd_ms)
            ent_ms = cuda_ms(lambda: entropy_of(res, cfg.loss, dev), iters=3,
                             warmup=1)
            row = {"phase": "prob_inference", "setup": key, "config": name,
                   "model_overrides": overrides, "shape": [1, PH, PW],
                   "out_channels": list(model.out_channels), "n_pyramids": k,
                   "approx": cfg.loss.approx, "launches": launches[key],
                   "max_abs_flow": scale, "flow_vs_plain_max_abs_err": err,
                   "atol": tol, "max_abs_entropy": ent_scale,
                   "entropy_range": [float(ent_ref.min()), float(ent_ref.max())],
                   "entropy_vs_plain_max_abs_err": ent_err, "entropy_atol": ent_tol,
                   "finite": finite, "forward_event_ms": fwd_ms,
                   "forward_device_ms": fwd["device_ms_per_call"],
                   "forward_busy_share": fwd["busy_share"],
                   "forward_conv_ms": fwd["conv_ms_per_call"],
                   "forward_top_kernels": fwd["top_kernels"][:3],
                   "entropy_event_ms": ent_ms}
            if cfg.model.get("inv_cov"):
                f2 = res["flows_fw"][2]
                args = (torch.exp(f2[..., 2:4]), f2[..., 4:6][:, :, :-1],
                        f2[..., 6:8][:, :-1])
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                inverse_diagonal(*args)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                inv_ms = cuda_ms(lambda: inverse_diagonal(*args), iters=3, warmup=1)
                inv = profile_window(lambda: inverse_diagonal(*args), 1, inv_ms)
                row.update(inverse_diagonal_shape=list(args[0].shape),
                           inverse_diagonal_first_s=first_s,
                           inverse_diagonal_event_ms=inv_ms,
                           inverse_diagonal_device_ms=inv["device_ms_per_call"],
                           inverse_diagonal_busy_share=inv["busy_share"],
                           inverse_diagonal_top_kernels=inv["top_kernels"][:4],
                           inverse_diagonal_peak_gb=peak / 1e9)
            emit({**row, "card": smi})
        if launches[key] != 4:
            raise AssertionError(f"({key}) cost_volume launched {launches[key]} "
                                 "times, not 4")
        if not (finite and err <= tol and ent_err <= ent_tol):
            raise AssertionError(f"({key}) vs plain: flow {err} > {tol}, entropy "
                                 f"{ent_err} > {ent_tol}, or non-finite")
        del model, res, ref
    return launches


def phase_prob_inference_time(dev, smi):
    """Setup (a) at 448x1024 b8 with its entropy map: the flow and entropy
    against the same model with the plain cost volume, maps/s and a
    profile."""
    cfg = prob_config(*PROB_SETUPS[0][1:])
    model = prob_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    img1, img2 = shifted_pair(PB, PH, PW, 2, 3, gen, dev)

    def forward():
        res = model(img1, img2, with_bk=False)
        return res["flows_fw"][0][..., :2], entropy_of(res, cfg.loss, dev)

    with torch.inference_mode():
        reset_launch_counts()
        flow, ent = forward()
        torch.cuda.synchronize()
        launches = COST_VOLUME.launches
        with plain_prob_cost_volume():
            flow_ref, ent_ref = forward()
        torch.cuda.synchronize()
        if COST_VOLUME.launches != launches:
            raise AssertionError("b8: the plain run launched the kernel")
        err, ent_err = max_abs(flow, flow_ref), max_abs(ent, ent_ref)
        tol = FLOW_RTOL * max(float(flow_ref.abs().max()), 1.0)
        ent_tol = ENTROPY_RTOL * max(float(ent_ref.abs().max()), 1.0)
        finite = bool(torch.isfinite(flow).all()) and bool(torch.isfinite(ent).all())
        del flow_ref, ent_ref
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(forward, iters=20)
        peak = torch.cuda.max_memory_allocated() / 1e9
        emit({"phase": "prob_inference_time", "setup": "a",
              "shape": [PB, PH, PW], "dtype": "float32", "launches": launches,
              "flow_vs_plain_max_abs_err": err, "atol": tol,
              "entropy_vs_plain_max_abs_err": ent_err, "entropy_atol": ent_tol,
              "finite": finite,
              "ms_per_batch": ms, "maps_per_s": PB / (ms / 1e3),
              "peak_memory_gb": peak, "card": smi})
        emit({"phase": "prob_inference_profile", "setup": "a",
              "shape": [PB, PH, PW], **profile_window(forward, 3, ms),
              "card": smi})
    if launches != 4 or not (finite and err <= tol and ent_err <= ent_tol):
        raise AssertionError(f"b8: {launches} launches, flow {err} > {tol}, "
                             f"entropy {ent_err} > {ent_tol}, or non-finite")
    return launches


def phase_prob_serving(dev, smi):
    """StreamingFlowEngine on setup (a) with its loss section, 448x1024 b1:
    one pyramid per frame, flows and entropy equal to the monolithic
    forward's, flows/s and the device time per flow."""
    cfg = prob_config(*PROB_SETUPS[0][1:])
    model = prob_model(cfg, dev)
    state = model.state_dict()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    m = 4 * STREAM_FRAMES
    tex = texture(1, PH + m, PW + m, gen, dev)
    seq = [tex[:, :, 2 * t:2 * t + PH, 3 * t:3 * t + PW].permute(0, 2, 3, 1).contiguous()
           for t in range(STREAM_FRAMES)]
    counts = {}
    for with_bw in (False, True):
        engine = StreamingFlowEngine(cfg.model, state, with_bw=with_bw,
                                     device=dev, loss_cfg=cfg.loss)
        reset_launch_counts()
        outs = [engine.push(f) for f in seq]
        torch.cuda.synchronize()
        counts[with_bw] = COST_VOLUME.launches
        flows = [o for o in outs if o is not None]
        if outs[0] is not None or len(flows) != STREAM_FRAMES - 1:
            raise AssertionError("prob streaming: wrong number of outputs")
        if engine.pyramids_computed != STREAM_FRAMES:
            raise AssertionError(f"{engine.pyramids_computed} pyramids computed")
        want = 4 * (STREAM_FRAMES - 1) * (2 if with_bw else 1)
        if counts[with_bw] != want:
            raise AssertionError(f"prob streaming launched {counts[with_bw]}, "
                                 f"not {want}")
        err = ent_err = 0.0
        scale = ent_scale = 1.0
        with torch.inference_mode():
            for t, out in enumerate(flows):
                mono = model(seq[t], seq[t + 1], with_bk=with_bw)
                pairs = [(out["flow"], mono["flows_fw"][0][..., :2])]
                if with_bw:
                    pairs.append((out["flow_bw"], mono["flows_bw"][0][..., :2]))
                for a, b in pairs:
                    err = max(err, max_abs(a, b))
                    scale = max(scale, float(b.abs().max()))
                ent = entropy_of(mono, cfg.loss, dev)
                ent_err = max(ent_err, max_abs(out["entropy"], ent))
                ent_scale = max(ent_scale, float(ent.abs().max()))
        tol, ent_tol = FLOW_RTOL * scale, FLOW_RTOL * ent_scale
        emit({"phase": "prob_serving", "with_bw": with_bw,
              "frames": STREAM_FRAMES, "flows": len(flows),
              "pyramids": engine.pyramids_computed, "launches": counts[with_bw],
              "vs_monolithic_max_abs_err": err, "atol": tol,
              "entropy_vs_monolithic_max_abs_err": ent_err,
              "entropy_atol": ent_tol})
        if not all(bool(torch.isfinite(o["flow"]).all())
                   and bool(torch.isfinite(o["entropy"]).all()) for o in flows):
            raise AssertionError("non-finite prob streaming output")
        if not (err <= tol and ent_err <= ent_tol):
            raise AssertionError(f"prob streaming vs monolithic: {err} > {tol} "
                                 f"or entropy {ent_err} > {ent_tol}")

    engine = StreamingFlowEngine(cfg.model, state, device=dev, loss_cfg=cfg.loss)
    for f in seq[:3]:  # warm-up
        engine.push(f)
    torch.cuda.synchronize()
    rounds = 5
    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in seq:
            engine.push(f)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = rounds * STREAM_FRAMES
    emit({"phase": "prob_serving_time", "shape": [1, PH, PW], "flows": n,
          "seconds": dt, "flows_per_s": n / dt, "card": smi})
    frames = iter(seq * 2)
    emit({"phase": "prob_serving_profile", "shape": [1, PH, PW],
          **profile_window(lambda: engine.push(next(frames)), STREAM_FRAMES,
                           1e3 * dt / n),
          "card": smi})
    return counts


SINTEL_SCENES = (("scene_a", (1, 2)), ("scene_b", (-2, 3)))  # (dy, dx) per frame


def write_sintel_tree(root, gt_root, dev) -> int:
    """Sintel's test layout, ``test/{clean,final}/<scene>/frame_000{1..4}
    .png`` at 436x1024 through PIL: per scene a seeded texture moved by a
    whole (dy, dx) per frame (final: the clean frames darkened by 10%); and
    under ``gt_root`` the flow (u, v) = (dx, dy) of each pair as ``.flo`` at
    the prediction's relative path. Returns the bytes of the images."""
    from PIL import Image

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    nbytes = 0
    for scene, (dy, dx) in SINTEL_SCENES:
        m = 16
        tex = texture(1, SH + 2 * m, SW + 2 * m, gen, dev)
        for t in range(4):
            img = tex[0, :, m - t * dy:m - t * dy + SH, m - t * dx:m - t * dx + SW]
            px = (img.permute(1, 2, 0) * 255).round().to(torch.uint8).cpu().numpy()
            for kind, pixels in (("clean", px), ("final", (px * 0.9).astype(np.uint8))):
                d = os.path.join(root, "test", kind, scene)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, f"frame_{t + 1:04d}.png")
                Image.fromarray(pixels).save(path)
                nbytes += os.path.getsize(path)
                if t < 3:
                    g = os.path.join(gt_root, "test", kind, scene)
                    os.makedirs(g, exist_ok=True)
                    write_flo(os.path.join(g, f"frame_{t + 1:04d}.flo"),
                              np.tile(np.float32([dx, dy]), (SH, SW, 1)))
    return nbytes


def top_functions(profiler, n) -> list:
    """The ``n`` functions of a cProfile run with the most time of their
    own: [file:line(name), calls, own s, cumulative s]."""
    stats = pstats.Stats(profiler).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [[f"{os.path.basename(f)}:{line}({name})", nc, tt, ct]
            for (f, line, name), (_, nc, tt, ct, _) in rows]


def phase_prob_cli(dev, smi):
    """The user's path: ``inference_main`` with
    sintel_uflow_elbo_inference.json on a Sintel-format tree written here,
    then ``evaluate_flo_cli`` on what it wrote."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prob_cli_")
    try:
        return run_prob_cli_phase(tmp, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_prob_cli_phase(tmp, dev, smi):
    log = logging.getLogger("chip_smoke")
    root, gt_root = os.path.join(tmp, "sintel"), os.path.join(tmp, "gt")
    t0 = time.perf_counter()
    nbytes = write_sintel_tree(root, gt_root, dev)
    data_s = time.perf_counter() - t0
    name = PROB_SETUPS[0][1]
    ckpt = os.path.join(tmp, "seed0.pth.tar")
    cfg = prob_config(name, {})
    torch.save({"epoch": 0, "state_dict": get_model(cfg.model, device="cpu",
                                                    seed=SEED).state_dict()}, ckpt)

    def config(out_root):
        cfg = prob_config(name, {})
        for entry in cfg.data:
            entry.update(root_sintel=root, out_root=out_root)
        cfg.inference.pretrained_model = ckpt
        return cfg

    stamps = []

    def write_and_stamp(path, flow):
        write_flo(path, flow)
        stamps.append(time.perf_counter())

    out_root, plain_root = os.path.join(tmp, "out"), os.path.join(tmp, "plain")
    reset_launch_counts()
    t_inf = time.perf_counter()
    with mock.patch("arflow_tpu_torch.utils.flow_io.write_flo", write_and_stamp):
        written = inference_main(config(out_root), log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_inf
    launches = COST_VOLUME.launches
    with plain_prob_cost_volume():
        plain = inference_main(config(plain_root), log, device=dev)
    if COST_VOLUME.launches != launches:
        raise AssertionError("the plain inference_main launched the kernel")
    errs, tols = {".flo": [], ".npy": []}, {".flo": [], ".npy": []}
    for path, ref_path in zip(written, plain):
        if os.path.relpath(path, out_root) != os.path.relpath(ref_path, plain_root):
            raise AssertionError(f"{path} and {ref_path} differ")
        for ext, read in ((".flo", read_flo), (".npy", np.load)):
            got, want = read(path[:-4] + ext), read(ref_path[:-4] + ext)
            if got.shape != (SH, SW, 2) or not np.isfinite(got).all():
                raise AssertionError(f"{path[:-4] + ext}: {got.shape} or non-finite")
            errs[ext].append(float(np.abs(got - want).max()))
            tols[ext].append(FLOW_RTOL * max(float(np.abs(want).max()), 1.0))
    # evaluate_flo_cli on the clean pass (6 of the 12 pairs; it is host
    # numpy, held to the JAX package's by the CPU tests), under cProfile.
    profiler = cProfile.Profile()
    t0 = time.perf_counter()
    metrics = profiler.runcall(evaluate_flo_cli, [
        "--pred_root", os.path.join(out_root, "test", "clean"),
        "--gt_root", os.path.join(gt_root, "test", "clean")])
    eval_s = time.perf_counter() - t0
    n_pairs = 2 * len(SINTEL_SCENES) * 3
    n_eval = n_pairs // 2
    emit({"phase": "prob_cli", "config": name, "pairs": len(written),
          "shape": [SH, SW], "model_shape": [PH, PW], "image_bytes": nbytes,
          "data_seconds": data_s, "launches": launches,
          "flo_vs_plain_max_abs_err": max(errs[".flo"]),
          "npy_vs_plain_max_abs_err": max(errs[".npy"]),
          "atol_min": {k: min(v) for k, v in tols.items()},
          "evaluate_flo": metrics, "evaluate_pairs": n_eval,
          "evaluate_profile": top_functions(profiler, 6),
          "wall_ms_per_pair": 1e3 * wall / max(len(written), 1),
          "ms_first_pair_incl_load": 1e3 * (stamps[0] - t_inf) if stamps else None,
          "ms_next_pairs": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])],
          "evaluate_ms_per_pair": 1e3 * eval_s / n_eval,
          "card": smi})
    if len(written) != n_pairs or len(plain) != n_pairs:
        raise AssertionError(f"inference_main wrote {len(written)} .flo, not {n_pairs}")
    if launches != 4 * n_pairs:
        raise AssertionError(f"inference_main launched {launches}, not {4 * n_pairs}")
    if not all(e <= t for ext in errs for e, t in zip(errs[ext], tols[ext])):
        raise AssertionError(f"outputs vs the plain cost volume: {errs} > {tols}")
    if not (metrics["files"] == n_eval
            and np.isfinite([metrics["epe"], metrics["auc"], metrics["auc_diff"]]).all()):
        raise AssertionError(f"evaluate_flo_cli: {metrics}")
    return launches


# ELBO training of the probabilistic UFlow: shipped configs' model and loss
# at chairs_uflow_elbo.json's crop 256x448 and batch 4, float32.
EB, EH, EW = 4, 256, 448
ELBO_STEPS = 10
# (key, config, model overrides), as PROB_SETUPS: (e) without its mixture
# weights net, whose loss then takes uniform weights.
ELBO_SETUPS = [
    ("a", "chairs_uflow_elbo.json", {}),
    ("b", "chairs_uflow_elbo_nondiag.json", {}),
    ("d", "chairs_uflow_elbo_lowrank.json", {}),
    ("e", "chairs_uflow_elbo_mixture.json", {"mixture_weights": False}),
]
# elbo_cli: chairs_uflow_elbo.json's train entry crops 256x448 from the
# 384x512 pairs; epoch_size 2 runs 3 steps per epoch (the loop breaks after
# step epoch_size, as the JAX trainer's does).
ELBO_CLI_EPOCH_SIZE = 2
ELBO_OVERFIT_STEPS = 20


class RecordingElboTrainer(RecordingTrainer, UFlowElboTrainer):
    """Keeps each step's metric row (total, l_ph, l_sm, entropy, l_oof)."""


class RecordingMseTrainer(RecordingTrainer, MseTrainer):
    """Keeps each step's metric row (total, l_mse, entropy, l_offdiag)."""


class FixedNoise:
    """``loss`` with the same injected draws at every call: the ELBO loss's
    (res, img1, img2) or the MSE loss's (res, gt_flow)."""

    def __init__(self, loss, noise):
        self.loss, self.noise, self.cfg = loss, noise, loss.cfg

    def __call__(self, res, *inputs, generator=None):
        return self.loss(res, *inputs, noise=self.noise)


def elbo_noise(loss_cfg, b, h2, w2, gen, dev):
    """One draw of the loss's noise at batch ``b`` and level-2 size, as
    ``noise=`` takes it."""
    n = loss_cfg.n_samples
    if loss_cfg.approx == "lowrank":
        shape = (n * b, 1, 1, 2 * loss_cfg.columns)
    else:
        shape = (n * b, h2, w2, 2)
    noise = {k: torch.randn(shape, generator=gen, device=dev)
             for k in ("eps12", "eps21")}
    if loss_cfg.approx == "mixture":
        uniform = torch.ones((b, loss_cfg.n_components), device=dev)
        for k in ("z12", "z21"):
            noise[k] = torch.multinomial(uniform, n, replacement=True, generator=gen)
    return noise


def phase_elbo_kernels(dev, smi):
    """Both kernels at the ELBO step's level shapes of 256x448
    (``kernels_at_levels``): batch 8 (both directions of b4 on one decoder
    pass) and 16 (two pyramids' components, setup (e))."""
    return kernels_at_levels(
        {f"elbo_b{b}": level_shapes(b, EH, EW) for b in (2 * EB, 4 * EB)},
        SEED + 8, dev, smi)


def kernels_at_levels(levels, seed, dev, smi):
    """Both kernels against their plain versions, then timed, at each cell
    of ``levels`` ({cell: level shapes}). At each shape the forward kernel's
    rms error against float64 must be at most the plain version's; the row
    also counts the outputs where the two differ at all (the kernel rounds
    as the plain version does)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    checks = [(shape, MD, 0) for shapes in levels.values() for shape in shapes]
    fwd_err = check_forward(checks, gen, dev)
    for shape, _, _ in checks:
        f1 = torch.randn(shape, generator=gen, device=dev)
        f2 = torch.randn(shape, generator=gen, device=dev)
        exact = compute_cost_volume_reference(f1.double(), f2.double(), MD)
        kernel = cost_volume_kernel(f1, f2, MD)
        plain = compute_cost_volume_reference(f1, f2, MD)
        rms = {f"rms_{name}": float((v.double() - exact).square().mean().sqrt())
               for name, v in (("kernel", kernel), ("plain", plain))}
        emit({"phase": "kernel_rms_vs_f64", "kernel": "cost_volume",
              "shape": shape, **rms, "unequal": int((kernel != plain).sum())})
        if not rms["rms_kernel"] <= rms["rms_plain"]:
            raise AssertionError(f"cost_volume {shape}: rms error vs float64 "
                                 f"{rms['rms_kernel']} > the plain version's "
                                 f"{rms['rms_plain']}")
    fwd_rows = time_forward(levels, gen, dev, smi)
    bwd_err, inputs = check_grad(checks, gen, dev)
    bwd_rows = {key: time_grad(shapes, inputs, smi, key)
                for key, shapes in levels.items()}
    return fwd_err, fwd_rows, bwd_err, bwd_rows


def elbo_step_check(key, name, cfg, model, loss, x, noise):
    """One ELBO step of a setup (``step_check``), dropout off and the model
    in eval mode. Returns the failure's message, or None."""
    def forward_loss(net, inputs, draws, train):
        res = net(inputs["img1"], inputs["img2"], with_bk=True, train=train)
        return loss(res, inputs["img1"], inputs["img2"], noise=draws)

    return step_check(
        forward_loss, model, x, noise,
        {"phase": "elbo_train_step_check", "setup": key, "config": name,
         "approx": cfg.loss.approx, "n_samples": cfg.loss.n_samples,
         "shape": [EB, EH, EW]})


def step_check(forward_loss, model, x, noise, row, train=False,
               swap=plain_prob_cost_volume, launches=4, deterministic=False):
    """One step's loss and parameter gradients with the kernels against the
    plain-cost-volume model and a float64 one, under the same noise, with
    the train phase's bounds, and ``launches`` + ``launches`` kernel
    launches. ``forward_loss(net, inputs, draws, train)`` runs the model
    and the loss; ``swap()`` puts the plain cost volume into the model.
    With ``train`` the model runs in training mode with level dropout
    off: each run starts from the same BatchNorm running statistics, and
    the kernel model's updated ones must be within ``BN_STATS_RTOL`` of
    the plain model's. With ``deterministic`` the
    runs take torch's deterministic algorithms where it has them (the
    range map's ``index_add``, whose atomic order would otherwise move
    pixels across a thresholded mask between the runs). Emits ``row``
    with the results; returns the failure's message, or None."""
    key = row.get("setup", row["phase"])
    dropout = getattr(model, "level_dropout", None)
    if dropout is not None:
        model.level_dropout = 0.0
    buffers0 = {n: b.clone() for n, b in model.named_buffers()}

    def step_grads(net, inputs, draws, plain: bool):
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(buffers0[n])
        net.zero_grad(set_to_none=True)
        with swap() if plain else contextlib.nullcontext():
            out = forward_loss(net, inputs, draws, train)
            out["total"].backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in net.named_parameters()
                 if p.grad is not None}
        stats = {n: b.clone() for n, b in net.named_buffers() if "running" in n}
        net.zero_grad(set_to_none=True)
        return float(out["total"].detach()), grads, stats

    torch.backends.cudnn.deterministic = True
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    reset_launch_counts()
    total, grads, stats = step_grads(model, x, noise, False)
    step_launches = {k.name: k.launches for k in KERNELS}
    total_again, grads_again, _ = step_grads(model, x, noise, False)
    total_plain, grads_plain, stats_plain = step_grads(model, x, noise, True)
    as64 = lambda d: {k: v.double() if v.is_floating_point() else v  # noqa: E731
                      for k, v in d.items()}
    total64, grads64, _ = step_grads(copy.deepcopy(model).double(), as64(x),
                                     as64(noise), True)
    torch.use_deterministic_algorithms(False)
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers0[n])
    if dropout is not None:
        model.level_dropout = dropout
    if {k.name: k.launches for k in KERNELS} != {
            n: 2 * v for n, v in step_launches.items()}:
        raise AssertionError(f"({key}) the plain runs launched a kernel")
    if not (sorted(grads) == sorted(grads_again) == sorted(grads_plain)
            == sorted(grads64)):
        raise AssertionError(f"({key}) different parameters have gradients")

    def cat(g):
        return torch.cat([g[n].flatten().double() for n in sorted(g)])

    over = {n: (rel_l2(grads[n], grads64[n]), rel_l2(grads_plain[n], grads64[n]))
            for n in grads
            if rel_l2(grads[n], grads64[n]) > 2 * rel_l2(grads_plain[n], grads64[n]) + 1e-5}
    grad_err = rel_l2(cat(grads), cat(grads_plain))
    loss_err = abs(total - total_plain) / abs(total_plain)
    stats_err = max((rel_l2(stats[n], stats_plain[n]) for n in stats), default=0.0)
    row.update({
        "launches": step_launches, "params_with_grad": len(grads),
        "loss": total, "loss_plain": total_plain, "loss_plain_f64": total64,
        "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
        "grad_rel_l2_vs_plain": grad_err, "grad_rtol": TRAIN_GRAD_RTOL,
        "grad_rel_l2_vs_f64": rel_l2(cat(grads), cat(grads64)),
        "plain_grad_rel_l2_vs_f64": rel_l2(cat(grads_plain), cat(grads64)),
        "kernel_run_to_run_loss_rel": abs(total - total_again) / abs(total),
        "kernel_run_to_run_grad_rel_l2": rel_l2(cat(grads), cat(grads_again)),
        "params_over_tolerance": over})
    if train:
        row.update({"bn_buffers": len(stats),
                    "bn_stats_rel_l2_vs_plain": stats_err,
                    "bn_stats_rtol": BN_STATS_RTOL})
    failure = None
    if step_launches != {"cost_volume": launches, "cost_volume_bwd": launches}:
        failure = (f"({key}) a step launched {step_launches}, not {launches} "
                   f"+ {launches}")
    elif not (np.isfinite(total) and loss_err <= TRAIN_LOSS_RTOL
              and grad_err <= TRAIN_GRAD_RTOL and not over):
        failure = (f"({key}) step kernels vs plain: loss {loss_err}, "
                   f"gradients {grad_err}, parameters {over}")
    elif not stats_err <= BN_STATS_RTOL:
        failure = f"({key}) BatchNorm statistics vs plain: {stats_err}"
    torch.backends.cudnn.deterministic = False
    emit(row)
    return failure


def phase_elbo_train(dev, smi):
    """Each setup: one step against the plain cost volume and float64
    (``elbo_step_check``), then ELBO_STEPS steps through
    ``UFlowElboTrainer.train()`` with the cost-volume launches counted.
    Setup (a)'s trainer is timed and profiled (``elbo_train_time``). A
    failed step check fails the phase once every setup has run."""
    log = logging.getLogger("chip_smoke")
    launches = {}
    failures = []
    for key, name, overrides in ELBO_SETUPS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        cfg = prob_config(name, overrides)
        if get_trainer(cfg.trainer) is not UFlowElboTrainer:
            raise AssertionError(f"{name} names trainer {cfg.trainer!r}")
        model = get_model(cfg.model, device=dev, seed=SEED)
        loss = get_loss(cfg.loss)
        batches = []
        for dy, dx in ((1, 2), (2, -3), (-3, 1)):
            a, b = shifted_pair(EB, EH, EW, dy, dx, gen, dev)
            batches.append({"img1": a, "img2": b})
        noise = elbo_noise(cfg.loss, EB, EH // 4, EW // 4, gen, dev)
        failure = elbo_step_check(key, name, cfg, model, loss, batches[0], noise)
        if failure:
            failures.append(failure)

        train_cfg = cfg.train.copy()
        train_cfg.update(epoch_num=1, seed=SEED)
        trainer = RecordingElboTrainer(
            [batches[i % len(batches)] for i in range(ELBO_STEPS)], None, model,
            loss, log, os.path.join(REPO, "outputs", "chip_smoke"), train_cfg,
            model_cfg=cfg.model, full_cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[key] = {k.name: k.launches for k in KERNELS}
        rows = torch.stack(trainer.rows).cpu()
        emit({"phase": "elbo_train", "setup": key, "config": name,
              "model_overrides": overrides, "approx": cfg.loss.approx,
              "n_samples": cfg.loss.n_samples,
              "level_dropout": cfg.model.level_dropout,
              "shape": [EB, EH, EW], "steps": trainer.i_iter,
              "seconds_incl_first_steps": seconds, "launches": launches[key],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              **{k: rows[:, i].tolist() for i, k in enumerate(
                  ("losses", "l_ph", "l_sm", "entropy", "l_oof"))}})
        if trainer.i_iter != ELBO_STEPS or len(rows) != ELBO_STEPS:
            raise AssertionError(f"({key}) {trainer.i_iter} steps, not {ELBO_STEPS}")
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"({key}) non-finite training metrics")
        want = 4 * ELBO_STEPS
        if launches[key] != {"cost_volume": want, "cost_volume_bwd": want}:
            raise AssertionError(f"({key}) {ELBO_STEPS} steps launched "
                                 f"{launches[key]}, not {want} + {want}")
        if key == "a":
            elbo_train_time(trainer, batches[0], smi)
        del trainer, model
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def elbo_train_time(trainer, x, smi):
    """Setup (a)'s step (``step_time``)."""
    step_time("elbo_train", lambda: trainer.train_step(x["img1"], x["img2"]),
              EB, [EB, EH, EW], smi, {"setup": "a"})


def step_time(phase, one_step, batch, shape, smi, labels=None, ranges=None,
              groups=None,
              census=(elbo_blocks_module, "census_loss_no_penalty")) -> dict:
    """A train step's samples/s and device ms per step (CUDA events over 10
    steps after 2 warm-up steps), peak memory (``{phase}_time``), and
    ``train_step_profile`` with ``ranges`` and ``groups``
    (``{phase}_profile``). Returns the profile."""
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(one_step, iters=10, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    labels = labels or {}
    emit({"phase": f"{phase}_time", **labels, "shape": shape,
          "dtype": "float32", "ms_per_step": ms, "steps_per_s": 1e3 / ms,
          "samples_per_s": batch * 1e3 / ms, "peak_memory_gb": peak, "card": smi})
    prof = train_step_profile(one_step, ms, census=census, ranges=ranges,
                              extra_groups=groups)
    emit({"phase": f"{phase}_profile", **labels, "shape": shape, **prof,
          "peak_memory_gb": peak, "card": smi})
    return prof


def elbo_cli_config(root, save_root, epochs, resume=None, track_auc=False):
    """``configs/chairs_uflow_elbo.json`` with both data roots at ``root``,
    ``epochs`` epochs of 3 steps that each validate (with ``track_auc`` if
    asked: the AUC's numpy at sp_samples 100 takes about 3 s per pair) and
    save; the rest (crop 256x448, hflip, hue 0.5, swapped channels, batch
    4, Adam, 4 workers) as the config has it."""
    cfg = load_config(os.path.join(REPO, "configs", "chairs_uflow_elbo.json"))
    for entry in cfg.data:
        entry.root_chairs = root
    cfg.save_root = save_root
    cfg.train.update(epoch_num=epochs, epoch_size=ELBO_CLI_EPOCH_SIZE,
                     valid_freq=1, save_iter=0, track_auc=track_auc)
    if resume is not None:
        cfg.train.resume = resume
    return cfg


def phase_elbo_cli(dev, smi):
    """``train_main`` with chairs_uflow_elbo.json on the FlyingChairs-format
    directory of the cli phase (written anew here): 2 epochs of 3 steps
    with validation and AUC, both checkpoints, a resume, and an overfit
    check. Under ``PerSampleDraws``, as the cli phase."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elbo_cli_")
    try:
        with PerSampleDraws(SEED).active():
            return run_elbo_cli_phase(tmp, dev, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_elbo_cli_phase(tmp, dev, smi):
    log = logging.getLogger("chip_smoke")
    root = os.path.join(tmp, "chairs")
    os.makedirs(root)
    write_chairs_dir(root, dev)
    n_valid, steps_per_epoch = 2, ELBO_CLI_EPOCH_SIZE + 1
    n_steps = CLI_EPOCHS * steps_per_epoch

    dir_a = os.path.join(tmp, "a")
    probe = EntryPointProbe(UFlowElboTrainer)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with probe.active():
        run_a = train_main(elbo_cli_config(root, dir_a, CLI_EPOCHS, track_auc=True),
                           log, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = torch.stack([s["metrics"] for s in probe.steps]).cpu()
    files = sorted(os.listdir(dir_a))
    valid = {name: events_of(dir_a, f"Valid_{name}_0")
             for name in ("Loss", "EPE", "AUC", "AUC_diff", "entropy")}
    # one decoder pass per step and per validation batch (both valid pairs)
    want = {"cost_volume": 4 * n_steps + 4 * CLI_EPOCHS,
            "cost_volume_bwd": 4 * n_steps}
    laps = [s["data_s"] + s["batch_s"] for s in probe.steps]
    steady = [s for s in probe.steps if s["i_step"] > 0]
    steady_laps = sum(s["data_s"] + s["batch_s"] for s in steady)
    valid_s = sum(probe.seconds["_validate_with_gt"])
    save_s = sum(probe.seconds["save_model"])
    # n_components 1, occ_type sample, track_auc: the splot
    valid_images = check_valid_images(
        "elbo_cli", dir_a,
        {"Valid/gt_0", "Valid/pred_0_0", "Valid/entropy_0", "Valid/sample_flows_0",
         "Valid/occu_masks_0", "Valid/valid_masks_0"}
        | ({"Valid/splot_0"} if matplotlib_imports() else set()),
        range(1, CLI_EPOCHS + 1))
    emit({"phase": "elbo_cli_train", "run": "A", "config": "chairs_uflow_elbo.json",
          "shape": [EB, EH, EW], "pairs_shape": [CH, CW],
          "epochs": run_a.i_epoch, "steps": run_a.i_iter, "launches": launches,
          "launches_want": want, "losses": rows[:, 0].tolist(),
          "valid": valid, "best_error": run_a.best_error, "files": files,
          "seconds_train_main": seconds, "step_laps_s": laps,
          "samples_per_s": EB * len(laps) / sum(laps),
          "samples_per_s_steady": EB * len(steady) / steady_laps,
          "data_time_share": sum(s["data_s"] for s in probe.steps) / sum(laps),
          "validation_ms_per_pair": 1e3 * (valid_s - save_s) / (n_valid * CLI_EPOCHS),
          "save_ms": 1e3 * save_s / max(len(probe.seconds["save_model"]), 1),
          **valid_images, "peak_memory_gb": peak_gb, "card": smi})
    if (run_a.i_iter, run_a.i_epoch, len(rows)) != (n_steps, CLI_EPOCHS, n_steps):
        raise AssertionError(f"run A: {run_a.i_iter} steps in {run_a.i_epoch} "
                             f"epochs, not {n_steps} in {CLI_EPOCHS}")
    if launches != want:
        raise AssertionError(f"run A launched {launches}, not {want}")
    if not (bool(torch.isfinite(rows).all())
            and all(len(v) == CLI_EPOCHS and np.isfinite(v).all()
                    for v in valid.values())):
        raise AssertionError(f"run A: non-finite losses or validation {valid}")
    if run_a.best_error != min(valid["Loss"]):
        raise AssertionError(f"best checkpoint on {run_a.best_error}, not the "
                             f"validation Loss {valid['Loss']}")
    missing = ({"Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar", "events.jsonl"}
               | {f"flow_fw_l2_{e}.npy" for e in range(1, CLI_EPOCHS + 1)}) - set(files)
    if missing:
        raise AssertionError(f"run A wrote no {sorted(missing)}")
    loss_func = run_a.loss_func
    del run_a

    # Runs B and C: one epoch that saves, then a resume of its checkpoint.
    resume_runs("elbo", lambda d, e, r: elbo_cli_config(root, d, e, r),
                UFlowElboTrainer, tmp, dev, "Loss")

    # Overfit: ELBO_OVERFIT_STEPS steps on one fixed unaugmented batch of
    # train pairs under one fixed draw of the noise, dropout off, must
    # lower that batch's loss below the untrained model's.
    img1, img2, _ = stacked_pairs(root, "train", EB, dev)
    cfg = elbo_cli_config(root, os.path.join(tmp, "overfit"), 1)
    model = get_model(cfg.model, device=dev, seed=SEED)
    model.level_dropout = 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    fixed = FixedNoise(loss_func, elbo_noise(cfg.loss, EB, CH // 4, CW // 4, gen, dev))

    def batch_loss():
        with torch.no_grad():
            return float(fixed(model(img1, img2, with_bk=True), img1, img2)["total"])

    before = batch_loss()
    cfg.train.update(epoch_num=1, epoch_size=ELBO_OVERFIT_STEPS)
    trainer = UFlowElboTrainer([{"img1": img1, "img2": img2}] * ELBO_OVERFIT_STEPS,
                               None, model, fixed, log, cfg.save_root, cfg.train,
                               model_cfg=cfg.model, full_cfg=cfg)
    trainer.train()
    after = batch_loss()
    emit({"phase": "elbo_cli_overfit", "batch": [EB, CH, CW],
          "steps": trainer.i_iter, "loss_untrained": before, "loss_after": after})
    if trainer.i_iter != ELBO_OVERFIT_STEPS or not (np.isfinite(after)
                                                   and after < before):
        raise AssertionError(f"{trainer.i_iter} steps on one batch: loss "
                             f"{before} -> {after}")
    return launches


# MixtureWeightsNet and supervised MSE training. mixture_train:
# chairs_uflow_elbo_mixture.json's model with its weights net and its loss
# at the ELBO cells' crop and batch. mse_train: chairs_uflow_mse.json at
# FlyingChairs' own 384x512 (no crop) and its batch 16, forward direction
# only; its cli run needs 3 batches of 16 train pairs, and fids 6, 18, 43
# and 46 are the valid split, so 56 pairs.
MB, MH, MW = 16, CH, CW
MSE_STEPS = 10
MSE_OVERFIT_STEPS = 20
MSE_CLI_PAIRS = 56
MIXTURE_CONFIG = "chairs_uflow_elbo_mixture.json"
MSE_CONFIG = "chairs_uflow_mse.json"
SOLVE_REPEATS = 5


def phase_mse_kernels(dev, smi):
    """Both kernels at the MSE step's level shapes, 384x512 batch 16 (one
    direction), as ``kernels_at_levels``."""
    return kernels_at_levels({"mse_b16": level_shapes(MB, MH, MW)},
                             SEED + 11, dev, smi)


def trained_steps(tag, trainer, steps, per_step, row):
    """``trainer.train()`` over its in-memory batches with the launches
    counted: ``steps`` finite steps of ``per_step`` + ``per_step``
    launches. Emits ``row`` with the metrics; returns the launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    rows = torch.stack(trainer.rows).cpu()
    emit({**row, "steps": trainer.i_iter, "seconds_incl_first_steps": seconds,
          "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          **{k: rows[:, i].tolist() for i, k in enumerate(trainer.KEY_METERS)}})
    if trainer.i_iter != steps or len(rows) != steps:
        raise AssertionError(f"({tag}) {trainer.i_iter} steps, not {steps}")
    if not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"({tag}) non-finite training metrics")
    want = per_step * steps
    if launches != {"cost_volume": want, "cost_volume_bwd": want}:
        raise AssertionError(f"({tag}) {steps} steps launched {launches}, "
                             f"not {want} + {want}")
    return launches


def phase_mixture_train(dev, smi):
    """chairs_uflow_elbo_mixture.json's model with MixtureWeightsNet (two
    pyramids) and its loss (n_samples 6) at 256x448 b4 on shifted
    textures: one step in training mode against the plain cost volume and
    float64, BatchNorm statistics included (``step_check``); ELBO_STEPS
    steps through ``UFlowElboTrainer.train()``, whose BatchNorms count 2
    updates per step, with the weights of both directions summing to 1;
    the step timed and profiled; and ``train_main`` (``mixture_cli``)."""
    log = logging.getLogger("chip_smoke")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    cfg = prob_config(MIXTURE_CONFIG, {})
    if not cfg.model.mixture_weights or get_trainer(cfg.trainer) is not UFlowElboTrainer:
        raise AssertionError(f"{MIXTURE_CONFIG}: no mixture weights net, or "
                             f"trainer {cfg.trainer!r}")
    model = get_model(cfg.model, device=dev, seed=SEED)
    loss = get_loss(cfg.loss)
    batches = []
    for dy, dx in ((1, 2), (2, -3), (-3, 1)):
        a, b = shifted_pair(EB, EH, EW, dy, dx, gen, dev)
        batches.append({"img1": a, "img2": b})
    noise = elbo_noise(cfg.loss, EB, EH // 4, EW // 4, gen, dev)

    def forward_loss(net, inputs, draws, train):
        res = net(inputs["img1"], inputs["img2"], with_bk=True, train=train)
        return loss(res, inputs["img1"], inputs["img2"], noise=draws)

    failure = step_check(forward_loss, model, batches[0], noise,
                         {"phase": "mixture_train_step_check",
                          "config": MIXTURE_CONFIG, "n_samples": cfg.loss.n_samples,
                          "shape": [EB, EH, EW]}, train=True)

    train_cfg = cfg.train.copy()
    train_cfg.update(epoch_num=1, seed=SEED)
    trainer = RecordingElboTrainer(
        [batches[i % len(batches)] for i in range(ELBO_STEPS)], None, model,
        loss, log, os.path.join(REPO, "outputs", "chip_smoke"), train_cfg,
        model_cfg=cfg.model, full_cfg=cfg)
    launches = trained_steps("mixture", trainer, ELBO_STEPS, 4,
                             {"phase": "mixture_train", "config": MIXTURE_CONFIG,
                              "shape": [EB, EH, EW]})
    stem_bn = model._mixture_weights_net.resnet.conv1[1]
    x = batches[0]
    with torch.no_grad():
        res = model(x["img1"], x["img2"], with_bk=True)
    weights = torch.stack([res["weights_fw"], res["weights_bw"]])
    sums_err = float((weights.sum(-1) - 1).abs().max())
    emit({"phase": "mixture_weights", "weights_fw": res["weights_fw"].tolist(),
          "weights_bw": res["weights_bw"].tolist(), "sum_err": sums_err,
          "bn_updates": int(stem_bn.num_batches_tracked),
          "stem_running_var_mean": float(stem_bn.running_var.mean())})
    if not (weights.shape == (2, EB, 2) and bool(torch.isfinite(weights).all())
            and sums_err <= 1e-6):
        raise AssertionError(f"mixture weights {weights.tolist()}")
    if int(stem_bn.num_batches_tracked) != 2 * ELBO_STEPS:
        raise AssertionError(f"{int(stem_bn.num_batches_tracked)} BatchNorm "
                             f"updates in {ELBO_STEPS} steps")
    step_time("mixture_train", lambda: trainer.train_step(x["img1"], x["img2"]),
              EB, [EB, EH, EW], smi,
              ranges={"mixture_weights_net": (uflow_prob_module,
                                              "add_mixture_weights")})
    del trainer, model
    if failure:
        raise AssertionError(failure)
    return launches


def mixture_cli_config(root, save_root, epochs, resume=None):
    """``configs/chairs_uflow_elbo_mixture.json``'s model, loss and train
    sections, with chairs_uflow_elbo.json's data section (its own is the
    older schema neither package reads) at ``root``, and ``epochs`` epochs
    of 3 steps that each validate with AUC and save."""
    cfg = load_config(os.path.join(REPO, "configs", MIXTURE_CONFIG))
    cfg.data = elbo_cli_config(root, save_root, epochs).data
    cfg.save_root = save_root
    cfg.train.update(epoch_num=epochs, epoch_size=ELBO_CLI_EPOCH_SIZE,
                     valid_freq=1, save_iter=0, track_auc=True)
    if resume is not None:
        cfg.train.resume = resume
    return cfg


def cli_runs(tag, make_cfg, trainer_cls, tmp, dev, smi, batch, launches_want,
             valid_names, want_images, n_valid, shape=(MH, MW)):
    """``train_main`` of ``make_cfg(save_root, epochs, resume)``: run A, 2
    epochs of 3 steps with validation of ``n_valid`` pairs, its image
    summaries ``want_images`` (``check_valid_images``) and checkpoints
    (``{tag}_cli_train``); then ``resume_runs``. Returns run A's
    launches."""
    log = logging.getLogger("chip_smoke")
    steps_per_epoch = ELBO_CLI_EPOCH_SIZE + 1
    n_steps = CLI_EPOCHS * steps_per_epoch
    dir_a = os.path.join(tmp, f"{tag}_a")
    probe = EntryPointProbe(trainer_cls)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with probe.active():
        run_a = train_main(make_cfg(dir_a, CLI_EPOCHS, None), log, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    rows = torch.stack([st["metrics"] for st in probe.steps]).cpu()
    files = sorted(os.listdir(dir_a))
    valid = {name: events_of(dir_a, f"Valid_{name}_0") for name in valid_names}
    laps = [st["data_s"] + st["batch_s"] for st in probe.steps]
    want = launches_want(n_steps)
    valid_images = check_valid_images(f"{tag}_cli", dir_a, want_images,
                                range(1, CLI_EPOCHS + 1))
    valid_s = sum(probe.seconds["_validate_with_gt"])
    save_s = sum(probe.seconds["save_model"])
    emit({"phase": f"{tag}_cli_train", "run": "A", "shape": [batch, *shape],
          "epochs": run_a.i_epoch, "steps": run_a.i_iter, "launches": launches,
          "launches_want": want, "losses": rows[:, 0].tolist(), "valid": valid,
          "best_error": run_a.best_error, "files": files,
          "seconds_train_main": seconds,
          "samples_per_s": batch * len(laps) / sum(laps),
          "validation_s": valid_s,
          "validation_ms_per_pair": 1e3 * (valid_s - save_s) / (n_valid * CLI_EPOCHS),
          **valid_images,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    if (run_a.i_iter, run_a.i_epoch, len(rows)) != (n_steps, CLI_EPOCHS, n_steps):
        raise AssertionError(f"({tag}) run A: {run_a.i_iter} steps in "
                             f"{run_a.i_epoch} epochs, not {n_steps} in {CLI_EPOCHS}")
    if launches != want:
        raise AssertionError(f"({tag}) run A launched {launches}, not {want}")
    if not (bool(torch.isfinite(rows).all())
            and all(len(v) == CLI_EPOCHS and np.isfinite(v).all()
                    for v in valid.values())):
        raise AssertionError(f"({tag}) run A: non-finite losses or validation {valid}")
    first = valid[valid_names[0]]
    if run_a.best_error != min(first):
        raise AssertionError(f"({tag}) best checkpoint on {run_a.best_error}, "
                             f"not the validation {valid_names[0]} {first}")
    missing = {"Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar",
               "events.jsonl"} - set(files)
    if missing:
        raise AssertionError(f"({tag}) run A wrote no {sorted(missing)}")
    del run_a
    resume_runs(tag, make_cfg, trainer_cls, tmp, dev, valid_names[0])
    return launches


def resume_runs(tag, make_cfg, trainer_cls, tmp, dev, valid_name):
    """``train_main`` of ``make_cfg(save_root, epochs, resume)``: run B, 1
    epoch that saves; run C, a resume of B's checkpoint to 2 epochs, which
    must restore weights, buffers, Adam state, schedule count, generator
    and counters bit for bit and go on from B's iteration. Emits
    ``{tag}_cli_resume``."""
    log = logging.getLogger("chip_smoke")
    steps_per_epoch = ELBO_CLI_EPOCH_SIZE + 1
    n_steps = CLI_EPOCHS * steps_per_epoch
    dir_b, dir_c = os.path.join(tmp, f"{tag}_b"), os.path.join(tmp, f"{tag}_c")
    run_b = train_main(make_cfg(dir_b, 1, None), log, device=dev)
    ckpt_b = os.path.join(dir_b, "Chairs_ckpt.pth.tar")
    restored = {}
    restore = BaseTrainer._restore_resume

    def restore_and_copy(trainer):
        restore(trainer)
        restored.update(trainer_state(trainer))

    probe_c = EntryPointProbe(trainer_cls)
    with mock.patch.object(BaseTrainer, "_restore_resume", restore_and_copy), \
            probe_c.active():
        run_c = train_main(make_cfg(dir_c, CLI_EPOCHS, ckpt_b), log, device=dev)
    want_b = trainer_state(run_b)
    differ = sorted(k for k in want_b if not same_state(restored.get(k), want_b[k]))
    iters = [st["i_iter"] for st in probe_c.steps]
    emit({"phase": f"{tag}_cli_resume", "restored": sorted(restored),
          "differ_from_saved": differ,
          "buffers_restored": sum(1 for _ in run_b.model.buffers()),
          "resumed_iters": iters, "final_iter": run_c.i_iter,
          "final_epoch": run_c.i_epoch,
          f"valid_{valid_name}": events_of(dir_c, f"Valid_{valid_name}_0")})
    if not restored or differ:
        raise AssertionError(f"({tag}) resume restored {sorted(restored)}; "
                             f"differs: {differ}")
    if iters != list(range(steps_per_epoch, n_steps)) or (
            run_c.i_iter, run_c.i_epoch) != (n_steps, CLI_EPOCHS):
        raise AssertionError(f"({tag}) resumed run: iterations {iters}, ended "
                             f"at {run_c.i_iter} in epoch {run_c.i_epoch}")


def phase_mixture_cli(dev, smi):
    """``train_main`` with the mixture config on the cli phase's directory
    (written anew): validation with the weights, entropy and AUC, both
    checkpoints and a resume, BatchNorm buffers included. Under
    ``PerSampleDraws``, as the cli phase."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mixture_cli_")
    try:
        with PerSampleDraws(SEED).active():
            root = os.path.join(tmp, "chairs")
            os.makedirs(root)
            write_chairs_dir(root, dev)
            return cli_runs(
                "mixture", lambda d, e, r: mixture_cli_config(root, d, e, r),
                UFlowElboTrainer, tmp, dev, smi, EB,
                # the config's valid batch is 1: 2 forwards per validation
                lambda n: {"cost_volume": 4 * n + 8 * CLI_EPOCHS,
                           "cost_volume_bwd": 4 * n},
                ("Loss", "EPE", "AUC", "entropy"),
                # two components, each with its weight drawn on
                {"Valid/gt_0", "Valid/pred_0_0", "Valid/pred_0_1",
                 "Valid/entropy_0", "Valid/sample_flows_0", "Valid/occu_masks_0",
                 "Valid/valid_masks_0"}
                | ({"Valid/splot_0"} if matplotlib_imports() else set()), 2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mse_batches(gen, dev):
    """Three batches of shifted textures at 384x512 b16, the shift as the
    ground-truth flow, (u, v) = (dx, dy)."""
    batches = []
    for dy, dx in ((1, 2), (2, -3), (-3, 1)):
        a, b = shifted_pair(MB, MH, MW, dy, dx, gen, dev)
        flow = torch.tensor([float(dx), float(dy)], device=dev).expand(MB, MH, MW, 2)
        batches.append({"img1": a, "img2": b,
                        "target": {"flow": flow.contiguous()}})
    return batches


def time_solve(dev, smi, step_ms):
    """``backward_substitution`` at the MSE step's level 2 (96x128, b16,
    C=2) as the loss calls it (diagonally dominant bands from the seed),
    alone and with its adjoint: device ms by CUDA events (the host's launch
    gaps included: one Python step per anti-diagonal) and by the profiler,
    as shares of the step's device time."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    h, w = MH // 4, MW // 4
    left = 0.5 * torch.randn((MB, h, w - 1, 2), generator=gen, device=dev)
    over = 0.5 * torch.randn((MB, h - 1, w, 2), generator=gen, device=dev)
    diag = (torch.exp(torch.randn((MB, h, w, 2), generator=gen, device=dev))
            + F.pad(left.abs(), (0, 0, 1, 0)) + F.pad(over.abs(), (0, 0, 0, 0, 1, 0)))
    zero = torch.zeros((MB, h - 1, w - 1, 2), device=dev)
    eps = torch.randn((MB, h, w, 2), generator=gen, device=dev)
    dy = torch.randn((MB, h, w, 2), generator=gen, device=dev)
    bands = [t.requires_grad_() for t in (diag, left, over)]

    def solve():
        with torch.no_grad():
            return backward_substitution(diag, left, over, zero, eps)

    def solve_and_adjoint():
        y = backward_substitution(*bands, zero, eps)
        return torch.autograd.grad(y, bands, dy)

    y = solve()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("backward_substitution overflowed")
    fwd_ms = cuda_ms(solve, iters=SOLVE_REPEATS, warmup=1)
    both_ms = cuda_ms(solve_and_adjoint, iters=SOLVE_REPEATS, warmup=1)
    prof = profile_window(solve_and_adjoint, 2, both_ms)
    row = {"phase": "mse_solve_time", "shape": [MB, h, w, 2],
           "diagonals": h + w - 1, "solve_ms": fwd_ms,
           "solve_and_adjoint_ms": both_ms, "adjoint_ms": both_ms - fwd_ms,
           "device_ms_solve_and_adjoint": prof["device_ms_per_call"],
           "busy_share": prof["busy_share"],
           "launches_solve_and_adjoint": prof["kernel_launches_per_call"],
           "share_of_step_device_ms": prof["device_ms_per_call"] / step_ms,
           "card": smi}
    emit(row)
    return row


def phase_mse_train(dev, smi):
    """chairs_uflow_mse.json (out_channels 8 with inv_cov: the 3-band
    precision factor, diagonally dominant, sampled through
    ``backward_substitution``) at 384x512 b16 on shifted textures whose
    ground truth is the shift: one step against the plain cost volume and
    float64; MSE_STEPS steps through ``MseTrainer.train()``; the step
    timed and profiled, and the solve alone; MSE_OVERFIT_STEPS steps on one
    fixed batch under fixed noise must lower its MSE; and ``train_main``
    (``mse_cli``)."""
    log = logging.getLogger("chip_smoke")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cfg = prob_config(MSE_CONFIG, {})
    if get_trainer(cfg.trainer) is not MseTrainer:
        raise AssertionError(f"{MSE_CONFIG} names trainer {cfg.trainer!r}")
    model = get_model(cfg.model, device=dev, seed=SEED)
    loss = get_loss(cfg.loss)
    batches = mse_batches(gen, dev)
    noise = {"eps": torch.randn((cfg.loss.n_samples * MB, MH // 4, MW // 4, 2),
                                generator=gen, device=dev)}

    def forward_loss(net, inputs, draws, train):
        res = net(inputs["img1"], inputs["img2"], with_bk=False, train=train)
        return loss(res, inputs["gt"], noise=draws)

    x = batches[0]
    gt = x["target"]["flow"]
    inputs = {"img1": x["img1"], "img2": x["img2"], "gt": gt}
    with torch.no_grad():
        first = forward_loss(model, inputs, noise, False)
    # Random weights could make the precision factor's solve overflow in
    # float32, as setup (c) of the prob phases does without its
    # log-diagonal shift; diag_dominant keeps this one finite unshifted.
    emit({"phase": "mse_first_forward", "log_diag_shift": 0.0,
          **{k: float(v) for k, v in first.items()}})
    if not all(np.isfinite(float(v)) for v in first.values()):
        raise AssertionError(f"MSE loss at random weights: {first}")
    failure = step_check(forward_loss, model, inputs, noise,
                         {"phase": "mse_train_step_check", "config": MSE_CONFIG,
                          "shape": [MB, MH, MW]})

    train_cfg = cfg.train.copy()
    train_cfg.update(epoch_num=1, seed=SEED)
    trainer = RecordingMseTrainer(
        [batches[i % len(batches)] for i in range(MSE_STEPS)], None, model,
        loss, log, os.path.join(REPO, "outputs", "chip_smoke"), train_cfg,
        model_cfg=cfg.model, full_cfg=cfg)
    launches = trained_steps("mse", trainer, MSE_STEPS, 4,
                             {"phase": "mse_train", "config": MSE_CONFIG,
                              "shape": [MB, MH, MW]})
    prof = step_time(
        "mse_train", lambda: trainer.train_step(x["img1"], x["img2"], gt),
        MB, [MB, MH, MW], smi,
        ranges={"triag_solve": (mse_loss_module, "backward_substitution")},
        groups={"triag_solve_adjoint": ("autograd::engine::evaluate_function: "
                                        "_BackwardSubstitutionBackward",)},
        census=None)
    time_solve(dev, smi, prof["device_ms_per_call"])
    del trainer

    # Overfit: MSE_OVERFIT_STEPS steps on one batch under one fixed draw,
    # dropout off, must lower that batch's MSE term.
    model.level_dropout = 0.0
    fixed = FixedNoise(loss, noise)

    def batch_mse():
        with torch.no_grad():
            return float(fixed(model(x["img1"], x["img2"], with_bk=False), gt)["l_mse"])

    before = batch_mse()
    train_cfg.update(epoch_size=MSE_OVERFIT_STEPS)
    trainer = MseTrainer([x] * MSE_OVERFIT_STEPS, None, model, fixed, log,
                         os.path.join(REPO, "outputs", "chip_smoke"), train_cfg,
                         model_cfg=cfg.model, full_cfg=cfg)
    trainer.train()
    after = batch_mse()
    emit({"phase": "mse_overfit", "batch": [MB, MH, MW], "steps": trainer.i_iter,
          "l_mse_untrained": before, "l_mse_after": after})
    if trainer.i_iter != MSE_OVERFIT_STEPS or not (np.isfinite(after)
                                                  and after < before):
        raise AssertionError(f"{trainer.i_iter} steps on one batch: MSE "
                             f"{before} -> {after}")
    del trainer, model
    if failure:
        raise AssertionError(failure)
    return launches


def mse_cli_config(root, save_root, epochs, resume=None):
    """``configs/chairs_uflow_mse.json`` with both data roots at ``root``
    (the train entry reads the ``.flo`` ground truth), ``epochs`` epochs of
    3 steps that each validate (EPE) and save; the rest (batch 16, no
    augmentation, Adam, 4 workers) as the config has it."""
    cfg = load_config(os.path.join(REPO, "configs", MSE_CONFIG))
    for entry in cfg.data:
        entry.root_chairs = root
    cfg.save_root = save_root
    cfg.train.update(epoch_num=epochs, epoch_size=ELBO_CLI_EPOCH_SIZE,
                     valid_freq=1, save_iter=0)
    if resume is not None:
        cfg.train.resume = resume
    return cfg


def phase_mse_cli(dev, smi):
    """``train_main`` with chairs_uflow_mse.json on MSE_CLI_PAIRS pairs
    with ``.flo`` ground truth: EPE validation, the ``Chairs`` checkpoints
    and a resume."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mse_cli_")
    try:
        root = os.path.join(tmp, "chairs")
        os.makedirs(root)
        write_chairs_dir(root, dev, MSE_CLI_PAIRS)
        n_valid = 4
        return cli_runs(
            "mse", lambda d, e, r: mse_cli_config(root, d, e, r), MseTrainer,
            tmp, dev, smi, MB,
            lambda n: {"cost_volume": 4 * n + 4 * n_valid * CLI_EPOCHS,
                       "cost_volume_bwd": 4 * n},
            ("EPE",), {"Valid/gt_0", "Valid/pred_0"}, n_valid)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Serving and tool entry points: torch.export artifacts, arflow-torch-stream
# and arflow-torch-fit-penalty.
# (key, config, batch, H, W, kind, cost-volume launches per output). The
# config: None for chairs_uflow.json, a shipped config's name, or a model
# section (the PWC-Lite family, which no shipped config uses).
PWCLITE_CFG = {"type": "pwclite", "n_frames": 2}
PWCLITE3_CFG = {"type": "pwclite", "n_frames": 3}
EXPORT_SETUPS = (
    ("uflow_b8", None, B, H, W, "mono", 4),
    ("uflow_stream_b1", None, 1, H, W, "stream", 4),
    ("prob_a_b8", "sintel_uflow_elbo_inference.json", PB, PH, PW, "mono", 4),
    ("pwclite_b8", PWCLITE_CFG, B, H, W, "mono", 5),
    ("pwclite3_stream_b1", PWCLITE3_CFG, 1, H, W, "stream", 10),
)
EXPORT_STREAM_FRAMES = 8
EXPORT_TIMING_ITERS = 10
CLI_STREAM_FRAMES = 24
PENALTY_PAIRS, PENALTY_H, PENALTY_W = 16, 384, 512

# Loads the artifacts in a fresh interpreter that imports the op
# registration and not the models, runs each on the inputs the parent
# saved, counts the cost-volume launches, holds the outputs to the eager
# ones and times the forwards (CUDA events) and the stream (host clock).
_ARTIFACT_CHILD = r"""
import json, sys, time
import torch
from arflow_tpu_torch.ops.cuda import COST_VOLUME, reset_launch_counts
from arflow_tpu_torch.serving.export import load_artifact, load_streaming_artifact
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

def gap(a, b):
    return float((a - b).abs().max()), float(b.abs().max())

def cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

out = []
for case in json.loads(sys.argv[1]):
    data = torch.load(case["data"])
    t0 = time.perf_counter()
    if case["kind"] == "mono":
        art = load_artifact(case["path"])
        load_s = time.perf_counter() - t0
        a, b = data["img1"].cuda(), data["img2"].cuda()
        reset_launch_counts()
        flow, ent = art(a, b)
        torch.cuda.synchronize()
        launches = [COST_VOLUME.launches]
        errs = {"flow": gap(flow, data["flow"].cuda()),
                "entropy": gap(ent, data["entropy"].cuda())}
        ms = cuda_ms(lambda: art(a, b), case["iters"])
        rate = {"ms_per_batch": ms, "maps_per_s": a.shape[0] / (ms / 1e3)}
    else:
        art = load_streaming_artifact(case["path"])
        load_s = time.perf_counter() - t0
        seq = [f.cuda() for f in data["frames"]]
        launches, errs = [], {"flow": (0.0, 0.0)}
        for f in seq:
            reset_launch_counts()
            res = art.push(f)
            torch.cuda.synchronize()
            if res is not None:  # the window is full
                launches.append(COST_VOLUME.launches)
                e, s = gap(res["flow"], data["flows"][len(launches) - 1].cuda())
                errs["flow"] = (max(e, errs["flow"][0]), max(s, errs["flow"][1]))
        t0 = time.perf_counter()
        for _ in range(2):
            for f in seq:
                art.push(f)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rate = {"flows_per_s": 2 * len(seq) / dt,
                "outputs": [len(launches), len(data["flows"])]}
    out.append({"key": case["key"], "load_s": load_s, "launches": launches,
                "errs": errs, **rate})
bad = sorted(m for m in sys.modules
             if m.startswith(("arflow_tpu_torch.models", "arflow_tpu_torch.training",
                              "jax", "arflow_tpu.")))
print(json.dumps({"cases": out, "imported": bad}))
"""


def export_config(name):
    """The config of an ``EXPORT_SETUPS`` entry."""
    if name is None:
        return load_config(CONFIG)
    if isinstance(name, dict):
        return Config({"model": name, "loss": {}})
    return prob_config(name, {})


def phase_export(dev, smi, tmp):
    """``torch.export`` artifacts of the serving forward on the card:
    chairs_uflow.json at 384x640 b8 and its streaming programs at b1, setup
    (a) with its entropy at 448x1024 b8, the 2-frame PWCLite at 384x640 b8
    and the 3-frame PWCLite's streaming window at b1. Each is exported,
    saved, loaded in a fresh interpreter that must not import the models,
    run and held to the eager model within FLOW_RTOL x max, with 4
    cost-volume launches per forward (5 for the PWCLite, 10 per 3-frame
    window). Returns the launches per artifact."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    cases, rows, wants = [], {}, {}
    for key, name, b, h, w, kind, want in EXPORT_SETUPS:
        cfg = export_config(name)
        wants[key] = want
        model = (prob_model(cfg, dev) if isinstance(name, str)
                 else get_model(cfg.model, device=dev, seed=SEED))
        sd = model.state_dict()
        path = os.path.join(tmp, f"{key}.afx")
        data = os.path.join(tmp, f"{key}.pt")
        t0 = time.perf_counter()
        if kind == "mono":
            ep, meta = export_inference(cfg, sd, b, (h, w), device=dev)
            save_artifact(path, ep, meta)
        else:
            eps, meta = export_streaming(cfg, sd, b, (h, w), device=dev)
            save_streaming_artifact(path, eps, meta)
        export_s = time.perf_counter() - t0
        with torch.inference_mode():
            if kind == "mono":
                img1, img2 = shifted_pair(b, h, w, 2, 3, gen, dev)

                def forward():
                    res = model(img1, img2, with_bk=False)
                    flow = res["flows_fw"][0][..., :2]
                    ent = (entropy_of(res, cfg.loss, dev) if "approx" in cfg.loss
                           else torch.zeros_like(flow))
                    return flow, ent

                flow, ent = forward()
                ms = cuda_ms(forward, iters=EXPORT_TIMING_ITERS)
                eager = {"eager_ms_per_batch": ms, "eager_maps_per_s": b / (ms / 1e3)}
                torch.save({"img1": img1.cpu(), "img2": img2.cpu(),
                            "flow": flow.cpu(), "entropy": ent.cpu()}, data)
            else:
                tex = texture(1, h + 64, w + 64, gen, dev)
                seq = [tex[:, :, 2 * t:2 * t + h, 3 * t:3 * t + w]
                       .permute(0, 2, 3, 1).contiguous()
                       for t in range(EXPORT_STREAM_FRAMES)]
                engine = StreamingFlowEngine(cfg.model, sd, device=dev)
                flows = [o["flow"] for o in map(engine.push, seq) if o is not None]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    for f in seq:
                        engine.push(f)
                torch.cuda.synchronize()
                eager = {"eager_flows_per_s": 2 * len(seq) / (time.perf_counter() - t0)}
                torch.save({"frames": [f.cpu() for f in seq],
                            "flows": [f.cpu() for f in flows]}, data)
        rows[key] = {"kind": kind, "shape": [b, h, w],
                     "config": name or "chairs_uflow.json",
                     "export_s": export_s, "bytes": os.path.getsize(path), **eager}
        cases.append({"key": key, "kind": kind, "path": path, "data": data,
                      "iters": EXPORT_TIMING_ITERS})
        del model
    # Free the parent's cached blocks: a serving process has the card to
    # itself. With them held, the child ran the b8 forward in 37 ms against
    # 71 ms with the card free (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
    # Findings), its flows 4.6e-5 from the eager model's: other convolution
    # algorithms, the cause not isolated yet.
    torch.cuda.empty_cache()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", _ARTIFACT_CHILD, json.dumps(cases)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"artifact process failed:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    failures, launches = [], {}
    for res in child["cases"]:
        row = rows[res["key"]]
        want = wants[res["key"]]
        launches[res["key"]] = sum(res["launches"])
        errs = {k: {"max_abs_err": e, "atol": FLOW_RTOL * max(s, 1.0)}
                for k, (e, s) in res["errs"].items()}
        row.update(load_s=res["load_s"], launches=res["launches"], errs=errs,
                   card_free_gb_at_load=free_gb,
                   **{k: res[k] for k in ("ms_per_batch", "maps_per_s",
                                          "flows_per_s", "outputs")
                                if k in res})
        emit({"phase": "export", "key": res["key"], **row, "card": smi})
        if any(n != want for n in res["launches"]):
            failures.append(f"{res['key']}: launches {res['launches']}, not {want} each")
        if "outputs" in res and res["outputs"][0] != res["outputs"][1]:
            failures.append(f"{res['key']}: {res['outputs'][0]} streamed flows, "
                            f"not the eager engine's {res['outputs'][1]}")
        for k, e in errs.items():
            if not e["max_abs_err"] <= e["atol"]:
                failures.append(f"{res['key']} {k}: {e['max_abs_err']} > {e['atol']}")
    if child["imported"]:
        failures.append(f"the artifact process imported {child['imported']}")
    if failures:
        raise AssertionError("export: " + "; ".join(failures))
    return launches


def write_png_frames(root, n, h, w, dev) -> list:
    """``n`` PNG frames through PIL: a seeded texture moving (2, 3) px per
    frame."""
    from PIL import Image

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    tex = texture(1, h + 3 * n, w + 3 * n, gen, dev)
    os.makedirs(root, exist_ok=True)
    paths = []
    for t in range(n):
        px = (tex[0, :, 2 * t:2 * t + h, 3 * t:3 * t + w].permute(1, 2, 0) * 255)
        path = os.path.join(root, f"frame_{t:04d}.png")
        Image.fromarray(px.round().to(torch.uint8).cpu().numpy()).save(path)
        paths.append(path)
    return paths


def phase_stream_cli(dev, smi, tmp):
    """``arflow-torch-stream`` on 24 PNG frames at 384x640 written here:
    ``-c/-m`` a ``.pth.tar`` of chairs_uflow.json's model, without and
    with ``--bw``, then ``--artifact`` with the streaming artifact of phase
    export (the same weights). Every ``.flo`` within FLOW_RTOL x max of
    ``StreamingFlowEngine.push`` on the same decoded frames, 4 (8 with
    ``--bw``) launches per flow; steady flows/s, the decode thread's ms
    per frame and the loop's share of wall time waiting on the queue."""
    from arflow_tpu_torch.serving.engine import _decode_frame

    paths = write_png_frames(os.path.join(tmp, "frames"), CLI_STREAM_FRAMES, H, W, dev)
    cfg = load_config(CONFIG)
    model = get_model(cfg.model, device="cpu", seed=SEED)
    ckpt = os.path.join(tmp, "uflow.pth.tar")
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)
    engine = StreamingFlowEngine(cfg.model, model.state_dict(), with_bw=True,
                                 device=dev)
    want = {}
    with torch.inference_mode():
        for p in paths:
            out = engine.push(_decode_frame(p, None))
            if out is not None:
                stem = os.path.splitext(os.path.basename(p))[0]
                want[stem + ".flo"] = out["flow"][0].cpu().numpy()
                want[stem + "_bw.flo"] = out["flow_bw"][0].cpu().numpy()
    eager = ["-c", CONFIG, "-m", ckpt, "--device", str(dev)]
    runs = [("fw", eager, 4), ("bw", eager + ["--bw"], 8),
            ("artifact", ["--artifact", os.path.join(tmp, "uflow_stream_b1.afx")], 4)]
    failures, launches = [], {}
    for name, args, per_flow in runs:
        out_dir = os.path.join(tmp, f"flo_{name}")
        reset_launch_counts()
        t0 = time.perf_counter()
        stats = stream_cli([*args, "--frames", os.path.join(tmp, "frames"),
                            "--out", out_dir])
        wall = time.perf_counter() - t0
        launches[name] = COST_VOLUME.launches
        written = sorted(os.listdir(out_dir))
        err = scale = 0.0
        for f in written:
            got = read_flo(os.path.join(out_dir, f))
            err = max(err, float(np.abs(got - want[f]).max()))
            scale = max(scale, float(np.abs(want[f]).max()))
        n_flows = CLI_STREAM_FRAMES - 1
        expect_files = n_flows * (2 if name == "bw" else 1)
        tol = FLOW_RTOL * max(scale, 1.0)
        emit({"phase": "stream_cli", "run": name, "frames": stats["frames"],
              "flows": stats["flows"], "files": len(written),
              "launches": launches[name], "vs_engine_max_abs_err": err,
              "atol": tol, "steady_flows_per_s": stats["flows_per_sec"],
              "decode_ms_per_frame": 1e3 * stats["decode_s"] / stats["frames"],
              "queue_wait_share": stats["queue_wait_s"] / wall,
              "wall_s": wall, "shape": [1, H, W], "card": smi})
        if stats["flows"] != n_flows or len(written) != expect_files:
            failures.append(f"{name}: {stats['flows']} flows, {len(written)} files")
        if launches[name] != per_flow * n_flows:
            failures.append(f"{name}: {launches[name]} launches, not "
                            f"{per_flow * n_flows}")
        if not err <= tol:
            failures.append(f"{name}: .flo vs engine {err} > {tol}")
    if failures:
        raise AssertionError("stream_cli: " + "; ".join(failures))
    return launches


def write_chairs2_dir(root, dev) -> None:
    """``Chairs2``'s valid layout, ``val/{fid:07d}-img_{0,1}.png`` with
    ``-flow_01.flo`` / ``-flow_10.flo``: PENALTY_PAIRS seeded textures at
    PENALTY_H x PENALTY_W, the second moved by a per-pair whole shift, and
    as flows that shift plus a smooth field within +-0.5 px, forward and
    negated backward (so that both penalties see nonzero residuals)."""
    from PIL import Image

    val = os.path.join(root, "val")
    os.makedirs(val)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    for fid in range(PENALTY_PAIRS):
        dy, dx = (3 * fid) % 9 - 4, (5 * fid) % 9 - 4
        pair = shifted_pair(1, PENALTY_H, PENALTY_W, dy, dx, gen, dev)
        for i, img in enumerate(pair):
            px = (img[0] * 255).round().to(torch.uint8).cpu().numpy()
            Image.fromarray(px).save(os.path.join(val, f"{fid:07d}-img_{i}.png"))
        field = texture(1, PENALTY_H, PENALTY_W, gen, dev)[0, :2] - 0.5
        flow = (np.float32([dx, dy])
                + field.permute(1, 2, 0).cpu().numpy()).astype(np.float32)
        write_flo(os.path.join(val, f"{fid:07d}-flow_01.flo"), flow)
        write_flo(os.path.join(val, f"{fid:07d}-flow_10.flo"), -flow)


def phase_fit_penalty(dev, smi, tmp):
    """``arflow-torch-fit-penalty`` with chairs_uflow_elbo.json's loss on a
    Chairs2-format directory written here, for both penalties at
    ``--n_samples 2e5 --n_iter 10``: finite, positive ``pi`` summing to 1
    and a finite scale; the seconds of residual collection and of EM."""
    root = os.path.join(tmp, "chairs2")
    write_chairs2_dir(root, dev)
    with open(os.path.join(REPO, "configs", "chairs_uflow_elbo.json")) as f:
        raw = json.load(f)
    raw["data"] = [{"name": "Chairs2", "type": "valid", "n_frames": 2,
                    "split": "valid", "root_chairs": root}]
    cfg_path = os.path.join(tmp, "fit_penalty.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    failures = []
    for penalty in ("smooth", "data"):
        with contextlib.redirect_stdout(sys.stderr):  # its report, not a result
            res = fit_penalty_cli(["-c", cfg_path, "--penalty", penalty,
                                   "--n_samples", "2e5", "--n_iter", "10",
                                   "--device", str(dev)])
        pi, beta = res["pi"], res["beta"]
        ok = (bool(np.isfinite(pi).all()) and bool((pi > 0).all())
              and abs(float(pi.sum()) - 1.0) <= 1e-9
              and bool(np.isfinite(beta).all()) and np.isfinite(res["scale"]))
        emit({"phase": "fit_penalty", "penalty": penalty,
              "samples": res["samples"], "pi": pi.tolist(),
              "beta": beta.tolist(), "scale": res["scale"],
              "objective_first_last": [res["objectives"][0], res["objectives"][-1]],
              "collect_s": res["collect_s"], "em_s": res["em_s"],
              "pairs": PENALTY_PAIRS, "shape": [PENALTY_H, PENALTY_W], "card": smi})
        if not ok:
            failures.append(f"{penalty}: pi {pi.tolist()}, scale {res['scale']}")
    if failures:
        raise AssertionError("fit_penalty: " + "; ".join(failures))


def phase_serving_tools(dev, smi):
    """Phases export, stream_cli and fit_penalty in one temporary directory
    (stream_cli runs export's streaming artifact)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        seconds = {}
        t0 = time.perf_counter()
        export = phase_export(dev, smi, tmp)
        seconds["export"] = time.perf_counter() - t0
        stream = phase_stream_cli(dev, smi, tmp)
        seconds["stream_cli"] = time.perf_counter() - t0 - seconds["export"]
        phase_fit_penalty(dev, smi, tmp)
        seconds["fit_penalty"] = (time.perf_counter() - t0 - seconds["export"]
                                  - seconds["stream_cli"])
        return export, stream, seconds
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# model.dtype bfloat16 and the trainer switches (phases bf16, train_switches)

PEAK_BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, same data sheet
# bf16 against float32, mean relative gap per output level, as
# tests/test_mixed_precision.py:35 holds the JAX package's.
BF16_REL = 0.05
# A bf16 step against the float32 step from the same weights and draws.
# At random weights a bf16 step's gradients are mostly rounding noise (the
# CPU tests at 64x96: losses 4.3e-4 and 6.3e-5 apart relative, gradient
# cosines 0.67 and 0.52 for the uflow and ELBO steps), so the loss is held
# within 1e-2 and the gradients only in direction.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_COS = 0.3
# remat against the plain step, same weights and draws, deterministic cuDNN:
# the gradients' relative L2 gap (the recomputed forward runs the same ops;
# the atomics of grid_sample's and index_add's backward reorder sums).
REMAT_GRAD_RTOL = 1e-4
# The parameters after that step, in learning rates: Adam's first step moves
# each by about lr, so a gradient's sign flipped by reordered sums moves a
# parameter by up to 2 lr (measured: up to 0.08 lr on an H100 80GB HBM3).
REMAT_PARAM_LRS = 0.5
SWITCH_DROPOUT = 0.5  # level dropout of the remat check: levels do drop


def conv_flops(model, *args, **kwargs) -> int:
    """Floating-point operations (2 per multiply-add) of every conv and
    deconv in one call ``model(*args, **kwargs)``, counted from the layer
    shapes by forward hooks."""
    total = [0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.ConvTranspose2d):
            x = inputs[0]
            total[0] += 2 * x.numel() * m.out_channels * m.weight[0, 0].numel()
        else:
            total[0] += 2 * out.numel() * m.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def plain_round_trip(f1, f2, md=MD):
    """The plain cost volume behind ``compute_cost_volume``'s float32 round
    trip for bfloat16 features."""
    if f1.dtype == torch.bfloat16:
        return compute_cost_volume_reference(
            f1.float(), f2.float(), md).to(torch.bfloat16)
    return compute_cost_volume_reference(f1, f2, md)


def mean_rel(a, b) -> float:
    return float((a.double() - b).abs().mean() / b.double().abs().mean())


def bf16_model_cfg(model_cfg):
    return Config(dict(model_cfg, dtype="bfloat16"))


def check_bf16_outputs(name, outs16, outs32):
    """float32 outputs, finite, each level within BF16_REL of float32;
    returns the per-level gaps."""
    rel = [mean_rel(a, b) for a, b in zip(outs16, outs32)]
    if not all(o.dtype == torch.float32 for o in outs16):
        raise AssertionError(f"{name}: bf16 outputs not float32")
    if not all(bool(torch.isfinite(o).all()) for o in outs16):
        raise AssertionError(f"{name}: non-finite bf16 output")
    if not max(rel) < BF16_REL:
        raise AssertionError(f"{name}: bf16 vs float32 {rel} >= {BF16_REL}")
    return rel


def timed_pair(fn32, fn16, iters):
    """CUDA-event ms of float32 and bf16 callables in turns (32, 16, 16,
    32): the mean of each pair."""
    a = cuda_ms(fn32, iters=iters)
    b = cuda_ms(fn16, iters=iters)
    b2 = cuda_ms(fn16, iters=iters)
    a2 = cuda_ms(fn32, iters=iters)
    return (a + a2) / 2, (b + b2) / 2, [a, b, b2, a2]


def bf16_inference(cfg, dev, smi, gen):
    """chairs_uflow.json's PWCFlow at 384x640 b8, float32 and bf16 from one
    set of weights: outputs, the kernel against the plain round trip, the
    conv FLOPs and their bound, maps/s and the top kernels of each."""
    m32 = get_model(cfg.model, device=dev, seed=SEED)
    m16 = get_model(bf16_model_cfg(cfg.model), device=dev)
    m16.load_state_dict(m32.state_dict(), strict=True)
    img1, img2 = shifted_pair(B, H, W, 2, 3, gen, dev)
    torch.cuda.empty_cache()

    def f32():
        return m32(img1, img2, with_bk=False)["flows_fw"]

    def f16():
        return m16(img1, img2, with_bk=False)["flows_fw"]

    with torch.inference_mode():
        reset_launch_counts()
        out16 = f16()
        torch.cuda.synchronize()
        launches = COST_VOLUME.launches
        out32 = f32()
        with mock.patch.object(uflow_module, "compute_cost_volume",
                               plain_round_trip):
            plain16 = f16()
        torch.cuda.synchronize()
        if COST_VOLUME.launches != 2 * launches:
            raise AssertionError("bf16: the plain run launched the kernel")
        rel = check_bf16_outputs("uflow b8", out16, out32)
        scale = max(float(plain16[0].abs().max()), 1.0)
        err_plain = max_abs(out16[0], plain16[0])
        ms32, ms16, turns = timed_pair(f32, f16, iters=10)
        prof32 = profile_window(f32, 3, ms32)
        prof16 = profile_window(f16, 3, ms16)
    flops = conv_flops(m16, img1, img2, with_bk=False)
    bound_ms = 1e3 * flops / PEAK_BF16_FLOP_PER_S
    row = {"phase": "bf16_inference", "shape": [B, H, W], "launches": launches,
           "rel_gap_per_level_vs_f32": rel, "rel_bound": BF16_REL,
           "kernel_vs_plain_round_trip_max_abs_err": err_plain,
           "atol": FLOW_RTOL * scale,
           "ms_per_batch_f32": ms32, "ms_per_batch_bf16": ms16,
           "ms_turns_32_16_16_32": turns,
           "maps_per_s_f32": B / (ms32 / 1e3), "maps_per_s_bf16": B / (ms16 / 1e3),
           "conv_gflop": flops / 1e9, "conv_bound_ms_bf16": bound_ms,
           "conv_bound_ms_f32": 1e3 * flops / PEAK_F32_FLOP_PER_S,
           "conv_ms_f32": prof32["conv_ms_per_call"],
           "conv_ms_bf16": prof16["conv_ms_per_call"],
           "device_ms_f32": prof32["device_ms_per_call"],
           "device_ms_bf16": prof16["device_ms_per_call"],
           "cost_volume_ms_bf16": prof16["cost_volume_fwd_ms_per_call"],
           "top5_kernels_f32": prof32["top_kernels"][:5],
           "top5_kernels_bf16": prof16["top_kernels"][:5],
           "card": smi}
    emit(row)
    if launches != 4:
        raise AssertionError(f"bf16 forward launched the kernel {launches} times")
    if not err_plain <= FLOW_RTOL * scale:
        raise AssertionError(f"bf16 kernel vs plain round trip: {err_plain}")
    return m32, m16, launches


def bf16_casts(dev, smi):
    """Device ms of the cost volume's float32 round trip at the b8 384x640
    levels: both inputs to float32 and the output back to bf16, beside
    the kernel itself on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    cast_ms = kernel_ms = 0.0
    for shape in level_shapes(B):
        f1, f2 = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        out = cost_volume_kernel(f1.float(), f2.float(), MD)
        cast_ms += graph_ms(lambda: (f1.float(), f2.float()))
        cast_ms += graph_ms(lambda: out.to(torch.bfloat16))
        a, b = f1.float(), f2.float()
        kernel_ms += graph_ms(lambda: cost_volume_kernel(a, b, MD))
    emit({"phase": "bf16_casts", "shape": [B, H, W], "cast_ms_per_forward": cast_ms,
          "kernel_ms_per_forward": kernel_ms, "card": smi})
    return cast_ms


def bf16_prob(dev, smi, gen):
    """Setup (a) at 448x1024 b8 with its entropy, float32 and bf16."""
    cfg = prob_config(*PROB_SETUPS[0][1:])
    m32 = prob_model(cfg, dev)
    m16 = get_model(bf16_model_cfg(cfg.model), device=dev)
    m16.load_state_dict(m32.state_dict(), strict=True)
    img1, img2 = shifted_pair(PB, PH, PW, 2, 3, gen, dev)

    def forward(model):
        res = model(img1, img2, with_bk=False)
        return res["flows_fw"][0][..., :2], entropy_of(res, cfg.loss, dev)

    with torch.inference_mode():
        reset_launch_counts()
        flow16, ent16 = forward(m16)
        torch.cuda.synchronize()
        launches = COST_VOLUME.launches
        flow32, ent32 = forward(m32)
        rel = check_bf16_outputs("prob (a) b8", [flow16, ent16], [flow32, ent32])
        ms32, ms16, turns = timed_pair(lambda: forward(m32), lambda: forward(m16),
                                       iters=10)
    emit({"phase": "bf16_prob_inference", "setup": "a", "shape": [PB, PH, PW],
          "launches": launches, "rel_gap_flow_entropy_vs_f32": rel,
          "ms_per_batch_f32": ms32, "ms_per_batch_bf16": ms16,
          "ms_turns_32_16_16_32": turns,
          "maps_per_s_f32": PB / (ms32 / 1e3), "maps_per_s_bf16": PB / (ms16 / 1e3),
          "card": smi})
    if launches != 4:
        raise AssertionError(f"bf16 (a) launched the kernel {launches} times")
    return launches


def bf16_stream(cfg, m16, dev, smi, gen):
    """The 2-frame engine at 384x640 b1 in bf16: flows float32 and equal to
    the monolithic bf16 forward, flows/s beside the float32 engine's."""
    m = 4 * STREAM_FRAMES
    tex = texture(1, H + m, W + m, gen, dev)
    seq = [tex[:, :, 2 * t:2 * t + H, 3 * t:3 * t + W].permute(0, 2, 3, 1).contiguous()
           for t in range(STREAM_FRAMES)]
    state = m16.state_dict()
    engines = {dt: StreamingFlowEngine(
        cfg.model if dt == "float32" else bf16_model_cfg(cfg.model), state,
        device=dev) for dt in ("float32", "bfloat16")}
    eng = engines["bfloat16"]
    reset_launch_counts()
    outs = [eng.push(f) for f in seq]
    torch.cuda.synchronize()
    launches = COST_VOLUME.launches
    flows = [o["flow"] for o in outs if o is not None]
    err, scale = 0.0, 1.0
    with torch.inference_mode():
        for t in (0, len(flows) - 1):
            mono = m16(seq[t], seq[t + 1], with_bk=False)["flows_fw"][0]
            err = max(err, max_abs(flows[t], mono))
            scale = max(scale, float(mono.abs().max()))
    rates = {}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        e = engines[dt]
        for f in seq[:3]:
            e.push(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for f in seq:
                e.push(f)
        torch.cuda.synchronize()
        rates.setdefault(dt, []).append(3 * STREAM_FRAMES / (time.perf_counter() - t0))
    emit({"phase": "bf16_serving", "shape": [1, H, W], "launches": launches,
          "flow_dtype": str(flows[0].dtype), "vs_monolithic_max_abs_err": err,
          "atol": FLOW_RTOL * scale, "flows_per_s_f32": rates["float32"],
          "flows_per_s_bf16": rates["bfloat16"], "card": smi})
    if flows[0].dtype != torch.float32 or not err <= FLOW_RTOL * scale:
        raise AssertionError(f"bf16 stream: {flows[0].dtype}, {err}")
    if launches != 4 * (STREAM_FRAMES - 1):
        raise AssertionError(f"bf16 stream launched the kernel {launches} times")
    return launches


def bf16_export(cfg, m16, dev, smi, gen):
    """A bf16 monolithic artifact at 384x640 b1, saved, loaded and held to
    the eager bf16 model; 4 launches per forward."""
    from arflow_tpu_torch.serving.export import load_artifact

    full = Config({"model": dict(cfg.model, dtype="bfloat16"), "loss": cfg.loss})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        path = os.path.join(tmp, "uflow_bf16.afx")
        t0 = time.perf_counter()
        ep, meta = export_inference(full, m16.state_dict(), 1, (H, W), device=dev)
        save_artifact(path, ep, meta)
        export_s = time.perf_counter() - t0
        art = load_artifact(path)
        img1, img2 = shifted_pair(1, H, W, 1, 2, gen, dev)
        reset_launch_counts()
        flow, _ = art(img1, img2)
        torch.cuda.synchronize()
        launches = COST_VOLUME.launches
        with torch.inference_mode():
            want = m16(img1, img2, with_bk=False)["flows_fw"][0]
        err, scale = max_abs(flow, want), max(float(want.abs().max()), 1.0)
        emit({"phase": "bf16_export", "shape": [1, H, W], "export_s": export_s,
              "bytes": os.path.getsize(path), "launches": launches,
              "flow_dtype": str(flow.dtype), "vs_eager_max_abs_err": err,
              "atol": FLOW_RTOL * scale, "card": smi})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if flow.dtype != torch.float32 or launches != 4 or not err <= FLOW_RTOL * scale:
        raise AssertionError(f"bf16 artifact: {flow.dtype}, {launches} launches, "
                             f"{err} > {FLOW_RTOL * scale}")
    return launches


def step_gradients(model, forward_loss, gen_state, dev):
    """(loss, {name: gradient}) of one step's loss from the dropout
    generator state ``gen_state``."""
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    model.zero_grad(set_to_none=True)
    out = forward_loss(model, gen)
    out["total"].backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(out["total"].detach()), grads


def cosine(a, b) -> float:
    return float(F.cosine_similarity(a.double(), b.double(), dim=0))


def flat(grads) -> torch.Tensor:
    return torch.cat([grads[n].flatten() for n in sorted(grads)])


def bf16_step(tag, trainer_cls, cfg, forward_loss, inputs, batch, shape, dev, smi,
              census):
    """One step of ``cfg``'s model in float32 and bf16 from one set of
    weights and draws: the loss within BF16_LOSS_RTOL, the gradients'
    cosine at least BF16_GRAD_COS, the same parameters with gradients,
    8 + 8 (uflow) or 4 + 4 (ELBO) launches; then each dtype's device ms
    per ``train_step`` through ``trainer_cls``, in turns, and the bf16
    step's profile (``train_step_profile`` with ``census``)."""
    m32 = get_model(cfg.model, device=dev, seed=SEED)
    m16 = get_model(bf16_model_cfg(cfg.model), device=dev)
    m16.load_state_dict(m32.state_dict(), strict=True)
    state = torch.Generator(device=dev).manual_seed(SEED).get_state()
    loss32, g32 = step_gradients(m32, forward_loss, state, dev)
    reset_launch_counts()
    loss16, g16 = step_gradients(m16, forward_loss, state, dev)
    launches = {k.name: k.launches for k in KERNELS}
    finite = all(bool(torch.isfinite(g).all()) for g in g16.values())
    loss_rel = abs(loss16 - loss32) / abs(loss32)
    cos = cosine(flat(g16), flat(g32))
    rel = rel_l2(flat(g16), flat(g32).double())
    train_cfg = cfg.train.copy()
    train_cfg.update(epoch_num=1, seed=SEED)
    log = logging.getLogger("chip_smoke")
    trainers = {dt: trainer_cls([inputs], None, m, get_loss(cfg.loss), log,
                                os.path.join(REPO, "outputs", "chip_smoke"),
                                train_cfg, model_cfg=cfg.model, full_cfg=cfg)
                for dt, m in (("float32", m32), ("bfloat16", m16))}
    args = trainers["float32"]._batch_inputs(inputs)
    for t in trainers.values():
        t._ensure_init()
        for _ in range(2):
            t.train_step(*args)
    torch.cuda.synchronize()
    ms32, ms16, turns = timed_pair(lambda: trainers["float32"].train_step(*args),
                                   lambda: trainers["bfloat16"].train_step(*args),
                                   iters=5)
    grads_f32 = all(p.grad is None or p.grad.dtype == torch.float32
                    for p in m16.parameters())
    prof = train_step_profile(lambda: trainers["bfloat16"].train_step(*args), ms16,
                              census=census)
    emit({"phase": f"bf16_{tag}_profile", "shape": shape, **prof, "card": smi})
    emit({"phase": f"bf16_{tag}", "shape": shape, "launches": launches,
          "loss_f32": loss32, "loss_bf16": loss16, "loss_rel_gap": loss_rel,
          "loss_rtol": BF16_LOSS_RTOL, "grad_cosine": cos, "grad_cos_bound": BF16_GRAD_COS,
          "grad_rel_l2": rel, "params_with_grad": len(g16),
          "grads_float32": grads_f32, "finite": finite,
          "ms_per_step_f32": ms32, "ms_per_step_bf16": ms16,
          "ms_turns_32_16_16_32": turns,
          "samples_per_s_f32": batch * 1e3 / ms32,
          "samples_per_s_bf16": batch * 1e3 / ms16, "card": smi})
    if not (finite and grads_f32 and sorted(g16) == sorted(g32)
            and loss_rel <= BF16_LOSS_RTOL and cos >= BF16_GRAD_COS):
        raise AssertionError(f"bf16 {tag}: finite {finite}, float32 grads "
                             f"{grads_f32}, loss {loss_rel}, cosine {cos}")
    return launches


def phase_bf16(cfg, dev, smi):
    """``model.dtype`` bfloat16 on the card: the uflow b8 forward beside
    float32 (``bf16_inference``) and the cost volume's casts, setup (a) b8
    with its entropy, the b1 stream, an artifact, and the uflow and ELBO (a)
    train steps beside float32. Returns the kernel's launches per part."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    m32, m16, launches_fwd = bf16_inference(cfg, dev, smi, gen)
    del m32
    bf16_casts(dev, smi)
    launches = {"inference_b8": launches_fwd,
                "prob_a_b8": bf16_prob(dev, smi, gen),
                "stream_b1": bf16_stream(cfg, m16, dev, smi, gen),
                "export_b1": bf16_export(cfg, m16, dev, smi, gen)}
    del m16

    loss_cfg = cfg.loss.copy()
    loss_cfg.smooth_order = 1
    ucfg = Config({**cfg, "loss": loss_cfg})
    a, b = shifted_pair(TB, TH, TW, 1, 2, gen, dev)
    x = {"img1": a, "img2": b, "img1_ph": (a * 1.1).clamp(0.0, 1.0),
         "img2_ph": (b * 1.1).clamp(0.0, 1.0)}
    loss = get_loss(ucfg.loss)

    def uflow_loss(net, g):
        res = net(x["img1_ph"], x["img2_ph"], with_bk=True, train=True, generator=g)
        return loss(res, x["img1"], x["img2"])

    launches["train_step"] = bf16_step("train_step", UFlowTrainer, ucfg,
                                       uflow_loss, x, TB, [TB, TH, TW], dev, smi,
                                       census=(uflow_loss_module, "census_loss"))
    ecfg = prob_config(*ELBO_SETUPS[0][1:])
    ea, eb = shifted_pair(EB, EH, EW, 1, 2, gen, dev)
    noise = elbo_noise(ecfg.loss, EB, EH // 4, EW // 4, gen, dev)
    eloss = get_loss(ecfg.loss)

    def elbo_loss(net, g):
        res = net(ea, eb, with_bk=True, train=True, generator=g)
        return eloss(res, ea, eb, noise=noise)

    launches["elbo_step"] = bf16_step("elbo_step", UFlowElboTrainer, ecfg, elbo_loss,
                                      {"img1": ea, "img2": eb}, EB, [EB, EH, EW],
                                      dev, smi, census=(elbo_blocks_module,
                                                        "census_loss_no_penalty"))
    return launches


def switch_trainer(cfg, model, batches, **train):
    """A UFlowTrainer of ``cfg`` over ``batches`` with ``train`` set in its
    train section, initialised."""
    train_cfg = cfg.train.copy()
    train_cfg.update({"epoch_num": 1, "epoch_size": len(batches), "seed": SEED,
                      **train})
    trainer = UFlowTrainer(batches, None, model, get_loss(cfg.loss),
                           logging.getLogger("chip_smoke"),
                           os.path.join(REPO, "outputs", "chip_smoke"),
                           train_cfg, model_cfg=cfg.model, full_cfg=cfg)
    trainer._ensure_init()
    return trainer


def remat_runs(cfg, base, batches, args, deterministic=False):
    """One step of ``switch_trainer`` without and with ``train.remat``,
    each from a copy of ``base``, with cuDNN's deterministic algorithms
    (and torch's, with ``deterministic``): {remat: {"trainer", "peak_gb",
    "launches", "grads", "generator"}}, and the remat step's gradients'
    relative L2 distance from the plain step's (None where different
    parameters have gradients)."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    for remat in (False, True):
        t = switch_trainer(cfg, copy.deepcopy(base), batches, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t.train_step(*args)
        torch.cuda.synchronize()
        runs[remat] = {"trainer": t,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {k.name: k.launches for k in KERNELS},
                       "grads": {n: p.grad.clone() for n, p in t.model.named_parameters()
                                 if p.grad is not None},
                       "generator": t.generator.get_state()}
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    g0, g1 = runs[False]["grads"], runs[True]["grads"]
    grad_rel = rel_l2(flat(g1), flat(g0).double()) if sorted(g0) == sorted(g1) else None
    return runs, grad_rel


def phase_train_switches(cfg, dev, smi):
    """The trainer switches on the card, the uflow step at 256x448 b8:
    ``nan_revert`` (a NaN batch leaves the weights, the Adam state and the
    schedule's count bit for bit, counts in ``nan_skips``, and the next
    step proceeds; the step's ms with the switch on and off), ``remat``
    (level dropout SWITCH_DROPOUT: the step's gradients, the parameters
    after it and the generator against the plain step, the peak memory and
    ms of each) and ``stage1``
    (fires once). Returns the kernel's launches of the remat step."""
    loss_cfg = cfg.loss.copy()
    loss_cfg.smooth_order = 1
    scfg = Config({**cfg, "loss": loss_cfg})
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    batches = []
    for dy, dx in ((1, 2), (2, -3), (-3, 1)):
        a, b = shifted_pair(TB, TH, TW, dy, dx, gen, dev)
        batches.append({"img1": a, "img2": b, "img1_ph": a, "img2_ph": b})
    poisoned = dict(batches[1], img1_ph=batches[1]["img1_ph"].clone())
    poisoned["img1_ph"][0, 10, 10] = float("nan")

    model = get_model(scfg.model, device=dev, seed=SEED)
    trainer = switch_trainer(scfg, model, batches, nan_revert=True)
    args = [trainer._batch_inputs(x) for x in (batches[0], poisoned, batches[2])]
    trainer.train_step(*args[0])
    before = trainer_state(trainer)
    metrics = trainer.train_step(*args[1])
    after = trainer_state(trainer)
    reverted = all(same_state(before[k], after[k])
                   for k in ("state_dict", "optimizer", "opt_count"))
    skips = trainer.nan_skips
    trainer.train_step(*args[2])
    moved = not same_state(after["state_dict"], trainer_state(trainer)["state_dict"])
    plain = switch_trainer(scfg, model, batches)
    ms_off, ms_on, turns = timed_pair(lambda: plain.train_step(*args[0]),
                                      lambda: trainer.train_step(*args[0]), iters=5)
    emit({"phase": "nan_revert", "shape": [TB, TH, TW],
          "nan_loss": float(metrics[0]), "reverted_bit_for_bit": reverted,
          "nan_skips": skips, "next_step_moved": moved,
          "ms_per_step_off": ms_off, "ms_per_step_on": ms_on,
          "ms_turns_off_on_on_off": turns, "card": smi})
    if not (reverted and skips == 1 and moved and trainer.nan_skips == 1):
        raise AssertionError(f"nan_revert: reverted {reverted}, nan_skips "
                             f"{trainer.nan_skips}, next step moved {moved}")
    del trainer, plain, model

    # remat: two trainers from the same weights and seed, one step each.
    base = get_model(scfg.model, device=dev, seed=SEED)
    base.level_dropout = SWITCH_DROPOUT
    runs, grad_rel = remat_runs(scfg, base, batches, args[0])
    same_gen = torch.equal(runs[False]["generator"], runs[True]["generator"])
    lr = runs[False]["trainer"].optimizer.schedule(0)
    step_gap = max(float((p - q).detach().abs().max()) for p, q in zip(
        runs[False]["trainer"].model.parameters(),
        runs[True]["trainer"].model.parameters()))
    ms_off, ms_on, turns = timed_pair(
        lambda: runs[False]["trainer"].train_step(*args[0]),
        lambda: runs[True]["trainer"].train_step(*args[0]), iters=5)
    emit({"phase": "remat", "shape": [TB, TH, TW], "level_dropout": SWITCH_DROPOUT,
          "grad_rel_l2_vs_plain": grad_rel, "grad_rtol": REMAT_GRAD_RTOL,
          "same_generator_state": same_gen,
          "param_max_abs_gap_after_step": step_gap, "lr": lr,
          "param_bound": REMAT_PARAM_LRS * lr,
          "peak_memory_gb_plain": runs[False]["peak_gb"],
          "peak_memory_gb_remat": runs[True]["peak_gb"],
          "launches_plain": runs[False]["launches"],
          "launches_remat": runs[True]["launches"],
          "ms_per_step_plain": ms_off, "ms_per_step_remat": ms_on,
          "ms_turns_plain_remat_remat_plain": turns, "card": smi})
    if not (grad_rel is not None and grad_rel <= REMAT_GRAD_RTOL and same_gen
            and step_gap <= REMAT_PARAM_LRS * lr):
        raise AssertionError(f"remat: gradients {grad_rel}, generator {same_gen}, "
                             f"parameters {step_gap}")
    launches = runs[True]["launches"]
    if launches != {"cost_volume": 16, "cost_volume_bwd": 8}:
        raise AssertionError(f"remat step launched {launches}, not 16 + 8")
    del runs, base

    stage1 = Config({**scfg, "stage1": {"epoch": 1, "loss": {"w_smooth": 0.0}}})
    t = switch_trainer(stage1, get_model(scfg.model, device=dev, seed=SEED),
                       batches[:1], epoch_num=3)
    seen = []
    for _ in range(3):
        t._run_one_epoch()
        seen.append(t.loss_func.cfg.w_smooth)
        t.loss_func.cfg.w_smooth = 4.0
    emit({"phase": "stage1", "w_smooth_after_epochs_0_1_2": seen,
          "fired": t._stage1_fired, "card": smi})
    if seen != [4.0, 0.0, 4.0]:
        raise AssertionError(f"stage1: w_smooth after each epoch {seen}")
    return launches


# ---------------------------------------------------------------------------
# The PWC-Lite family (phases pwclite_kernels, pwclite_inference,
# pwclite_serving; its artifacts run in phase export)

PWCLITE_CHANNELS = (192, 128, 96, 64, 32)  # decode levels 1/64 .. 1/4
PWCLITE_UFLOW_CFG = {"type": "pwclite_uflow", "n_frames": 2,
                     "feature_norm": True}
PWCLITE_SETUPS = (  # (key, model section, cost-volume launches per forward)
    ("pwclite", PWCLITE_CFG, 5),
    ("pwclite_prob", {"type": "pwclite_prob", "n_frames": 2}, 5),
    ("pwclite_uflow", PWCLITE_UFLOW_CFG, 4),
)
PWCLITE_ITERS = 20


def pwclite_level_shapes(b, h, w):
    """The cost volume's (B, C, H, W) at the PWCLite's decode levels."""
    return [(b, c, h >> lv, w >> lv)
            for lv, c in zip((6, 5, 4, 3, 2), PWCLITE_CHANNELS)]


def pwclite_uflow_level_shapes(b, h, w):
    """... and at the PWCLiteUflow's (C = 32, 1/32 .. 1/4)."""
    return [(b, 32, h >> lv, w >> lv) for lv in (5, 4, 3, 2)]


def plain_pwclite_cost_volume():
    """The plain cost volume swapped into the PWC-Lite family's
    correlation (``models/pwclite.py:correlate``)."""
    return mock.patch.object(pwclite_module, "compute_cost_volume",
                             compute_cost_volume_reference)


def phase_pwclite_kernels(dev, smi):
    """The forward kernel against its plain version, then timed, at every
    level shape of the PWCLite at 384x640 b8 (C up to 192, a coarsest map
    of 6x10: W % 4 != 0, less than one tile row) and b1 (the 3-frame
    stream, the 5-frame forward and the streaming artifact) and at
    448x1024 b1 (7x16), and of the PWCLiteUflow at 384x640 b8."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    levels = {"pwclite_b8": pwclite_level_shapes(B, H, W),
              "pwclite_b1": pwclite_level_shapes(1, H, W),
              "pwclite_448x1024_b1": pwclite_level_shapes(1, PH, PW),
              "pwclite_uflow_b8": pwclite_uflow_level_shapes(B, H, W)}
    checks = [(shape, MD, 0) for shapes in levels.values() for shape in shapes]
    return check_forward(checks, gen, dev), time_forward(levels, gen, dev, smi)


def check_vs_plain(name, outs, plain, channels=((0, 2),)):
    """Each channel group of the finest outputs against the plain cost
    volume's within FLOW_RTOL x max (at least 1); the errors."""
    errs = {}
    for lo, hi in channels:
        scale = max(float(plain[0][..., lo:hi].abs().max()), 1.0)
        err = max_abs(outs[0][..., lo:hi], plain[0][..., lo:hi])
        errs[f"{lo}:{hi}"] = {"max_abs_err": err, "atol": FLOW_RTOL * scale}
        if not err <= FLOW_RTOL * scale:
            raise AssertionError(f"{name} channels {lo}:{hi} kernel vs plain: "
                                 f"{err} > {FLOW_RTOL * scale}")
    return errs


def counted_forward(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (outputs, cost-volume launches)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, COST_VOLUME.launches


def pwclite_forward_checks(key, model_cfg, want, b, h, w, gen, dev):
    """One forward of ``model_cfg`` at b x h x w: shapes, finiteness, the
    launches, and the finest outputs against the plain cost volume.
    Returns (model, images, outputs, launches, errors)."""
    model = get_model(Config(model_cfg), device=dev, seed=SEED)
    img1, img2 = shifted_pair(b, h, w, 2, 3, gen, dev)
    with torch.inference_mode():
        res, launches = counted_forward(lambda: model(img1, img2))
        with plain_pwclite_cost_volume():
            plain = model(img1, img2)
        torch.cuda.synchronize()
    outs = res["flows_fw"]
    if COST_VOLUME.launches != launches:
        raise AssertionError(f"{key}: the plain run launched the kernel")
    if launches != want:
        raise AssertionError(f"{key}: {launches} launches, not {want}")
    if not all(bool(torch.isfinite(f).all()) for f in outs):
        raise AssertionError(f"{key}: non-finite output")
    if outs[0].shape[:3] != (b, h, w) or outs[0].dtype != torch.float32:
        raise AssertionError(f"{key}: finest output {tuple(outs[0].shape)} "
                             f"{outs[0].dtype}")
    channels = ((0, 2), (2, 4)) if outs[0].shape[-1] == 4 else ((0, 2),)
    errs = check_vs_plain(key, outs, plain["flows_fw"], channels)
    return model, (img1, img2), outs, launches, errs


def phase_pwclite_inference(dev, smi):
    """The PWC-Lite family's 2-frame inference at 384x640 b8, float32:
    ``pwclite``, ``pwclite_prob`` (flow and log-variance) and
    ``pwclite_uflow`` with ``feature_norm``, each against the same model
    with the plain cost volume, timed (CUDA events over PWCLITE_ITERS
    forwards), profiled and its conv FLOPs counted; the pwclite on a small
    input against the CPU; b1 forwards of pwclite_uflow with
    ``align_corners: false`` and with ``warp_pad: border``; and a bf16
    forward of pwclite against float32. Returns the launches per run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    launches = {}
    for key, model_cfg, want in PWCLITE_SETUPS:
        model, imgs, outs, n, errs = pwclite_forward_checks(
            key, model_cfg, want, B, H, W, gen, dev)
        launches[key] = n

        def forward():
            return model(*imgs)

        with torch.inference_mode():
            ms = cuda_ms(forward, iters=PWCLITE_ITERS)
            prof = profile_window(forward, 3, ms)
        flops = conv_flops(model, *imgs)
        emit({"phase": "pwclite_inference", "key": key, "model": model_cfg,
              "shape": [B, H, W], "dtype": "float32", "launches": n,
              "output_shapes": [list(o.shape) for o in outs],
              "vs_plain": errs, "ms_per_batch": ms,
              "maps_per_s": B / (ms / 1e3), "conv_gflop": flops / 1e9,
              "conv_bound_ms_f32": 1e3 * flops / PEAK_F32_FLOP_PER_S,
              **{k: prof[k] for k in (
                  "device_ms_per_call", "busy_share", "conv_ms_per_call",
                  "cost_volume_fwd_ms_per_call", "cost_volume_fwd_share",
                  "kernel_launches_per_call", "top_kernels")},
              "card": smi})
        if key == "pwclite":
            # A small input against the same weights on the CPU, whose
            # plain path the CPU tests hold to the JAX package.
            a, b = shifted_pair(1, 64, 128, 1, 2, gen, dev)
            cpu = get_model(Config(model_cfg), device="cpu", seed=SEED)
            with torch.inference_mode():
                small = model(a, b, with_bk=True)
                small_cpu = cpu(a.cpu(), b.cpu(), with_bk=True)
            err = max(max_abs(x.cpu(), y) for k in ("flows_fw", "flows_bw")
                      for x, y in zip(small[k], small_cpu[k]))
            scale = max(float(y.abs().max()) for y in small_cpu["flows_fw"])
            tol = FLOW_RTOL * max(scale, 1.0)
            emit({"phase": "pwclite_small_vs_cpu", "shape": [1, 64, 128],
                  "max_abs_err": err, "atol": tol})
            if not err <= tol:
                raise AssertionError(f"pwclite cuda vs cpu: {err} > {tol}")
            m32 = model
        del model
    for opt in ({"align_corners": False}, {"warp_pad": "border"}):
        key = "pwclite_uflow_" + "_".join(f"{k}_{v}" for k, v in opt.items())
        _, _, _, n, errs = pwclite_forward_checks(
            key, dict(PWCLITE_UFLOW_CFG, **opt), 4, 1, H, W, gen, dev)
        launches[key] = n
        emit({"phase": "pwclite_inference", "key": key, "shape": [1, H, W],
              "launches": n, "vs_plain": errs})

    # bf16 from the float32 pwclite's weights
    m16 = get_model(bf16_model_cfg(Config(PWCLITE_CFG)), device=dev)
    m16.load_state_dict(m32.state_dict(), strict=True)
    img1, img2 = shifted_pair(B, H, W, 2, 3, gen, dev)
    with torch.inference_mode():
        out16, n16 = counted_forward(lambda: m16(img1, img2)["flows_fw"])
        out32 = m32(img1, img2)["flows_fw"]
        rel = check_bf16_outputs("pwclite b8", out16, out32)
        ms32, ms16, turns = timed_pair(lambda: m32(img1, img2),
                                       lambda: m16(img1, img2), iters=10)
    launches["pwclite_bf16"] = n16
    emit({"phase": "pwclite_bf16", "shape": [B, H, W], "launches": n16,
          "rel_gap_per_level_vs_f32": rel, "rel_bound": BF16_REL,
          "ms_per_batch_f32": ms32, "ms_per_batch_bf16": ms16,
          "ms_turns_32_16_16_32": turns, "maps_per_s_bf16": B / (ms16 / 1e3),
          "card": smi})
    if n16 != 5:
        raise AssertionError(f"pwclite bf16: {n16} launches, not 5")
    return launches


def phase_pwclite_serving(dev, smi):
    """The 3-frame PWCLite's streaming window at 384x640 b1 over
    STREAM_FRAMES frames, with and without ``with_bw``: each flow and
    backward flow within FLOW_RTOL x max of the monolithic 3-frame forward
    on that window, one pyramid per frame, 10 launches per window; flows/s
    (host clock over 60 pushes); and one 5-frame forward, with ``with_bk``,
    against its chained 3-frame windows. Returns the launches per run."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    m = 4 * STREAM_FRAMES
    tex = texture(1, H + m, W + m, gen, dev)
    seq = [tex[:, :, 2 * t:2 * t + H, 3 * t:3 * t + W].permute(0, 2, 3, 1)
           .contiguous() for t in range(STREAM_FRAMES)]
    model = get_model(Config(PWCLITE3_CFG), device=dev, seed=SEED)
    state = model.state_dict()
    launches = {}
    for with_bw in (False, True):
        engine = StreamingFlowEngine(Config(PWCLITE3_CFG), state,
                                     with_bw=with_bw, device=dev)
        outs, n = counted_forward(lambda: [engine.push(f) for f in seq])
        launches["stream_bw" if with_bw else "stream"] = n
        got = [o for o in outs if o is not None]
        windows = STREAM_FRAMES - 2
        if outs[0] is not None or outs[1] is not None or len(got) != windows:
            raise AssertionError("pwclite 3-frame stream: wrong number of outputs")
        if engine.pyramids_computed != STREAM_FRAMES:
            raise AssertionError(f"{engine.pyramids_computed} pyramids computed")
        if n != 10 * windows:
            raise AssertionError(f"3-frame stream: {n} launches, not {10 * windows}")
        err, scale = 0.0, 1.0
        with torch.inference_mode():
            for t, out in enumerate(got):
                mono = model(*seq[t:t + 3])
                pairs = [(out["flow"], mono["flows_fw"][0])]
                if with_bw:
                    pairs.append((out["flow_bw"], mono["flows_bw"][0]))
                for a, b in pairs:
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError("non-finite 3-frame streaming flow")
                    err = max(err, max_abs(a, b))
                    scale = max(scale, float(b.abs().max()))
        tol = FLOW_RTOL * scale
        emit({"phase": "pwclite_serving", "with_bw": with_bw,
              "frames": STREAM_FRAMES, "flows": len(got),
              "pyramids": engine.pyramids_computed, "launches": n,
              "vs_monolithic_max_abs_err": err, "atol": tol})
        if not err <= tol:
            raise AssertionError(f"3-frame stream vs monolithic: {err} > {tol}")

    engine = StreamingFlowEngine(Config(PWCLITE3_CFG), state, device=dev)
    for f in seq[:3]:  # warm-up
        engine.push(f)
    torch.cuda.synchronize()
    rounds = 5
    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in seq:
            engine.push(f)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = rounds * STREAM_FRAMES
    frames = iter(seq * 2)
    prof = profile_window(lambda: engine.push(next(frames)), STREAM_FRAMES,
                          1e3 * dt / n)
    emit({"phase": "pwclite_serving_time", "shape": [1, H, W], "flows": n,
          "seconds": dt, "flows_per_s": n / dt,
          **{k: prof[k] for k in ("device_ms_per_call", "busy_share",
                                  "kernel_launches_per_call", "top_kernels")},
          "card": smi})

    # the 5-frame network: its windows are the 3-frame network's
    five = get_model(Config(dict(PWCLITE3_CFG, n_frames=5)), device=dev)
    five.load_state_dict(state, strict=True)
    with torch.inference_mode():
        res, n = counted_forward(lambda: five(*seq[:5], with_bk=True))
        win = [model(*seq[s:s + 3]) for s in range(3)]
        want = {"flows_fw": [win[0]["flows_fw"], win[1]["flows_fw"]],
                "flows_bw": [win[1]["flows_bw"], win[2]["flows_bw"]]}
        err = max(max_abs(a[0], b[0]) for k in want
                  for a, b in zip(res[k], want[k]))
        scale = max(float(b[0].abs().max()) for k in want for b in want[k])
    launches["five_frames"] = n
    emit({"phase": "pwclite_5frame", "shape": [1, H, W], "launches": n,
          "vs_windows_max_abs_err": err, "atol": FLOW_RTOL * max(scale, 1.0)})
    if n != 30:
        raise AssertionError(f"5-frame forward: {n} launches, not 30")
    if not err <= FLOW_RTOL * max(scale, 1.0):
        raise AssertionError(f"5-frame vs its windows: {err}")
    return launches


# ---------------------------------------------------------------------------
# The PWC-Lite family's training (phases pwclite_train_kernels,
# pwclite_train, pwclite_cli): the JAX package's own PWC-Lite train step
# (benchmarks/bench_bidir_ab.py, PWCLite 2-frame and the unflow loss at
# 256x448 b8) with the reference's AdamW at ARFlow's settings (lr 2e-4,
# betas 0.9 / 0.999, weight decay 1e-6 on conv weights, none on biases).

PWCLITE_TRAIN_MODEL = {"type": "pwclite", "n_frames": 2, "upsample": True,
                       "reduce_dense": True}
PWCLITE_UNFLOW = {"type": "unflow", "occ_from_back": True, "w_l1": 0.15,
                  "w_ssim": 0.85, "w_ternary": 0.0, "w_smooth": 75.0,
                  "smooth_2nd": True, "alpha": 10,
                  "w_scales": [1.0, 1.0, 1.0, 1.0, 0.0, 0.0],
                  "w_sm_scales": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  "warp_pad": "border", "with_bk": True}
PWCLITE_FULLRES = {"type": "fullres", "w_l1": 0.15, "w_ssim": 0.85,
                   "w_ternary": 0.0, "ternary_distance": 1, "w_smooth": 50.0,
                   "alpha": 10, "occ_type": "wang", "wang_thr": 0.2,
                   "warp_pad": "border", "align_corners": True,
                   "smooth_2nd": False, "with_bk": True}
PWCLITE_ELBO = dict(PWCLITE_UNFLOW, type="elbo", w_entropy=0.01,
                    w_en_scales=[1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
PWCLITE_ADAMW = {"optim": "adamw", "lr": 2e-4, "momentum": 0.9,
                 "beta": 0.999, "weight_decay": 1e-6, "bias_decay": 0.0}
# (key, model section, loss section, cost-volume launches per step, both
# directions); the ELBO setup has a step check and no trainer.
PWCLITE_TRAIN_SETUPS = (
    ("pwclite_unflow", PWCLITE_TRAIN_MODEL, PWCLITE_UNFLOW, 10),
    ("pwclite_uflow_fullres", PWCLITE_UFLOW_CFG, PWCLITE_FULLRES, 8),
    ("pwclite_prob_elbo", {"type": "pwclite_prob", "n_frames": 2},
     PWCLITE_ELBO, 10),
)
PWCLITE_TRAIN_STEPS = 10
PWCLITE_OVERFIT_STEPS = 20


def pwclite_train_config(model, loss, root=None, save_root=None, epochs=1,
                         resume=None):
    """``configs/chairs_uflow.json`` with the PWC-Lite model, loss and AdamW
    (``PWCLITE_ADAMW``) in place of its own; with ``root``, both data roots
    there, the train entry cropped to 256x448 as chairs_uflow_elbo.json's
    is, and ``epochs`` epochs of 3 steps that each validate and save."""
    cfg = load_config(CONFIG)
    cfg.model, cfg.loss = Config(model), Config(loss)
    cfg.train.update(PWCLITE_ADAMW)
    if root is not None:
        for entry in cfg.data:
            entry.root_chairs = root
            if entry.type == "train":
                entry.geometric_aug.update(crop=True, crop_size=[TH, TW])
        cfg.save_root = save_root
        cfg.train.update(epoch_num=epochs, epoch_size=ELBO_CLI_EPOCH_SIZE,
                         valid_freq=1, save_iter=0)
    if resume is not None:
        cfg.train.resume = resume
    return cfg


def pwclite_noise(model, x, gen):
    """One draw of the elbo loss's ``noise``: standard normals at each
    output level's size, both directions, NHWC."""
    with torch.no_grad():
        res = model(x["img1"][:1], x["img2"][:1])
    return {f"eps_{d}_{i}": torch.randn((TB, *f.shape[1:3], 2), generator=gen,
                                        device=f.device)
            for i, f in enumerate(res["flows_fw"]) for d in ("fw", "bw")}


def phase_pwclite_train_kernels(dev, smi):
    """Both kernels against their plain versions, then timed (CUDA graphs
    of 20 launches) at every level shape of the pwclite (C 192 ... 32 on
    4x7 ... 64x112) and pwclite_uflow (C 32 on 8x14 ... 64x112) train steps
    at 256x448 b8; and how many outputs the forward kernel and the plain
    version round apart at each shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    levels = {"pwclite_train_b8": pwclite_level_shapes(TB, TH, TW),
              "pwclite_uflow_train_b8": pwclite_uflow_level_shapes(TB, TH, TW)}
    checks = [(shape, MD, 0) for shapes in levels.values() for shape in shapes]
    fwd_err = check_forward(checks, gen, dev)
    for shape, _, _ in checks:
        f1 = torch.randn(shape, generator=gen, device=dev)
        f2 = torch.randn(shape, generator=gen, device=dev)
        unequal = int((cost_volume_kernel(f1, f2, MD)
                       != compute_cost_volume_reference(f1, f2, MD)).sum())
        emit({"phase": "kernel_unequal", "kernel": "cost_volume",
              "shape": shape, "unequal": unequal})
    fwd_rows = time_forward(levels, gen, dev, smi)
    bwd_err, inputs = check_grad(checks, gen, dev)
    bwd_rows = {key: time_grad(shapes, inputs, smi, key)
                for key, shapes in levels.items()}
    return fwd_err, fwd_rows, bwd_err, bwd_rows


def phase_pwclite_train(dev, smi):
    """Each setup at 256x448 b8: one step with the kernels against the
    plain cost volume and float64 (``step_check`` with deterministic
    algorithms: the occlusion masks threshold a splat); the elbo setup
    under injected noise, and its refusal by the trainer. For pwclite and
    pwclite_uflow: PWCLITE_TRAIN_STEPS steps through
    ``UFlowTrainer.train()`` with AdamW and the launches counted, then
    ``step_time`` (CUDA events, profile, peak memory); for pwclite,
    ``train.remat``'s step against the plain one (gradients, peak memory,
    launches). A failed step check fails the phase once every setup has
    run."""
    log = logging.getLogger("chip_smoke")
    launches, failures = {}, []
    for key, model_cfg, loss_cfg, per_step in PWCLITE_TRAIN_SETUPS:
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        cfg = pwclite_train_config(model_cfg, loss_cfg)
        model = get_model(cfg.model, device=dev, seed=SEED)
        loss = get_loss(cfg.loss)
        batches = []
        for dy, dx in ((1, 2), (2, -3), (-3, 1)):
            a, b = shifted_pair(TB, TH, TW, dy, dx, gen, dev)
            batches.append({"img1": a, "img2": b,
                            "img1_ph": (a * 1.1).clamp(0.0, 1.0),
                            "img2_ph": (b * 1.1).clamp(0.0, 1.0)})
        x = batches[0]
        elbo = loss_cfg["type"] == "elbo"
        noise = pwclite_noise(model, x, gen) if elbo else {}

        def forward_loss(net, inputs, draws, train):
            res = net(inputs["img1"], inputs["img2"], with_bk=True, train=train)
            extra = {"noise": draws} if draws else {}
            return loss(res, inputs["img1"], inputs["img2"], **extra)

        failure = step_check(
            forward_loss, model, x, noise,
            {"phase": "pwclite_train_step_check", "setup": key,
             "model": model_cfg, "loss_type": loss_cfg["type"],
             "shape": [TB, TH, TW]},
            swap=plain_pwclite_cost_volume, launches=per_step,
            deterministic=True)
        if failure:
            failures.append(failure)
        train_cfg = cfg.train.copy()
        train_cfg.update(epoch_num=1, seed=SEED)
        if elbo:
            try:
                UFlowTrainer([], None, model, loss, log, "", train_cfg,
                             model_cfg=cfg.model, full_cfg=cfg)
            except ValueError as e:
                emit({"phase": "pwclite_elbo_refused", "message": str(e)})
            else:
                raise AssertionError("UFlowTrainer took the elbo loss")
            del model
            continue

        trainer = RecordingTrainer(
            [batches[i % len(batches)] for i in range(PWCLITE_TRAIN_STEPS)],
            None, model, loss, log, os.path.join(REPO, "outputs", "chip_smoke"),
            train_cfg, model_cfg=cfg.model, full_cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[key] = {k.name: k.launches for k in KERNELS}
        rows = torch.stack(trainer.rows).cpu()
        emit({"phase": "pwclite_train", "setup": key, "model": model_cfg,
              "loss": loss_cfg, "optim": PWCLITE_ADAMW, "shape": [TB, TH, TW],
              "steps": trainer.i_iter, "seconds_incl_first_steps": seconds,
              "launches": launches[key],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              **{k: rows[:, i].tolist() for i, k in enumerate(
                  ("losses", "l_ph", "l_sm", "flow_mean"))}})
        if trainer.i_iter != PWCLITE_TRAIN_STEPS or len(rows) != PWCLITE_TRAIN_STEPS:
            raise AssertionError(f"({key}) {trainer.i_iter} steps, not "
                                 f"{PWCLITE_TRAIN_STEPS}")
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"({key}) non-finite training metrics")
        want = per_step * PWCLITE_TRAIN_STEPS
        if launches[key] != {"cost_volume": want, "cost_volume_bwd": want}:
            raise AssertionError(f"({key}) {PWCLITE_TRAIN_STEPS} steps launched "
                                 f"{launches[key]}, not {want} + {want}")
        flops = conv_flops(model, x["img1_ph"], x["img2_ph"], with_bk=True)
        step_time("pwclite_train",
                  lambda: trainer.train_step(x["img1"], x["img2"], x["img1_ph"],
                                             x["img2_ph"]),
                  TB, [TB, TH, TW], smi,
                  {"setup": key, "conv_gflop_forward": flops / 1e9,
                   "conv_bound_ms_f32_step": 3e3 * flops / PEAK_F32_FLOP_PER_S},
                  ranges={"loss": (type(loss), "__call__")}, census=None)
        if key == "pwclite_unflow":
            launches["remat"] = pwclite_remat(cfg, model, batches, smi)
        del trainer, model
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def pwclite_remat(cfg, model, batches, smi):
    """One pwclite step with and without ``train.remat`` from the same
    weights (``remat_runs``, deterministic): gradients within
    REMAT_GRAD_RTOL, the peak memory of each, and 10 + 10 forward launches
    (each decode level recomputed) with 10 backward ones. Returns the
    remat step's launches."""
    args = [batches[0][k] for k in ("img1", "img2", "img1_ph", "img2_ph")]
    runs, grad_rel = remat_runs(cfg, model, batches, args, deterministic=True)
    emit({"phase": "pwclite_remat", "shape": [TB, TH, TW],
          "grad_rel_l2_vs_plain": grad_rel, "grad_rtol": REMAT_GRAD_RTOL,
          "peak_memory_gb_plain": runs[False]["peak_gb"],
          "peak_memory_gb_remat": runs[True]["peak_gb"],
          "launches_plain": runs[False]["launches"],
          "launches_remat": runs[True]["launches"], "card": smi})
    if grad_rel is None or not grad_rel <= REMAT_GRAD_RTOL:
        raise AssertionError(f"pwclite remat: gradients {grad_rel}")
    if runs[True]["launches"] != {"cost_volume": 20, "cost_volume_bwd": 10}:
        raise AssertionError(f"pwclite remat step launched "
                             f"{runs[True]['launches']}, not 20 + 10")
    return runs[True]["launches"]


def phase_pwclite_cli(dev, smi):
    """``train_main`` with the PWC-Lite training config on the cli phase's
    FlyingChairs-format directory (written anew, 384x512 pairs cropped to
    256x448, b8): 2 epochs of 3 steps with validation EPE and both
    checkpoints, a resume restoring weights, the AdamW moments and steps,
    the schedule count and the counters bit for bit; then
    PWCLITE_OVERFIT_STEPS steps on one fixed unaugmented batch must lower
    its loss. Under ``PerSampleDraws``, as the cli phase."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pwclite_cli_")
    log = logging.getLogger("chip_smoke")
    try:
        with PerSampleDraws(SEED).active():
            root = os.path.join(tmp, "chairs")
            os.makedirs(root)
            write_chairs_dir(root, dev)

            def make_cfg(save_root, epochs, resume):
                return pwclite_train_config(PWCLITE_TRAIN_MODEL, PWCLITE_UNFLOW,
                                            root, save_root, epochs, resume)

            launches = cli_runs(
                "pwclite", make_cfg, UFlowTrainer, tmp, dev, smi, TB,
                # one forward (5 launches) per validation pair, 2 pairs
                lambda n: {"cost_volume": 10 * n + 10 * CLI_EPOCHS,
                           "cost_volume_bwd": 10 * n},
                # the unflow loss returns no occlusion mask: no mask image
                ("EPE",), {"Valid/gt", "Valid/pred_0"}, 2, shape=(TH, TW))
        img1, img2, _ = stacked_pairs(root, "train", TB, dev)
        cfg = make_cfg(os.path.join(tmp, "overfit"), 1, None)
        model = get_model(cfg.model, device=dev, seed=SEED)
        loss_func = get_loss(cfg.loss)
        before = fixed_batch_loss(model, loss_func, img1, img2)
        cfg.train.update(epoch_num=1, epoch_size=PWCLITE_OVERFIT_STEPS)
        trainer = UFlowTrainer([{"img1": img1, "img2": img2}] * PWCLITE_OVERFIT_STEPS,
                               None, model, loss_func, log, cfg.save_root,
                               cfg.train, model_cfg=cfg.model, full_cfg=cfg)
        trainer.train()
        after = fixed_batch_loss(model, loss_func, img1, img2)
        emit({"phase": "pwclite_cli_overfit", "batch": [TB, CH, CW],
              "steps": trainer.i_iter, "loss_untrained": before,
              "loss_after": after})
        if trainer.i_iter != PWCLITE_OVERFIT_STEPS or not (
                np.isfinite(after) and after < before):
            raise AssertionError(f"{trainer.i_iter} steps on one batch: loss "
                                 f"{before} -> {after}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    cfg = load_config(CONFIG)
    timed("build", phase_build)
    max_err, per_level = timed("kernels", phase_kernels, dev, smi)
    grad_err, grad_rows = timed("grad_kernels", phase_grad_kernels, dev, smi)
    model, launches = timed("inference", phase_inference, cfg, dev, smi)
    serving = timed("serving", phase_serving, cfg, model, dev, smi)
    del model
    prob_err, prob_levels = timed("prob_kernels", phase_prob_kernels, dev, smi)
    prob_launches = {f"inference_{k}": v for k, v in
                     timed("prob_inference", phase_prob_inference, dev, smi).items()}
    prob_launches["inference_b8"] = timed("prob_inference_time",
                                          phase_prob_inference_time, dev, smi)
    prob_serving = timed("prob_serving", phase_prob_serving, dev, smi)
    prob_launches["serving"] = prob_serving[False]
    prob_launches["serving_bw"] = prob_serving[True]
    prob_launches["cli"] = timed("prob_cli", phase_prob_cli, dev, smi)
    train_launches = timed("train", phase_train, cfg, dev, smi)
    cli_launches, cli_inference_launches = timed("cli", phase_cli, dev, smi)
    input_launches = timed("input_path", phase_input_path, dev, smi)
    elbo_err, elbo_rows, elbo_grad_err, elbo_grad_rows = timed(
        "elbo_kernels", phase_elbo_kernels, dev, smi)
    elbo_cli_launches = timed("elbo_cli", phase_elbo_cli, dev, smi)
    elbo_launches = timed("elbo_train", phase_elbo_train, dev, smi)
    elbo_launches["cli"] = elbo_cli_launches
    mse_err, mse_rows, mse_grad_err, mse_grad_rows = timed(
        "mse_kernels", phase_mse_kernels, dev, smi)
    mixture_launches = {"train": timed("mixture_train", phase_mixture_train, dev, smi),
                        "cli": timed("mixture_cli", phase_mixture_cli, dev, smi)}
    mse_launches = {"train": timed("mse_train", phase_mse_train, dev, smi),
                    "cli": timed("mse_cli", phase_mse_cli, dev, smi)}
    export_launches, stream_cli_launches, tool_seconds = phase_serving_tools(dev, smi)
    seconds.update(tool_seconds)
    bf16_launches = timed("bf16", phase_bf16, cfg, dev, smi)
    remat_launches = timed("train_switches", phase_train_switches, cfg, dev, smi)
    lite_err, lite_levels = timed("pwclite_kernels", phase_pwclite_kernels,
                                  dev, smi)
    lite_launches = {
        "inference": timed("pwclite_inference", phase_pwclite_inference, dev, smi),
        "serving": timed("pwclite_serving", phase_pwclite_serving, dev, smi),
        "export": {k: v for k, v in export_launches.items()
                   if k.startswith("pwclite")}}
    lt_err, lt_rows, lt_grad_err, lt_grad_rows = timed(
        "pwclite_train_kernels", phase_pwclite_train_kernels, dev, smi)
    lite_train = timed("pwclite_train", phase_pwclite_train, dev, smi)
    lite_cli = timed("pwclite_cli", phase_pwclite_cli, dev, smi)
    lite_launches["train"] = {k: v["cost_volume"] for k, v in lite_train.items()}
    lite_launches["cli"] = lite_cli["cost_volume"]
    lite_bwd_launches = {"train": {k: v["cost_volume_bwd"]
                                   for k, v in lite_train.items()},
                         "cli": lite_cli["cost_volume_bwd"]}
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    emit({"kernels": [{
        "name": COST_VOLUME.name,
        "route": "cuda",
        "source": COST_VOLUME.source,
        "replaces": COST_VOLUME.replaces,
        "launches": launches["cost_volume"],
        "max_abs_err": max(max_err, prob_err, elbo_err, mse_err, lite_err,
                           lt_err),
        # One 2-frame forward's worth at b8: the four level shapes summed.
        "ms": sum(r["ms"] for r in per_level["b8"]),
        "plain_ms": sum(r["plain_ms"] for r in per_level["b8"]),
        "bound_ms": sum(r["bound_ms"] for r in per_level["b8"]),
        "bound_by": "+".join(sorted({r["bound_by"] for r in per_level["b8"]})),
        "library_ms": None,
        # One streamed flow's worth at b1.
        "ms_b1": sum(r["ms"] for r in per_level["b1"]),
        "bound_ms_b1": sum(r["bound_ms"] for r in per_level["b1"]),
        # One direction's forward at 256x448 b8 (training).
        "ms_train": sum(r["ms"] for r in per_level["train"]),
        "bound_ms_train": sum(r["bound_ms"] for r in per_level["train"]),
        "launches_streaming": serving[False],
        "launches_streaming_bw": serving[True],
        "launches_train": train_launches["cost_volume"],
        # train_main, 2 epochs of 3 steps with validation, and inference_main
        # on 2 pairs, at 384x512 b8 (phase cli).
        "launches_cli": cli_launches["cost_volume"],
        "launches_cli_inference": cli_inference_launches["cost_volume"],
        # The training input path (phase input_path): one uflow step that
        # augments on the card at 384x512 b8, and bf16 train_main's 18 steps
        # with the host augmentation in numpy, native and on the card.
        "launches_input_path": {k: v["cost_volume"]
                                for k, v in input_launches.items()},
        # The probabilistic path (phases prob_*): one forward of each model
        # setup at 448x1024 b1 and of setup (a) at b8, the 12-frame streams
        # without and with with_bw, and inference_main on 12 Sintel pairs.
        "launches_prob": prob_launches,
        # One probabilistic forward's worth at 448x1024 b1 and b2.
        **{f"{what}_{key}": sum(r[what] for r in prob_levels[key])
           for key in prob_levels for what in ("ms", "plain_ms", "bound_ms")},
        # ELBO training (phases elbo_*): ELBO_STEPS steps of each setup at
        # 256x448 b4 and train_main's 6 steps and 2 validations; one
        # forward's worth at the ELBO levels, batch 8 and 16.
        "launches_elbo": {k: v["cost_volume"] for k, v in elbo_launches.items()},
        **{f"{what}_{key}": sum(r[what] for r in elbo_rows[key])
           for key in elbo_rows for what in ("ms", "plain_ms", "bound_ms")},
        # The mixture weights net's ELBO training (ELBO_STEPS steps and
        # train_main) and MSE training (MSE_STEPS steps at 384x512 b16 and
        # train_main); one MSE step's forward at 384x512 b16.
        "launches_mixture": {k: v["cost_volume"] for k, v in mixture_launches.items()},
        "launches_mse": {k: v["cost_volume"] for k, v in mse_launches.items()},
        **{f"{what}_{key}": sum(r[what] for r in mse_rows[key])
           for key in mse_rows for what in ("ms", "plain_ms", "bound_ms")},
        # torch.export artifacts loaded in a fresh process: one forward of
        # the b8 artifacts, the b1 streaming artifact's flows (phase
        # export); arflow-torch-stream over 24 frames, -c/-m without and
        # with --bw and --artifact (phase stream_cli).
        "launches_export": export_launches,
        "launches_stream_cli": stream_cli_launches,
        # model.dtype bfloat16 (phase bf16), through compute_cost_volume's
        # float32 round trip: one forward at 384x640 b8 and of setup (a) at
        # 448x1024 b8, the 12-frame b1 stream, a b1 artifact's forward, one
        # uflow step at 256x448 b8 and one ELBO (a) step at 256x448 b4.
        "launches_bf16": {k: v if isinstance(v, int) else v["cost_volume"]
                          for k, v in bf16_launches.items()},
        # One uflow step at 256x448 b8 with train.remat: the forward's 8 and
        # the 8 of the recomputed decoder levels (phase train_switches).
        "launches_remat": remat_launches["cost_volume"],
        # The PWC-Lite family (phases pwclite_*, and its artifacts in phase
        # export): one b8 forward of each type (5, 5 and 4), the b1
        # pwclite_uflow variants and the bf16 pwclite; the 3-frame stream
        # over 12 frames (10 per window) and one 5-frame forward with
        # with_bk (30); the b8 artifact (5) and the 3-frame streaming
        # artifact (10 per window); PWCLITE_TRAIN_STEPS steps of pwclite
        # (10 per step) and pwclite_uflow (8), the remat step (20), and
        # train_main's 6 steps and 2 validations (phases pwclite_train,
        # pwclite_cli).
        "launches_pwclite": lite_launches,
        # One forward's worth at each PWC-Lite level set: 384x640 b8 and b1
        # and 448x1024 b1 (5 levels, C 192 .. 32), the PWCLiteUflow's at
        # 384x640 b8 (4 levels, C 32).
        **{f"{what}_{key}": sum(r[what] for r in lite_levels[key])
           for key in lite_levels for what in ("ms", "plain_ms", "bound_ms")},
        # One direction's forward at the pwclite and pwclite_uflow training
        # levels, 256x448 b8.
        **{f"{what}_{key}": sum(r[what] for r in lt_rows[key])
           for key in lt_rows for what in ("ms", "plain_ms", "bound_ms")},
    }, {
        "name": COST_VOLUME_BWD.name,
        "route": "cuda",
        "source": COST_VOLUME_BWD.source,
        "replaces": COST_VOLUME_BWD.replaces,
        # TRAIN_STEPS train steps: 8 per step (4 levels x 2 directions).
        "launches": train_launches["cost_volume_bwd"],
        "max_abs_err": max(grad_err, elbo_grad_err, mse_grad_err, lt_grad_err),
        # One direction's worth at 256x448 b8: the four level shapes summed.
        "ms": sum(r["ms"] for r in grad_rows),
        "plain_ms": sum(r["plain_ms"] for r in grad_rows),
        "bound_ms": sum(r["bound_ms"] for r in grad_rows),
        "bound_by": "+".join(sorted({r["bound_by"] for r in grad_rows})),
        "library_ms": None,
        "launches_cli": cli_launches["cost_volume_bwd"],
        "launches_input_path": {k: v["cost_volume_bwd"]
                                for k, v in input_launches.items()},
        "launches_elbo": {k: v["cost_volume_bwd"] for k, v in elbo_launches.items()},
        **{f"{what}_{key}": sum(r[what] for r in elbo_grad_rows[key])
           for key in elbo_grad_rows for what in ("ms", "plain_ms", "bound_ms")},
        "launches_mixture": {k: v["cost_volume_bwd"]
                             for k, v in mixture_launches.items()},
        "launches_mse": {k: v["cost_volume_bwd"] for k, v in mse_launches.items()},
        **{f"{what}_{key}": sum(r[what] for r in mse_grad_rows[key])
           for key in mse_grad_rows for what in ("ms", "plain_ms", "bound_ms")},
        "launches_bf16": {k: bf16_launches[k]["cost_volume_bwd"]
                          for k in ("train_step", "elbo_step")},
        "launches_remat": remat_launches["cost_volume_bwd"],
        # The PWC-Lite family's training: PWCLITE_TRAIN_STEPS steps of
        # pwclite (10 per step) and pwclite_uflow (8), the remat step (10),
        # train_main's 6 steps; one direction's backward at their training
        # levels, 256x448 b8.
        "launches_pwclite": lite_bwd_launches,
        **{f"{what}_{key}": sum(r[what] for r in lt_grad_rows[key])
           for key in lt_grad_rows for what in ("ms", "plain_ms", "bound_ms")},
    }]})
    # The card's name and power limit as nvidia-smi prints them, on a line
    # of their own before the result line.
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
