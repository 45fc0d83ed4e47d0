#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``arflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port from ``arflow_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version, runs UFlow 2-frame inference at the full width of
``configs/chairs_uflow.json`` (random weights from a seed), the 2-frame
streaming engine, and training steps of that model and its ``UFlowLoss``
through ``UFlowTrainer``; checks the outputs, and times the kernels, the
forward, the stream and the train step with CUDA events. Each phase prints
one JSON line; any failure raises and the script exits non-zero. It prints
the card's name and power limit (``nvidia-smi``) and ends with one line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

Imports nothing of JAX or of ``arflow_tpu``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch
import torch.nn.functional as F

from arflow_tpu_torch import load_config
from arflow_tpu_torch.losses import get_loss
from arflow_tpu_torch.losses import uflow as uflow_loss_module
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models import uflow as uflow_module
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
from arflow_tpu_torch.serving import StreamingFlowEngine
from arflow_tpu_torch.training import get_trainer
from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow.json")
SEED = 0
B, H, W = 8, 384, 640  # inference cell: 384x640, batch 8, float32
TB, TH, TW = 8, 256, 448  # train cell: 256x448, batch 8, float32
TRAIN_STEPS = 20
STREAM_FRAMES = 12
MD = 4

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


def phase_kernels(dev, smi):
    """The forward kernel against its plain version, then timed, at the
    shapes the main paths give it: the four UFlow levels at 384x640, batch
    8 (2-frame inference) and batch 1 (one streamed flow), and at 256x448,
    batch 8 (training; W = 112 ... 14, where 14 takes the 4-byte copies);
    and checked at the ragged shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = {"b8": level_shapes(B), "b1": level_shapes(1),
              "train": level_shapes(TB, TH, TW)}
    checks = ([(shape, MD, 0) for shapes in levels.values() for shape in shapes]
              + RAGGED)
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

    per_level = {key: [] for key in levels}
    for key, shapes in levels.items():
        for level, shape in zip((1, 2, 3, 4), shapes):
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
    return max_err, per_level


def phase_grad_kernels(dev, smi):
    """The backward kernel against its plain version at the training level
    shapes of 256x448 b8 (the main path), the b8 levels of 384x640 and the
    ragged shapes, both gradients and each alone; then timed at the
    training levels."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    train_levels = level_shapes(TB, TH, TW)
    checks = ([(shape, MD, 0) for shape in train_levels + level_shapes(B)]
              + RAGGED)
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

    rows = []
    for level, shape in zip((1, 2, 3, 4), train_levels):
        g, f1, f2 = inputs[shape]
        ms = graph_ms(lambda: cost_volume_grad_kernel(g, f1, f2, MD))
        eager_ms = cuda_ms(lambda: cost_volume_grad_kernel(g, f1, f2, MD),
                           iters=100)
        plain_ms = cuda_ms(lambda: cost_volume_grad_reference(g, f1, f2, MD),
                           iters=5)
        bound_ms, bound_by, nbytes = cost_volume_grad_bound_ms(*shape)
        row = {"level": level, "batch": TB, "shape": shape,
               "blocks": cost_volume_grad_blocks(shape, MD), "ms": ms,
               "eager_ms": eager_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "share_of_bound": bound_ms / ms, "library_ms": None}
        rows.append(row)
        emit({"phase": "kernel_time", "kernel": "cost_volume_bwd", **row,
              "card": smi})
    return max_err, rows


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


def census_range(fn):
    """``fn`` inside a profiler range named ``census_loss``."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("census_loss"):
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

    def rel_l2(a, b):
        return float((a.double() - b).norm() / b.norm().clamp_min(1e-300))

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
    with mock.patch.object(uflow_loss_module, "census_loss",
                           census_range(uflow_loss_module.census_loss)):
        profile = profile_window(one_step, 3, ms, groups)
    emit({"phase": "train_profile", "shape": [TB, TH, TW], **profile,
          "card": smi})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device()
    cfg = load_config(CONFIG)
    phase_build()
    max_err, per_level = phase_kernels(dev, smi)
    grad_err, grad_rows = phase_grad_kernels(dev, smi)
    model, launches = phase_inference(cfg, dev, smi)
    serving = phase_serving(cfg, model, dev, smi)
    del model
    train_launches = phase_train(cfg, dev, smi)
    emit({"kernels": [{
        "name": COST_VOLUME.name,
        "route": "cuda",
        "source": COST_VOLUME.source,
        "replaces": COST_VOLUME.replaces,
        "launches": launches["cost_volume"],
        "max_abs_err": max_err,
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
    }, {
        "name": COST_VOLUME_BWD.name,
        "route": "cuda",
        "source": COST_VOLUME_BWD.source,
        "replaces": COST_VOLUME_BWD.replaces,
        # TRAIN_STEPS train steps: 8 per step (4 levels x 2 directions).
        "launches": train_launches["cost_volume_bwd"],
        "max_abs_err": grad_err,
        # One direction's worth at 256x448 b8: the four level shapes summed.
        "ms": sum(r["ms"] for r in grad_rows),
        "plain_ms": sum(r["plain_ms"] for r in grad_rows),
        "bound_ms": sum(r["bound_ms"] for r in grad_rows),
        "bound_by": "+".join(sorted({r["bound_by"] for r in grad_rows})),
        "library_ms": None,
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
