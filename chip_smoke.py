#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``arflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port from ``arflow_tpu_torch/csrc``, holds each
against its plain PyTorch version, runs UFlow 2-frame inference at the full
width of ``configs/chairs_uflow.json`` (random weights from a seed) and the
2-frame streaming engine, checks the outputs, and times the kernels, the
forward and the stream with CUDA events. Each phase prints one JSON line;
any failure raises and the script exits non-zero. It prints the card's name
and power limit (``nvidia-smi``) and ends with one line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

Imports nothing of JAX or of ``arflow_tpu``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

from arflow_tpu_torch import load_config
from arflow_tpu_torch.models import get_model
from arflow_tpu_torch.models import uflow as uflow_module
from arflow_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from arflow_tpu_torch.ops.cuda.build import build, build_log
from arflow_tpu_torch.ops.cuda.cost_volume import (
    COST_VOLUME,
    compute_cost_volume_reference,
    cost_volume_kernel,
)
from arflow_tpu_torch.serving import StreamingFlowEngine

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow.json")
SEED = 0
B, H, W = 8, 384, 640  # inference cell: 384x640, batch 8, float32
STREAM_FRAMES = 12
MD = 4

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): memory
# 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Kernel against plain: float32 sums over C in another order than the plain
# version's mean; a few ulp of the partial sums at C=32.
KERNEL_ATOL = 5e-6
# Flows through 4 decoder levels from cost volumes that differ by the
# above, relative to the largest flow value of the run.
FLOW_RTOL = 1e-4


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


def profile_window(fn, n: int, untraced_ms: float) -> dict:
    """Where the device time of ``n`` calls of ``fn`` goes (torch.profiler):
    kernel time per call, the top kernels by it, and the device's busy
    share against ``untraced_ms``, the call's time without the profiler
    (whose own host overhead inflates the traced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if not dev_ms > 0:
        raise RuntimeError("the profiler recorded no device time")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    cv_ms = sum(e.self_device_time_total for e in kernels
                if "cost_volume" in e.key) / 1e3 / n
    # Device time under the cuDNN (transposed) convolution ops.
    conv_ms = sum(e.device_time_total for e in events
                  if e.key in ("aten::cudnn_convolution",
                               "aten::cudnn_convolution_transpose")) / 1e3 / n
    return {"device_ms_per_call": dev_ms, "untraced_ms_per_call": untraced_ms,
            "busy_share": dev_ms / untraced_ms,
            "cost_volume_ms_per_call": cv_ms,
            "conv_ms_per_call": conv_ms,
            "top_kernels": [[e.key[:96], e.count / n,
                             e.self_device_time_total / 1e3 / n]
                            for e in kernels[:10]]}


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


def phase_build():
    t0 = time.time()
    libs = {k.name: build(k.name) for k in KERNELS}
    regs = {}
    for k in KERNELS:
        regs[k.name] = re.findall(r"Used \d+ registers.*", build_log(k.name))
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": {n: os.path.relpath(p, REPO) for n, p in libs.items()},
          "ptxas": regs})


def phase_kernels(dev, smi):
    """Each kernel against its plain version, then timed, at the shapes the
    main path gives it (the four UFlow levels at 384x640 b8)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = [(B, 32, H // 2 ** (lv + 1), W // 2 ** (lv + 1)) for lv in (1, 2, 3, 4)]
    checks = levels + [(3, 20, 13, 37), (1, 32, 2, 3)]
    max_err = 0.0
    for shape in checks:
        f1 = torch.randn(shape, generator=gen, device=dev)
        f2 = torch.randn(shape, generator=gen, device=dev)
        out = cost_volume_kernel(f1, f2, MD)
        torch.cuda.synchronize()
        err = max_abs(out, compute_cost_volume_reference(f1, f2, MD))
        emit({"phase": "kernel_check", "kernel": "cost_volume", "shape": shape,
              "md": MD, "max_abs_err": err, "atol": KERNEL_ATOL})
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"cost_volume {shape}: err {err} > {KERNEL_ATOL}")
        max_err = max(max_err, err)

    per_level = []
    for level, shape in zip((1, 2, 3, 4), levels):
        f1 = torch.randn(shape, generator=gen, device=dev)
        f2 = torch.randn(shape, generator=gen, device=dev)
        ms = cuda_ms(lambda: cost_volume_kernel(f1, f2, MD), iters=200)
        plain_ms = cuda_ms(lambda: compute_cost_volume_reference(f1, f2, MD),
                           iters=10)
        bound_ms, bound_by, nbytes = cost_volume_bound_ms(*shape)
        row = {"level": level, "shape": shape, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "share_of_bound": bound_ms / ms, "library_ms": None}
        per_level.append(row)
        emit({"phase": "kernel_time", "kernel": "cost_volume", **row,
              "card": smi})
    return max_err, per_level


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
    model, launches = phase_inference(cfg, dev, smi)
    serving = phase_serving(cfg, model, dev, smi)
    emit({"kernels": [{
        "name": COST_VOLUME.name,
        "route": "cuda",
        "source": COST_VOLUME.source,
        "replaces": COST_VOLUME.replaces,
        "launches": launches["cost_volume"],
        "max_abs_err": max_err,
        # One 2-frame forward's worth: the four level shapes summed.
        "ms": sum(r["ms"] for r in per_level),
        "plain_ms": sum(r["plain_ms"] for r in per_level),
        "bound_ms": sum(r["bound_ms"] for r in per_level),
        "bound_by": "+".join(sorted({r["bound_by"] for r in per_level})),
        "library_ms": None,
        "launches_streaming": serving[False],
        "launches_streaming_bw": serving[True],
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
