"""Native (C++) data-path functions, loaded with ``ctypes`` (the port's own
copy of ``arflow_tpu/native``).

``arflow_io.cpp`` is compiled by ``g++`` at first use into
``arflow_tpu_torch/_build/`` (git-ignored) under a name that carries a hash
of the source, the flags and the host CPU's instruction-set flags, so an
edited source is rebuilt and a library built for another CPU is never
loaded. Processes that build at once (test workers, loader processes) take
a file lock, and each build is written to a temporary name and renamed into
place. Where libpng's headers are missing, the library is built without
PNG support (``-DARF_NO_PNG``): ``has_png()`` is False, ``supports`` says
no to ``.png`` and PNG files keep their PIL / cv2 path. Where ``g++`` is
missing, ``available()`` is False and every caller keeps its numpy/PIL
path. ``build_error()`` says why in either case.

Decode, flow IO and resize compute as ``arflow_tpu.native`` does, bit for
bit. ``hue_shift`` computes as the numpy hue of ``data/transforms.py``
does, bit for bit (the JAX package's differs from its numpy path by an ulp
on some pixels).

This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "arflow_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = (
    "-O3", "-march=native", "-shared", "-fPIC",
    # Vectorizes the hue loops (speculated FP division); nothing here relies
    # on errno or FP traps.
    "-fno-trapping-math", "-fno-math-errno",
)
# (extra flags, libraries) of each build, tried in turn: with libpng, then
# without PNG support.
VARIANTS = (((), ("-lpng", "-lz")), (("-DARF_NO_PNG",), ()))

_lock = threading.Lock()
_lib = None
_tried = False
_error = ""


def _cpu_signature() -> bytes:
    """The machine and its CPU's instruction-set flags: ``-march=native``
    code runs only where these match."""
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            sig += next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        pass
    return sig.encode()


def library_path(variant) -> Path:
    flags, libs = variant
    h = hashlib.sha256(" ".join(CXX_FLAGS + flags + libs).encode())
    h.update(_cpu_signature())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libarflow_io-{h.hexdigest()[:16]}.so"


def _build(lib: Path, variant) -> str:
    """Compile the source to ``lib`` unless another process has; returns
    the compiler's error ('' on success)."""
    import fcntl

    flags, libs = variant
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "arflow_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return ""
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", *CXX_FLAGS, *flags, str(_SRC), "-o", str(tmp), *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            return f"{cmd[0]}: {e}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"g++ exit {proc.returncode}: {proc.stderr.strip()}"
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        return ""


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        errors = []
        for variant in VARIANTS:
            lib_path = library_path(variant)
            err = "" if lib_path.exists() else _build(lib_path, variant)
            if not err:
                try:
                    lib = ctypes.CDLL(str(lib_path))
                    break
                except OSError as e:
                    err = str(e)
            errors.append(err)
        else:
            _error = "\n".join(errors)
            return None
        _error = "\n".join(errors)  # why the PNG build failed, if it did

        i32p = ctypes.POINTER(ctypes.c_int)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.arf_png_info.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
        lib.png_decode_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int]
        lib.png_decode_kitti_flow.argtypes = [ctypes.c_char_p, f32p]
        lib.arf_ppm_info.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
        lib.ppm_decode_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int]
        lib.arf_flo_info.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.flo_decode.argtypes = [ctypes.c_char_p, f32p]
        lib.resize_bilinear_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.hue_shift_f32.argtypes = [
            f32p, f32p, ctypes.c_longlong, ctypes.c_float,
        ]
        lib.hue_shift_f32.restype = None
        for fn in ("arf_png_info", "png_decode_f32", "png_decode_kitti_flow",
                   "arf_ppm_info", "ppm_decode_f32", "arf_flo_info", "flo_decode"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.resize_bilinear_f32.restype = None
        lib.arf_has_png.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str:
    """Why the library, or its PNG support, is not available ('' when
    both are)."""
    _load()
    return _error


def has_png() -> bool:
    """Whether the library was built with libpng."""
    lib = _load()
    return lib is not None and bool(lib.arf_has_png())


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library is not available: {_error}")
    return lib


def image_shape(path: str):
    """(H, W, C) of a PNG/PPM/PGM without decoding it."""
    lib = _library()
    path_b = str(path).encode()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    lower = str(path).lower()
    if lower.endswith(".png"):
        info = lib.arf_png_info
    elif lower.endswith((".ppm", ".pgm", ".pnm")):
        info = lib.arf_ppm_info
    else:
        raise ValueError(f"unsupported extension: {path}")
    if info(path_b, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)):
        raise IOError(f"image info failed: {path}")
    return h.value, w.value, c.value


def load_image(path: str, channels: int = 3, out: np.ndarray | None = None
               ) -> np.ndarray:
    """Decode PNG/PPM/PGM to float32 [0,1] (H, W, channels), ``px * (1 /
    255)`` (within an ulp of ``px / 255.0``).

    ``out`` may be a preallocated C-contiguous (H, W, channels) float32
    buffer (e.g. a slice of a stacked frame array) to decode into.
    """
    lib = _library()
    h, w, _ = image_shape(path)
    if out is None:
        out = np.empty((h, w, channels), np.float32)
    elif (out.shape != (h, w, channels) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous float32 {(h, w, channels)}: "
                         f"{out.dtype} {out.shape}")
    path_b = str(path).encode()
    lower = str(path).lower()
    if lower.endswith(".png"):
        if lib.png_decode_f32(path_b, _fp(out), channels):
            raise IOError(f"png_decode failed: {path}")
    else:
        if lib.ppm_decode_f32(path_b, _fp(out), channels):
            raise IOError(f"ppm_decode failed: {path}")
    return out


def supports(path: str) -> bool:
    lower = str(path).lower()
    return lower.endswith((".ppm", ".pgm", ".pnm")) or (
        lower.endswith(".png") and has_png())


def read_flo(path: str) -> np.ndarray:
    lib = _library()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.arf_flo_info(str(path).encode(), ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"flo_info failed: {path}")
    out = np.empty((h.value, w.value, 2), np.float32)
    if lib.flo_decode(str(path).encode(), _fp(out)):
        raise IOError(f"flo_decode failed: {path}")
    return out


def read_kitti_png(path: str) -> np.ndarray:
    lib = _library()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    if lib.arf_png_info(str(path).encode(), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c)):
        raise IOError(f"png_info failed: {path}")
    out = np.empty((h.value, w.value, 3), np.float32)
    if lib.png_decode_kitti_flow(str(path).encode(), _fp(out)):
        raise IOError(f"kitti flow decode failed: {path}")
    return out


def hue_shift(img: np.ndarray, delta: float) -> np.ndarray:
    """HSV hue rotation of an (..., 3) float32 RGB array by ``delta`` turns:
    the numpy hue of ``data/transforms.py`` bit for bit, ``delta`` rounded
    to float32 as numpy rounds a Python float."""
    lib = _library()
    img = np.ascontiguousarray(img, np.float32)
    if img.shape[-1] != 3:
        raise ValueError(f"hue_shift takes (..., 3) RGB, not {img.shape}")
    out = np.empty_like(img)
    lib.hue_shift_f32(
        _fp(img), _fp(out), ctypes.c_longlong(img.size // 3),
        ctypes.c_float(delta),
    )
    return out


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) float32 -> (out_h, out_w, C), torch's bilinear with
    ``align_corners=False``, the weights in float32 (within 5e-5 of the
    float64 resize matrix on [0, 1] images)."""
    lib = _library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, c), np.float32)
    lib.resize_bilinear_f32(_fp(img), h, w, c, _fp(out), oh, ow)
    return out
