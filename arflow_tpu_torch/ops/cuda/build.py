"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``arflow_tpu_torch/csrc/<name>.cu`` exposes a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into ``arflow_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
``nvcc -Xptxas -v`` output (registers, shared memory, spills per kernel) is
kept beside each library as ``<library>.log``.

Nothing here runs at import: this module is imported on hosts without
``nvcc`` or a card, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel of the port and its launch count.

    ``launches`` is raised by one where the wrapper launches the kernel and
    nowhere else, so a run can show that its path went through the kernel.
    """

    name: str
    source: str  # path in the repo
    replaces: str  # the TPU kernel, file:line and function
    launches: int = 0


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from arflow_tpu_torch/csrc at first use"
        )
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already.

    Raises ``RuntimeError`` with the compiler's output if the build fails.
    """
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed: {name}: nvcc exit {proc.returncode}\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
