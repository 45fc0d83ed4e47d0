"""Host allocator tuning for the image pipeline (the port's own copy of
``arflow_tpu/utils/hostmem.py``).

The data path allocates multi-megabyte image buffers at a high, steady rate
(decode -> resize -> photometric aug -> collate). glibc's default
M_MMAP_THRESHOLD is 128 KB, so every one of those buffers is served by a
fresh mmap and munmapped on free: each allocation's pages are faulted in
from scratch. That is measurable overhead anywhere, and on hosts with
lazily-backed guest memory (balloon/uffd VMs) it dominates: the JAX
package measured ~70 us per first-touched 4 KB page on such a host, ~350 ms
for one 640x640 RGB float buffer, and a steady-state 5 MB numpy allocation
going from 350 ms to 0.3 ms after raising the thresholds.

``configure_host_allocator()`` raises M_MMAP_THRESHOLD and M_TRIM_THRESHOLD
so large buffers come from the reusable heap free-list instead. The cost is
that the process retains its high-water mark of freed memory, the standard
trade for ML input pipelines. Called from ``arflow_tpu_torch/__init__``
(gate off with ``ARFLOW_HOST_ALLOC=0``); no-op off glibc/Linux.
"""

from __future__ import annotations

import ctypes
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_ARENA_MAX = -8

_configured = False


def lazy_backed_memory() -> bool:
    """Probe whether fresh anonymous pages are expensive to first-touch.

    Touches every page of one fresh 16 MB anonymous mmap. A normally-backed
    host does this in single-digit milliseconds; a lazily-backed guest
    (~70 us/page) takes hundreds. The probe itself costs <0.5 s even
    in the slow case.
    """
    import mmap
    import time

    size = 16 << 20
    try:
        m = mmap.mmap(-1, size)
    except Exception:
        return False
    try:
        t0 = time.perf_counter()
        for off in range(0, size, 4096):
            m[off] = 1
        dt = time.perf_counter() - t0
    finally:
        m.close()
    return dt > 0.05


def configure_host_allocator(threshold: int = 1 << 30) -> bool:
    """Serve allocations below ``threshold`` from the heap; never trim.

    On hosts whose probe shows lazily-backed memory, additionally cap glibc
    at ONE arena: per-thread arenas shrink their top chunk with
    madvise(DONTNEED) regardless of M_TRIM_THRESHOLD, so loader worker
    threads would re-fault their pages every batch. Single-arena malloc
    serializes allocation across threads, which is noise next to the
    page-fault cost it removes (and the decode/resize work holds the GIL's
    attention anyway).

    Returns True if mallopt succeeded (glibc only). Safe to call multiple
    times; only the first call does work.
    """
    global _configured
    if _configured:
        return True
    if os.environ.get("ARFLOW_HOST_ALLOC") == "0":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, threshold)) and ok
        if ok and lazy_backed_memory():
            libc.mallopt(_M_ARENA_MAX, 1)
    except Exception:
        return False
    _configured = ok
    return ok
