"""Where the CPU test lane's time goes: a pytest plugin and two reports.

The plugin, with ``tests`` on the path (it is loaded in every xdist
worker)::

    PYTHONPATH=tests:$PYTHONPATH LANE_TIMING_OUT=/tmp/run \
        python -m pytest tests/test_torch_ddp_step.py -p torch_lane_timing \
        [-n 6 --dist loadfile]

writes ``<LANE_TIMING_OUT>.<worker>.json``: per test its wall and process
CPU seconds, its children's CPU seconds (processes it has reaped), and
the wall and process CPU seconds spent in JAX's XLA compiles (cache
lookups included) and in its top-level traces, with each compile over
half a second by module name. ``LANE_TIMING_NOCACHE=1`` turns the
persistent compilation cache off, so that a run measures cold compiles
without filling the cache; ``LANE_TIMING_HASH=1`` records every compiled
module over 100 KB by size and hash, so that programs that two tests
compile can be found.

The reports::

    python tests/torch_lane_timing.py junit parent.xml change.xml
    python tests/torch_lane_timing.py programs /tmp/run
    python tests/torch_lane_timing.py startup

``junit``: per file the worker seconds of a ``--junitxml`` file, the port's
files summed (``test_torch_*.py`` but the JAX package's
``test_torch_export.py``), the slowest, and each run's share of the
first's. ``programs``: the plugin's totals and the compiled modules that
more than one file, or one file more than once, compiles. ``startup``: the CPU seconds of one rank
process's start (Python, torch and the port's training imports).
"""

import collections
import functools
import glob
import hashlib
import json
import os
import resource
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

_SUMS = {}
_COMPILES = []
_ROWS = []


def _timed(fn, label, on_done=None):
    depth = [0]

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        depth[0] += 1
        t, c = time.perf_counter(), time.process_time()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                wall = time.perf_counter() - t
                _SUMS[label] = _SUMS.get(label, 0.0) + wall
                _SUMS[label + "_cpu"] = (_SUMS.get(label + "_cpu", 0.0)
                                         + time.process_time() - c)
                if on_done is not None:
                    on_done(args, wall)

    return wrapper


def _record_compile(args, wall):
    computation = args[1]
    try:
        name = str(computation.operation.attributes["sym_name"]).strip('"')
    except (AttributeError, KeyError):
        name = "?"
    if os.environ.get("LANE_TIMING_HASH"):
        asm = computation.operation.get_asm(binary=True,
                                            enable_debug_info=False)
        if len(asm) > 100_000:
            _COMPILES.append([name, round(wall, 2), len(asm),
                              hashlib.sha1(asm).hexdigest()[:12]])
    elif wall > 0.5:
        _COMPILES.append([name, round(wall, 2)])


def pytest_sessionstart(session):
    if not os.environ.get("LANE_TIMING_OUT"):
        return
    import jax
    from jax._src import compiler, pjit

    if os.environ.get("LANE_TIMING_NOCACHE"):
        jax.config.update("jax_enable_compilation_cache", False)
    compiler.compile_or_get_cached = _timed(
        compiler.compile_or_get_cached, "compile", _record_compile)
    pjit._trace_for_jit = _timed(pjit._trace_for_jit, "trace")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _SUMS.clear()
    _COMPILES.clear()
    t, c = time.perf_counter(), time.process_time()
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    yield
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    _ROWS.append({
        "id": item.nodeid, "wall": time.perf_counter() - t,
        "cpu": time.process_time() - c,
        "children": (after.ru_utime + after.ru_stime
                     - before.ru_utime - before.ru_stime),
        **{k: round(v, 2) for k, v in _SUMS.items()},
        "compiles": list(_COMPILES)})


def pytest_sessionfinish(session):
    out = os.environ.get("LANE_TIMING_OUT")
    if out:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(f"{out}.{worker}.json", "w") as f:
            json.dump(_ROWS, f)


def _is_port(name: str) -> bool:
    return name.startswith("test_torch_") and name != "test_torch_export"


def junit(paths) -> None:
    first = None
    for path in paths:
        files = collections.Counter()
        for case in ET.parse(path).iter("testcase"):
            files[(case.get("classname") or "?").split(".")[-1]] += float(
                case.get("time"))
        port = {k: v for k, v in files.items() if _is_port(k)}
        slowest = max(port, key=port.get)
        row = (sum(port.values()), port[slowest])
        first = first or row
        print(f"{path}: all {sum(files.values()):.0f} s, port {row[0]:.0f} s "
              f"({row[0] / first[0]:.1%}), slowest {slowest} {row[1]:.1f} s "
              f"({row[1] / first[1]:.1%})")
        print("  " + ", ".join(f"{k[len('test_torch_'):]} {v:.0f}" for k, v in
                               sorted(port.items(), key=lambda x: -x[1])[:15]))


def programs(prefix) -> None:
    total, files = collections.Counter(), collections.defaultdict(set)
    times = collections.Counter()
    for path in glob.glob(f"{prefix}.*.json"):
        with open(path) as f:
            for row in json.load(f):
                for key in ("wall", "cpu", "children", "compile",
                            "compile_cpu", "trace", "trace_cpu"):
                    total[key] += row.get(key, 0.0)
                for entry in row["compiles"]:
                    if len(entry) == 4:
                        where = row["id"].split("::")[0]
                        files[entry[3]].add(where)
                        times[entry[3], where] += 1
    print({k: round(v) for k, v in total.items()})
    print(f"{len(files)} modules over 100 KB")
    for digest, where in files.items():
        if len(where) > 1:
            print(f"  {digest} in {sorted(where)}")
    for (digest, where), n in times.items():
        if n > 1:
            print(f"  {digest} {n} times in {where}")


def startup() -> None:
    code = ("import torch\n"
            "from arflow_tpu_torch.parallel import initialize_multihost\n"
            "from arflow_tpu_torch.training import get_trainer\n"
            "from arflow_tpu_torch.losses import get_loss\n")
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    use = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"wall {time.perf_counter() - t:.2f} s, "
          f"CPU {use.ru_utime + use.ru_stime:.2f} s")


if __name__ == "__main__":
    {"junit": lambda: junit(sys.argv[2:]),
     "programs": lambda: programs(sys.argv[2]),
     "startup": startup}[sys.argv[1]]()
