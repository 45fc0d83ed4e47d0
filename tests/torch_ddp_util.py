"""Data-parallel runs of the port's trainers for the tests, on the CPU.

``run_ranks(case, dir, world)`` (or ``Ranks``, which returns at once and
waits at ``results()``) hands the case to ``world`` processes of this
file, which joined one gloo group at a free ``localhost`` port
(``parallel.initialize_multihost``) and each run ``train_case`` on its rows
of the same global batches (``parallel.shard_batch``); ``train_case(case)``
without a group is the one-process run on the global batches (in the
test's own process, or in a process of this file: ``one_process_case``).
The processes live as long as the test process (``Pool``): each case
after the first finds torch and the port imported and the group joined. A
case is a dict:

- ``trainer`` (``uflow``, ``uflow_elbo`` or ``mse``), ``model``, ``loss``
  and ``train`` config sections;
- ``state_dict``: a ``.pt`` file of the starting weights (float32, as the
  converters write them); the model trains in float64;
- ``batches``: the global batches, numpy dicts, one epoch of them;
- ``noise``: the loss's injected noise at the global batch's shape, or
  None.

The result of a rank holds the step records (the trainer's metric rows),
the model's state, the optimizer's state by parameter name, its count and
the counters. ``spatial_case`` is a case of another kind: the spatial
forward of a model on the ranks' rows of a pair of images;
``spatial_loss_case`` and ``spatial_train_case`` its loss and its
training objective. Worker processes import no JAX."""

import atexit
import json
import os
import pickle
import selectors
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    env.pop("PYTHONSTARTUP", None)
    env["OMP_NUM_THREADS"] = "1"  # as few_torch_threads (torch_data_util.py)
    return env


class Processes:
    """The commands ``argvs`` started at once in ``cwd``; ``wait()`` waits
    for all of them and raises with a failed one's error output (after
    killing the others); ``kill()`` ends the ones still running."""

    def __init__(self, argvs, cwd, timeout=300.0):
        self.procs, self.logs = [], []
        self.deadline = time.time() + timeout
        self.timeout = timeout
        for i, argv in enumerate(argvs):
            log = open(os.path.join(cwd, f"rank{i}.err"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                argv, cwd=cwd, env=worker_env(), stdout=log,
                stderr=subprocess.STDOUT))

    def kill(self) -> None:
        """End the processes still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> None:
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.time() > self.deadline:
                    raise TimeoutError(
                        f"ranks still running after {self.timeout} s")
                time.sleep(0.05)
        finally:
            self.kill()
        failed = [i for i, p in enumerate(procs) if p.returncode != 0]
        for log in self.logs:
            log.seek(0)
        texts = [log.read() for log in self.logs]
        for log in self.logs:
            log.close()
        if failed:
            raise RuntimeError(f"rank {failed[0]} failed:\n"
                               + texts[failed[0]][-4000:])


class Pool:
    """``world`` long-lived processes of this file (``serve``) that take
    cases one at a time: the ranks of one gloo group where ``grouped``,
    else one process without a group. ``submit`` hands each process the
    case's file, its entry and the caller's environment (the ``ARFLOW_*``
    gates that a test sets); ``wait`` waits for every process's answer,
    and raises with a failed one's traceback after ending the pool."""

    def __init__(self, world: int, grouped: bool):
        self.dir = tempfile.mkdtemp(prefix="ranks-")
        self.busy = False
        port = str(free_port())
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(self.dir, f"rank{r}.err"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "serve", str(r),
                 str(world), port, str(int(grouped))],
                cwd=self.dir, env=worker_env(), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, text=True))

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def submit(self, entry: str, path: str) -> None:
        self.busy = True
        msg = json.dumps({"entry": entry, "path": path, "env": worker_env()})
        for p in self.procs:
            p.stdin.write(msg + "\n")
            p.stdin.flush()

    def wait(self, timeout: float) -> None:
        deadline = time.time() + timeout
        pending = {p.stdout: r for r, p in enumerate(self.procs)}
        errors = {}
        with selectors.DefaultSelector() as sel:
            for f in pending:
                sel.register(f, selectors.EVENT_READ)
            while pending and not errors:
                left = deadline - time.time()
                if left <= 0:
                    self.close()
                    raise TimeoutError(f"ranks still running after {timeout} s")
                for key, _ in sel.select(min(left, 1.0)):
                    line = key.fileobj.readline()
                    rank = pending.pop(key.fileobj)
                    sel.unregister(key.fileobj)
                    reply = json.loads(line) if line else {
                        "error": "exited:\n" + self._log(rank)}
                    if "error" in reply:
                        errors[rank] = reply["error"]
        self.busy = False
        if errors:
            self.close()
            rank = min(errors)
            raise RuntimeError(f"rank {rank} failed:\n" + errors[rank][-4000:])

    def _log(self, rank: int) -> str:
        self.logs[rank].seek(0)
        return self.logs[rank].read()[-4000:]

    def close(self) -> None:
        """End the processes and remove their directory."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                f.close()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        for key, pool in list(_POOLS.items()):
            if pool is self:
                del _POOLS[key]


_POOLS = {}  # (world, grouped) -> this test process's Pool


def pool(world: int, grouped: bool) -> Pool:
    """This process's pool of ``world`` processes (grouped or not), started
    at its first use and again after it has ended. It takes one case at a
    time."""
    key = (world, grouped)
    have = _POOLS.get(key)
    if have is not None:
        assert not have.busy, "a pool takes one case at a time"
        if have.alive():
            return have
        have.close()
    _POOLS[key] = Pool(world, grouped)
    return _POOLS[key]


@atexit.register
def _close_pools() -> None:
    for p in list(_POOLS.values()):
        p.close()


class Ranks:
    """``entry(case, mesh)`` handed to ``world`` ranks over gloo (or, for
    ``one_process_case``, to one process without a group) of this
    process's ``pool``; ``results()`` waits for them and returns each
    rank's result, so that the caller's own runs overlap theirs."""

    def __init__(self, case: dict, out_dir, world: int = 2,
                 timeout: float = 300.0, entry: str = "train_case"):
        out_dir = str(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        self.path, self.world = os.path.join(out_dir, "case.pkl"), world
        self.timeout = timeout
        with open(self.path, "wb") as f:
            pickle.dump(case, f)
        self.pool = pool(world, entry != "one_process_case")
        self.pool.submit(entry, self.path)

    def results(self) -> list:
        self.pool.wait(self.timeout)
        out = []
        for r in range(self.world):  # a full-width model's state: removed when read
            with open(f"{self.path}.{r}", "rb") as f:
                out.append(pickle.load(f))
            os.remove(f"{self.path}.{r}")
        os.remove(self.path)
        return out


def run_ranks(case: dict, out_dir, world: int = 2, timeout: float = 300.0,
              entry: str = "train_case") -> list:
    """``entry(case, mesh)`` on ``world`` ranks over gloo; each rank's
    result."""
    return Ranks(case, out_dir, world, timeout, entry).results()


class FixedNoise:
    """A loss that takes the same injected noise at every call."""

    def __init__(self, loss, noise):
        self.loss, self.noise, self.cfg = loss, noise, loss.cfg

    def __call__(self, *args, generator=None):
        return self.loss(*args, noise=self.noise)


def recording(cls):
    class Recording(cls):
        def _queue_step_metrics(self, metrics, *a, **k):
            self.records = getattr(self, "records", []) + [metrics.tolist()]
            super()._queue_step_metrics(metrics, *a, **k)

    return Recording


def train_case(case: dict, mesh=None) -> dict:
    import logging

    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import get_loss
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.parallel import shard_batch
    from arflow_tpu_torch.training import get_trainer

    torch.set_num_threads(1)
    model = get_model(Config(case["model"]), device="cpu")
    model.load_state_dict(torch.load(case["state_dict"], weights_only=True),
                          strict=True)
    model = model.to(torch.float64)
    loss = get_loss(Config(case["loss"]))
    if case.get("noise") is not None:
        loss = FixedNoise(loss, {k: torch.as_tensor(v)
                                 for k, v in case["noise"].items()})
    batches = case["batches"]
    if mesh is not None:
        batches = [shard_batch(mesh, b) for b in batches]
    save_root = os.path.join(os.path.dirname(case["state_dict"]),
                             "one" if mesh is None else f"rank{mesh.rank}")
    trainer = recording(get_trainer(case["trainer"]))(
        batches, None, model, loss, logging.getLogger("ddp"), save_root,
        Config(case["train"]), model_cfg=Config(case["model"]), mesh=mesh)
    trainer.train()
    return result_of(trainer)


def one_process_case(case: dict, mesh=None) -> dict:
    """``train_case`` without a group, in a pool process of its own
    (``Ranks(case, dir, 1, entry="one_process_case")``), so that it runs
    beside the ranks and the caller's own work."""
    return train_case(case)


def result_of(trainer) -> dict:
    """A trainer's step records, model state, optimizer state by parameter
    name, the optimizer's count and the counters."""
    opt = trainer.optimizer.optimizer
    return {
        "records": getattr(trainer, "records", []),
        "state": {k: v.clone() for k, v in trainer.model.state_dict().items()},
        "opt": {name: {k: v.clone() for k, v in opt.state[p].items()}
                for name, p in trainer.model.named_parameters() if p in opt.state},
        "count": trainer.optimizer.count,
        "i_iter": trainer.i_iter,
        "i_epoch": trainer.i_epoch,
        "nan_skips": trainer.nan_skips,
    }


def loader_case(case: dict, mesh=None) -> dict:
    """The train loader's rows over ``case['epochs']`` epochs, and the
    valid loader's batch ids, for the rank of ``mesh``."""
    from arflow_tpu_torch.data.loader import DataLoader, InMemoryDataset

    n = mesh.size if mesh is not None else 1
    r = mesh.rank if mesh is not None else 0
    data = InMemoryDataset([{"i": np.int64(i)} for i in range(case["n"])])
    train = DataLoader(data, batch_size=case["batch_size"], shuffle=True,
                       drop_last=True, seed=case["seed"], num_workers=2,
                       num_replicas=n, rank=r)
    epochs = []
    for e in range(case["epochs"]):
        train.set_epoch(e)
        epochs.append([b["i"].tolist() for b in train])
    valid = DataLoader(data, batch_size=case["batch_size"], num_replicas=n,
                       rank=r, partition="batches")
    return {"epochs": epochs, "len": len(train),
            "valid": [(i, b["i"].tolist()) for i, b in zip(valid.batch_ids(),
                                                           valid)]}


def mesh_case(case: dict, mesh=None) -> dict:
    """``make_hybrid_mesh``, ``shard_batch``, ``replicate`` and ``all_sum``
    on this rank."""
    from arflow_tpu_torch.parallel import (
        all_sum,
        data_parallel,
        dp_axes,
        gather_rows,
        make_hybrid_mesh,
        replicate,
        shard_batch,
    )

    hybrid = make_hybrid_mesh("cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "shape": hybrid.shape,
           "axes": dp_axes(hybrid),
           "sub": {k: torch.distributed.get_world_size(g)
                   for k, g in hybrid.groups.items()}}
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "s": np.float64(2.0)}
    out["rows"] = shard_batch(mesh, batch)
    lin = torch.nn.Linear(3, 2)
    torch.manual_seed(100 + mesh.rank)  # different weights on every rank
    torch.nn.init.normal_(lin.weight)
    replicate(mesh, lin)
    out["weight"] = lin.weight.detach().clone()
    x = torch.tensor([1.0 + mesh.rank, 2.0], dtype=torch.float64,
                     requires_grad=True)
    y = all_sum(x, mesh.group)
    (y * y).sum().backward()
    out["sum"], out["grad"] = y.detach(), x.grad
    with data_parallel(mesh.group):
        out["gathered"] = gather_rows(torch.full((2, 1), float(mesh.rank)))
    return out


def spatial_case(case: dict, mesh=None) -> dict:
    """``parallel.spatial_forward`` of ``case['model']`` (weights from
    ``case['state_dict']``) on this rank's part of ``case['img1']`` /
    ``case['img2']`` (NHWC float32 arrays) over a spatial mesh of every
    rank with ``case['n_spatial']`` splitting the height, in each dtype of
    ``case['dtypes']`` (``"float64"``, ``"float32"``), with_bk; per dtype
    the shapes of this rank's rows of each flow and the flows gathered
    (numpy). Also the mesh's shape, axes and this rank's coordinates, and
    the error of a mesh whose ranks do not factor."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.parallel import (
        gather_flows,
        make_spatial_mesh,
        shard_images_spatial,
        spatial_forward,
    )
    from arflow_tpu_torch.parallel.spatial import mesh_coords

    torch.set_num_threads(1)
    sp = make_spatial_mesh(case["n_spatial"], device="cpu")
    out = {"shape": sp.shape, "axes": sp.axis_names,
           "coords": mesh_coords(sp)}
    try:
        make_spatial_mesh(3, device="cpu")
    except ValueError as e:
        out["refusal"] = str(e)
    state = torch.load(case["state_dict"], weights_only=True)
    for name in case["dtypes"]:
        model = get_model(Config(case["model"]), device="cpu")
        model.load_state_dict(state, strict=True)
        model = model.to(getattr(torch, name))
        img1, img2 = (np.asarray(case[k], name) for k in ("img1", "img2"))
        res = spatial_forward(model, sp, *shard_images_spatial(sp, img1, img2))
        out[name] = {
            "rows": {k: [tuple(f.shape) for f in v] for k, v in res.items()},
            "flows": {k: [f.numpy() for f in v]
                      for k, v in gather_flows(sp, res).items()}}
    return out


def spatial_loss_case(case: dict, mesh=None) -> dict:
    """``parallel.spatial_uflow_loss`` on this rank's rows of given flows
    and images, float64, over a spatial mesh of every rank with
    ``case['n_spatial']`` splitting the height: for each loss config of
    ``case['losses']``, the loss's values, this rank's rows of ``mask1``
    and the gradient of ``total`` with respect to its rows of each flow
    that the loss reads, divided by the mesh's size (each rank holds that
    many times its share). ``case['flows']``: the global NHWC flows, 6 per
    direction; ``case['img1']`` / ``case['img2']``: the global images."""
    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import UFlowLoss
    from arflow_tpu_torch.parallel import (
        make_spatial_mesh,
        shard_images_spatial,
        spatial_uflow_loss,
    )

    torch.set_num_threads(1)
    sp = make_spatial_mesh(case["n_spatial"], device="cpu")
    img1, img2 = shard_images_spatial(sp, case["img1"], case["img2"])
    out = []
    for cfg in case["losses"]:
        res = {k: [shard_images_spatial(sp, f).requires_grad_() for f in v]
               for k, v in case["flows"].items()}
        got = spatial_uflow_loss(UFlowLoss(Config(cfg)), sp, res, img1, img2)
        got["total"].backward()
        out.append({
            "values": {k: float(got[k]) for k in ("total", "l_ph", "l_sm",
                                                  "flow_mean")},
            "mask1": got["mask1"].numpy(),
            "grads": {k: {i: (f.grad / sp.size).numpy()
                          for i, f in enumerate(v) if f.grad is not None}
                      for k, v in res.items()}})
    return {"size": sp.size, "losses": out}


def spatial_train_case(case: dict, mesh=None) -> dict:
    """``parallel.spatial_value_and_grad`` of ``case['model']`` (weights
    from ``case['state_dict']``, in ``case['dtype']``) and ``UFlowLoss``
    (``case['loss']``) on this rank's part of ``case['img1']`` /
    ``case['img2']`` (NHWC arrays) over a spatial mesh of every rank with
    ``case['n_spatial']`` splitting the height, level dropout drawn from a
    generator seeded with ``case['seed']``: the loss's values, the bytes of
    the averaged gradients (every rank's must be equal) and, on rank 0,
    each parameter's gradient by name (None where it has none)."""
    import hashlib

    from arflow_tpu_torch import Config
    from arflow_tpu_torch.losses import UFlowLoss
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.parallel import (
        make_spatial_mesh,
        shard_images_spatial,
        spatial_value_and_grad,
    )

    torch.set_num_threads(1)
    sp = make_spatial_mesh(case["n_spatial"], device="cpu")
    model = get_model(Config(case["model"]), device="cpu")
    model.load_state_dict(torch.load(case["state_dict"], weights_only=True),
                          strict=True)
    dtype = getattr(torch, case["dtype"])
    model = model.to(dtype)
    img1, img2 = (np.asarray(case[k], case["dtype"]) for k in ("img1", "img2"))
    got = spatial_value_and_grad(
        model, UFlowLoss(Config(case["loss"])), sp,
        *shard_images_spatial(sp, img1, img2),
        generator=torch.Generator().manual_seed(case["seed"]))
    digest = hashlib.sha256()
    for p in model.parameters():
        if p.grad is not None:
            digest.update(p.grad.numpy().tobytes())
    return {"values": {k: float(got[k]) for k in ("total", "l_ph", "l_sm",
                                                  "flow_mean")},
            "digest": digest.hexdigest(),
            "grads": ({n: None if p.grad is None else p.grad.numpy()
                       for n, p in model.named_parameters()}
                      if sp.rank == 0 else None)}


def serve(rank, world, port, grouped):
    """A ``Pool`` process: joins the group where ``grouped``, then for each
    line on stdin (the case's file, its entry, the environment) writes
    ``entry``'s result to ``<file>.<rank>`` and answers on stdout with one
    line, ``{}`` or the error's traceback. What the port prints goes to
    stderr."""
    from arflow_tpu_torch.parallel import initialize_multihost, make_mesh

    answer = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    if grouped:
        assert initialize_multihost(f"localhost:{port}", world, rank,
                                    backend="gloo", device="cpu")
    for line in sys.stdin:
        msg = json.loads(line)
        os.environ.clear()
        os.environ.update(msg["env"])
        try:
            with open(msg["path"], "rb") as f:
                case = pickle.load(f)
            out = globals()[msg["entry"]](case, make_mesh("cpu") if grouped
                                          else None)
            with open(f"{msg['path']}.{rank}", "wb") as f:
                pickle.dump(out, f)
            if grouped:
                torch.distributed.barrier()
            reply = {}
        except BaseException:  # noqa: BLE001  (reported to the test)
            reply = {"error": traceback.format_exc()}
        answer.write(json.dumps(reply) + "\n")
        answer.flush()


if __name__ == "__main__":
    assert sys.argv[1] == "serve"
    serve(*(int(a) for a in sys.argv[2:]))
