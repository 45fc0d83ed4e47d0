"""Checkpoints of the port: ``.pth.tar`` files written with ``torch.save``.

A checkpoint holds ``{"state_dict", "epoch", "i_iter", "best_error",
"optimizer", "opt_count", "generator"}``, ``"aug_generator"`` where the
photometric augmentation runs on the card, and ``"nan_skips"`` where
``train.nan_revert`` is on:

- ``state_dict``: the model's, with the reference's keys, on the CPU, so
  the port's ``load_pretrained``, the JAX package's ``.pth.tar`` importer
  and the reference's ``load_state_dict(strict=True)`` all read it;
- ``optimizer``: the ``torch.optim`` optimizer's ``state_dict()``;
- ``opt_count``: the steps the learning-rate schedule has counted;
- ``generator``: the ``get_state()`` of the trainer's generator, which
  level dropout (and the ELBO loss's Monte-Carlo noise) draw from;
- ``aug_generator``: the ``get_state()`` of the generator that
  ``photometric_aug.device``'s parameters draw from;
- the counters ``epoch``, ``i_iter``, ``best_error`` and ``nan_skips``
  (the steps ``nan_revert`` reverted; 0 where absent), for resume.

``load_jax_checkpoint`` reads the JAX package's msgpack checkpoints (the
flax ``msgpack_serialize`` format) with the ``msgpack`` package alone: for
their weights (``load_pretrained``, ``arflow-torch-to-torch``), and to
resume a JAX run (``load_checkpoint`` of a ``.msgpack``, then
``restore_jax_state``): the weights and BatchNorm statistics, every moment
of the optax chain in the optimizer's layout and dtype, the schedule's count
and the counters. The JAX step key (``fold_in(PRNGKey(seed + 7919),
i_iter)``) has no torch counterpart: the resumed run's generators are
seeded as a fresh port run seeds them.

``load_orbax_checkpoint`` reads the directories that the JAX package's
``checkpoint_backend: orbax`` writes (orbax's ``StandardCheckpointer``)
with the ``tensorstore`` package alone, for ``arflow-torch-to-torch``: the
JAX package reads such a directory nowhere else, so ``--resume`` and
``-m`` of a directory raise, as in JAX.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

# flax's msgpack extension codes (flax/serialization.py:_MsgpackExtType):
# arrays and numpy scalars; its complex numbers never occur in a checkpoint.
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

ORBAX_ONLY_IN_TO_TORCH = (
    "{path}: an orbax checkpoint directory. The JAX package reads orbax "
    "directories only in to-torch, and so does the port "
    "(arflow-torch-to-torch -m DIR); --resume and -m take a .msgpack or a "
    ".pth.tar: ROADMAP.md queue 1, 'factories and the CLI surface'")


def save_checkpoint(save_dir, state: dict, prefix: str,
                    is_best: bool = False) -> str:
    """Write ``{prefix}_ckpt.pth.tar`` in ``save_dir``; copy it to
    ``{prefix}_model_best.pth.tar`` when ``is_best``."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{prefix}_ckpt.pth.tar")
    torch.save(state, path)
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir,
                                           f"{prefix}_model_best.pth.tar"))
    return path


def load_checkpoint(path: str) -> dict:
    """A checkpoint written by ``save_checkpoint``, its tensors on the CPU;
    or for the JAX package's ``.msgpack`` its counters ``epoch``,
    ``i_iter`` and ``best_error`` and its whole tree as ``jax_state``
    (which ``restore_jax_state`` applies). An orbax directory raises
    (``load_jax_checkpoint``)."""
    if str(path).endswith(".msgpack") or os.path.isdir(path):
        tree = load_jax_checkpoint(path)
        return {"epoch": int(tree["epoch"]), "i_iter": int(tree["i_iter"]),
                "best_error": float(tree["best_error"]), "jax_state": tree}
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_jax_state(tree: dict, model, model_cfg, optimizer) -> dict:
    """Load a JAX checkpoint's tree (``load_jax_checkpoint``) into
    ``model`` and ``optimizer`` (``training/optim.py:Optimizer``):

    - ``params`` and ``batch_stats`` through the model type's converter
      (``models/weights.py``), each entry in the checkpoint's own dtype;
    - the optax chain ``{"0": ..., "1": ...}`` (``arflow_tpu/training/
      optim.py:create_optimizer``'s order; clipping and decay hold empty
      states): ``scale_by_adam``'s ``(count, mu, nu)`` into
      ``torch.optim.Adam``'s ``step`` / ``exp_avg`` / ``exp_avg_sq``,
      ``scale_by_torch_adamw``'s per-leaf counts and moments into
      ``ReferenceAdamW``'s, ``trace`` into ``SGD``'s ``momentum_buffer``,
      the moments carried by the converter's layout (``jax_layout``);
    - ``scale_by_learning_rate``'s count into ``optimizer.count``.

    A parameter the JAX tree lacks (the zero, never-applied context deconv)
    gets no optimizer state, as a port run never gives it one. Returns
    ``{'step', 'nan_skips'}`` (``nan_skips`` 0 where the tree has none)."""
    from arflow_tpu_torch.models.weights import (
        jax_layout,
        jax_variables,
        state_dict_from_jax,
        take_jax,
    )

    variables = jax_variables(tree)
    layout = jax_layout(variables, model_cfg)
    sd = state_dict_from_jax(variables, model_cfg)
    for key, (path, index) in layout.items():
        sd[key] = take_jax(variables, path, index)
    model.load_state_dict(sd, strict=True)

    chain = tree.get("opt_state") or {}
    entries = [chain[k] for k in sorted(chain, key=int)]
    moments = next((e for e in entries if "mu" in e or "trace" in e), None)
    opt = optimizer.optimizer
    kind = ("sgd" if isinstance(opt, torch.optim.SGD)
            else "adam" if isinstance(opt, torch.optim.Adam) else "adamw")
    found = (None if moments is None else "sgd" if "trace" in moments
             else "adamw" if isinstance(moments["count"], dict) else "adam")
    if found != kind:
        raise ValueError(f"the checkpoint's optimizer state is {found!r}; the "
                         f"config's optimizer is {kind!r}")
    position = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    state = {}
    for name, p in model.named_parameters():
        if name not in layout or layout[name][0][0] != "params":
            continue
        path, index = layout[name][0][1:], layout[name][1]
        if kind == "sgd":
            st = {"momentum_buffer": take_jax(moments["trace"], path, index)}
        else:
            if kind == "adam":
                step = torch.tensor(float(moments["count"]), dtype=torch.float32)
            else:
                step = take_jax(moments["count"], path,
                                np.zeros((), np.int64)).to(torch.int32)
            st = {"step": step, "exp_avg": take_jax(moments["mu"], path, index),
                  "exp_avg_sq": take_jax(moments["nu"], path, index)}
        state[position[id(p)]] = st
    opt_sd = opt.state_dict()
    opt_sd["state"] = state
    opt.load_state_dict(opt_sd)
    schedule = [e for e in entries if set(e) == {"count"}]
    step = int(tree.get("step", 0))
    optimizer.count = int(schedule[-1]["count"]) if schedule else step
    return {"step": step, "nan_skips": int(tree.get("nan_skips", 0))}


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: a msgpack ``(shape, dtype name, C-order
    bytes)`` triple."""
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
        shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    """Arrays that flax split into chunks (above 1 GiB) joined again."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_jax_checkpoint(path: str) -> dict:
    """The tree of a JAX package checkpoint (``{'epoch', 'params',
    'opt_state'?, 'batch_stats'?}``, as ``arflow_tpu/training/checkpoint.py``
    writes it with flax's ``msgpack_serialize``): nested dicts of numpy
    arrays and Python scalars, equal to ``flax.serialization.msgpack_restore``
    of the file, read with the ``msgpack`` package (imported here, so that
    only this reader needs it). An orbax checkpoint directory raises."""
    import msgpack

    if os.path.isdir(path):
        raise NotImplementedError(ORBAX_ONLY_IN_TO_TORCH.format(path=path))
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def load_orbax_checkpoint(path: str) -> dict:
    """The tree of a JAX package orbax checkpoint directory, as
    ``arflow_tpu.training.checkpoint.load_checkpoint_orbax`` restores it:
    nested dicts of numpy arrays (scalars 0-d), an empty dict where orbax
    kept none (optax's empty states). Read with ``tensorstore`` alone
    (imported here): the leaves listed in ``_METADATA``'s
    ``tree_metadata``, each a zarr (v2) array under its keys joined by
    dots, in the directory's OCDBT store; another layout raises."""
    import json

    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{path}: reading an orbax checkpoint directory needs the "
            "tensorstore package, which is not installed") from e

    root = os.path.abspath(path)
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path}: not an OCDBT store of zarr v2 arrays")
    tree = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind != "Dict":
                raise ValueError(f"{path}: an empty {kind} at {keys}")
            leaf = {}
        elif kind == "np.ndarray":
            kvstore = {"driver": "ocdbt", "base": f"file://{root}/",
                       "path": ".".join(keys) + "/"}
            leaf = np.asarray(ts.open({"driver": "zarr", "kvstore": kvstore},
                                      open=True).result().read().result())
        else:
            raise ValueError(f"{path}: value type {kind!r} at {keys}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
