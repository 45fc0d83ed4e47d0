"""Checkpoints of the port: ``.pth.tar`` files written with ``torch.save``.

A checkpoint holds ``{"state_dict", "epoch", "i_iter", "best_error",
"optimizer", "opt_count", "generator"}``:

- ``state_dict``: the model's, with the reference's keys, on the CPU, so
  the port's ``load_pretrained``, the JAX package's ``.pth.tar`` importer
  and the reference's ``load_state_dict(strict=True)`` all read it;
- ``optimizer``: the ``torch.optim`` optimizer's ``state_dict()``;
- ``opt_count``: the steps the learning-rate schedule has counted;
- ``generator``: the ``get_state()`` of the trainer's generator, which
  level dropout (and the ELBO loss's Monte-Carlo noise) draw from;
- the counters ``epoch``, ``i_iter`` and ``best_error``, for resume.

``load_jax_checkpoint`` reads the JAX package's msgpack checkpoints (the
flax ``msgpack_serialize`` format) with the ``msgpack`` package alone, for
their weights (``load_pretrained``, ``arflow-torch-to-torch``). Resuming a
run from one, Adam moments included, and its orbax directories are not
ported.
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
    """A checkpoint written by ``save_checkpoint``, its tensors on the CPU.
    A JAX msgpack checkpoint raises: a resume would need its Adam moments
    and schedule count, which are not ported (its weights load with
    ``load_pretrained``)."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: resuming from the JAX package's msgpack checkpoints "
            "(Adam moments, schedule count) is not ported yet: ROADMAP.md "
            "queue 1, 'factories and the CLI surface'; load_pretrained and "
            "arflow-torch-to-torch read their weights")
    return torch.load(path, map_location="cpu", weights_only=True)


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
        raise NotImplementedError(
            f"{path}: the JAX package's orbax checkpoints are not ported yet: "
            "ROADMAP.md queue 1, 'factories and the CLI surface' (item 8)")
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)
