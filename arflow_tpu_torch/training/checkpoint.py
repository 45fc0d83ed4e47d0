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

The JAX package's msgpack and orbax checkpoints stay with it.
"""

from __future__ import annotations

import os
import shutil

import torch


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
    The JAX package's msgpack format raises: reading it is not ported."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: resuming from the JAX package's msgpack checkpoints is "
            "not ported yet: ROADMAP.md queue 1, 'factories and the CLI "
            "surface'")
    return torch.load(path, map_location="cpu", weights_only=True)
