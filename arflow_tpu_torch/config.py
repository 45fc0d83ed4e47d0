"""Attribute-access config system (the port's own copy of
``arflow_tpu/config.py``, so that the port imports nothing of the JAX
package; both read the same ``configs/*.json``).

The reference stack loads JSON configs into ``EasyDict`` and uses attribute
access plus ``hasattr``-style optional keys throughout (reference:
train.py:20-21, trainer/uflow_elbo_trainer.py:137-144). ``Config`` reproduces
those semantics without the easydict dependency: nested dicts/lists are
converted recursively, missing attributes raise ``AttributeError`` (so
``hasattr`` works), and ``.get(key, default)`` is available.
"""

from __future__ import annotations

import json
from typing import Any


class Config(dict):
    """A dict with recursive attribute access (EasyDict-compatible surface)."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def update(self, other=None, **kwargs):  # type: ignore[override]
        other = dict(other or {})
        other.update(kwargs)
        for k, v in other.items():
            self[k] = _wrap(v)

    def copy(self) -> "Config":
        return Config(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def load_config(path: str) -> Config:
    """Load a JSON config file (same schema as the reference ``configs/*.json``)."""
    with open(path) as f:
        return Config(json.load(f))
