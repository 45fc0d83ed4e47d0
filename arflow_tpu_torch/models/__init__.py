"""Model factory of the port. Only ``type: "uflow"`` (``PWCFlow``) in float32
is ported so far; the other families and dtypes raise and name the roadmap
item that brings them."""

from __future__ import annotations

import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.models.layers import init_xavier_uniform
from arflow_tpu_torch.models.uflow import PWCFeaturePyramid, PWCFlow  # noqa: F401
from arflow_tpu_torch.models.weights import (  # noqa: F401
    load_pretrained,
    uflow_state_dict_from_jax,
)

_NOT_PORTED = {
    "uflow_prob": "the probabilistic UFlow path",
    "component": "the probabilistic UFlow path",
    "pwclite": "the PWC-Lite family",
    "pwclite_prob": "the PWC-Lite family",
    "pwclite_uflow": "the PWC-Lite family",
}


def get_model(cfg, device="cuda", seed: int = 0) -> PWCFlow:
    """``cfg`` (the config's ``model`` section) -> the model on ``device``,
    its weights drawn from ``torch.Generator().manual_seed(seed)``
    (xavier-uniform, zero bias). Load trained weights with
    ``load_state_dict`` or ``load_pretrained``."""
    if cfg.type != "uflow":
        item = _NOT_PORTED.get(cfg.type, "model families")
        raise NotImplementedError(
            f"model type {cfg.type!r} is not ported yet: ROADMAP.md queue 1, "
            f"'{item}'")
    if cfg.get("dtype") not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"model.dtype {cfg.get('dtype')!r} is not ported yet: ROADMAP.md "
            "queue 1, 'config switches' (model.dtype)")
    dev = resolve_device(device)
    model = PWCFlow(feature_norm=cfg.get("feature_norm", True),
                    level_dropout=cfg.get("level_dropout", 0.0))
    init_xavier_uniform(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
