"""Model factory of the port: ``type: "uflow"`` (``PWCFlow``),
``"uflow_prob"`` (``PWCProbFlow``) and ``"component"`` (``ComponentNet``),
either with ``mixture_weights``, in float32. The other families and dtypes
raise and name the roadmap item that brings them."""

from __future__ import annotations

import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.models.layers import init_xavier_uniform
from arflow_tpu_torch.models.uflow import PWCFeaturePyramid, PWCFlow  # noqa: F401
from arflow_tpu_torch.models.uflow_prob import (  # noqa: F401
    ComponentNet,
    MixtureWeightsNet,
    PWCProbFlow,
    ResNet,
)
from arflow_tpu_torch.models.weights import (  # noqa: F401
    component_state_dict_from_jax,
    load_pretrained,
    save_torch_checkpoint,
    state_dict_from_jax,
    uflow_prob_state_dict_from_jax,
    uflow_state_dict_from_jax,
)

_NOT_PORTED = {
    "pwclite": "the PWC-Lite family",
    "pwclite_prob": "the PWC-Lite family",
    "pwclite_uflow": "the PWC-Lite family",
}


def _normalize_out_channels(oc) -> tuple:
    """The [L, M, N] group list, or the older int schema of some configs
    (``"out_channels": 4`` is 2 flow + 2 log-diagonal channels)."""
    if isinstance(oc, int):
        return (2, oc - 2, 0)
    return tuple(oc)


def get_model(cfg, device="cuda", seed: int = 0) -> torch.nn.Module:
    """``cfg`` (the config's ``model`` section) -> the model on ``device``,
    its weights drawn from ``torch.Generator().manual_seed(seed)``
    (xavier-uniform, zero bias; BatchNorm at scale 1, shift 0 and unit
    running statistics), in eval mode. Load trained weights with
    ``load_state_dict`` or ``load_pretrained``."""
    if cfg.type not in ("uflow", "uflow_prob", "component"):
        item = _NOT_PORTED.get(cfg.type, "model families")
        raise NotImplementedError(
            f"model type {cfg.type!r} is not ported yet: ROADMAP.md queue 1, "
            f"'{item}'")
    if cfg.get("dtype") not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"model.dtype {cfg.get('dtype')!r} is not ported yet: ROADMAP.md "
            "queue 1, 'config switches' (model.dtype)")
    dev = resolve_device(device)
    common = dict(feature_norm=cfg.get("feature_norm", True),
                  level_dropout=cfg.get("level_dropout", 0.0))
    if cfg.type == "uflow":
        model = PWCFlow(**common)
    else:
        cls = PWCProbFlow if cfg.type == "uflow_prob" else ComponentNet
        model = cls(out_channels=_normalize_out_channels(cfg.out_channels),
                    inv_cov=cfg.get("inv_cov", False),
                    n_pyramids=cfg.get("n_pyramids", 1),
                    mixture_weights=cfg.get("mixture_weights", False), **common)
    init_xavier_uniform(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
