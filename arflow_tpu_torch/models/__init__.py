"""Model factory of the port: ``type: "uflow"`` (``PWCFlow``),
``"uflow_prob"`` (``PWCProbFlow``) and ``"component"`` (``ComponentNet``),
either with ``mixture_weights``; ``"pwclite"`` (``PWCLite``, 2, 3 or 5
frames), ``"pwclite_prob"`` (``PWCLiteProb``) and ``"pwclite_uflow"``
(``PWCLiteUflow``); each with ``dtype`` float32 or bfloat16, and the
three UFlow types with ``"int8"``: bfloat16 with the quantized serving
pyramid."""

from __future__ import annotations

import torch

from arflow_tpu_torch.device import resolve_device
from arflow_tpu_torch.models.layers import init_kaiming_normal, init_xavier_uniform
from arflow_tpu_torch.models.pwclite import PWCLite  # noqa: F401
from arflow_tpu_torch.models.pwclite_prob import PWCLiteProb  # noqa: F401
from arflow_tpu_torch.models.pwclite_uflow import PWCLiteUflow  # noqa: F401
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
    pwclite_state_dict_from_jax,
    pwclite_uflow_state_dict_from_jax,
    save_torch_checkpoint,
    state_dict_from_jax,
    uflow_prob_state_dict_from_jax,
    uflow_state_dict_from_jax,
)

PWCLITE_TYPES = ("pwclite", "pwclite_prob", "pwclite_uflow")


def parse_dtype(name):
    """``model.dtype`` -> the compute dtype: None for float32 math
    (``None``, ``"float32"``, ``"f32"``), ``torch.bfloat16`` for
    ``"bfloat16"`` / ``"bf16"`` and ``"int8"`` (float32 parameters and
    outputs; ``"int8"`` also quantizes the feature pyramid,
    ``_int8_pyramid``)."""
    if name in (None, "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16", "int8"):
        return torch.bfloat16
    raise NotImplementedError(f"model dtype {name!r}")


def _int8_pyramid(cfg) -> bool:
    """Whether ``cfg`` (a ``model`` section) asks for the int8 pyramid
    (``model.dtype: "int8"``, serving only): the UFlow types quantize their
    feature pyramids' convs (``models/layers.py:quantized_conv2d``); the
    PWC-Lite types have no int8 path, in the JAX package either, and
    raise."""
    if cfg.get("dtype") != "int8":
        return False
    if cfg.type in PWCLITE_TYPES:
        raise NotImplementedError(
            "model.dtype 'int8' quantizes the uflow-family feature pyramid; "
            f"the '{cfg.type}' family has no int8 path, in the JAX package "
            "as here (ARFLOW_INT8_PYRAMID=1 quantizes its pyramid's convs "
            "all the same)")
    return True


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
    running statistics; the PWC-Lite family's convs kaiming-normal, as the
    JAX layers draw them), in eval mode, its parameters float32 whatever
    ``cfg.dtype`` computes in. Load trained weights with ``load_state_dict``
    or ``load_pretrained``."""
    if cfg.type not in ("uflow", "uflow_prob", "component") + PWCLITE_TYPES:
        raise NotImplementedError(f"model type {cfg.type!r}")
    int8_pyramid = _int8_pyramid(cfg)
    dtype = parse_dtype(cfg.get("dtype"))
    dev = resolve_device(device)
    if cfg.type in PWCLITE_TYPES:
        if cfg.type == "pwclite_uflow":
            model = PWCLiteUflow(
                n_frames=cfg.n_frames,
                reduce_dense=cfg.get("reduce_dense", True),
                level_dropout=cfg.get("level_dropout", 0.0),
                feature_norm=cfg.get("feature_norm", False),
                align_corners=cfg.get("align_corners", True),
                warp_pad=cfg.get("warp_pad", "zeros"), dtype=dtype)
        else:
            cls = PWCLite if cfg.type == "pwclite" else PWCLiteProb
            model = cls(n_frames=cfg.n_frames,
                        upsample=cfg.get("upsample", True),
                        reduce_dense=cfg.get("reduce_dense", True),
                        dtype=dtype)
        init_kaiming_normal(model, torch.Generator().manual_seed(seed))
        return model.to(dev).eval()
    common = dict(feature_norm=cfg.get("feature_norm", True),
                  level_dropout=cfg.get("level_dropout", 0.0), dtype=dtype,
                  int8_pyramid=int8_pyramid)
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
