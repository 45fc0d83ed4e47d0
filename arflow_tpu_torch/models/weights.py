"""Weights into the port: JAX parameter trees and reference checkpoints.

``uflow_state_dict_from_jax``, ``uflow_prob_state_dict_from_jax``,
``component_state_dict_from_jax``, ``pwclite_state_dict_from_jax`` and
``pwclite_uflow_state_dict_from_jax`` are the port's own copies of
``arflow_tpu/models/torch_export.py:export_uflow``, ``export_uflow_prob``,
``export_component_net``, ``export_pwclite`` and ``export_pwclite_uflow``:
they turn a JAX variable tree (a nested dict of arrays, handed over as
numpy) into this package's ``state_dict``:

- conv kernels HWIO -> OIHW, dense kernels transposed;
- deconv kernels, stored pre-flipped in the JAX package: un-flip, then
  (kh, kw, I, O) -> (I, O, kh, kw);
- a zero ``_context_up_layers.0``, the deconv that the reference builds and
  never applies;
- the ``MixtureWeightsNet`` ResNet's BatchNorm scale and bias as
  ``weight`` / ``bias``, its ``batch_stats`` mean and var as
  ``running_mean`` / ``running_var``, and a zero int64
  ``num_batches_tracked``.

``state_dict_from_jax`` dispatches on the config's model type, as
``arflow_tpu/models/torch_export.py:export_state_dict`` does, and
``save_torch_checkpoint`` writes its reference-format ``.pth.tar``
(``arflow-torch-to-torch``). ``load_pretrained`` reads such a
``.pth(.tar)`` with ``strict=True``, or a JAX msgpack checkpoint through
``training/checkpoint.py:load_jax_checkpoint`` and ``state_dict_from_jax``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from arflow_tpu_torch.device import resolve_device


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def conv_kernel_from_jax(k) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(_np(k), (3, 2, 0, 1)))


def deconv_kernel_from_jax(k) -> np.ndarray:
    """Pre-flipped (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw)."""
    return np.ascontiguousarray(np.transpose(_np(k)[::-1, ::-1], (2, 3, 0, 1)))


def _put(sd, name, entry, kernel_fn):
    sd[f"{name}.weight"] = kernel_fn(entry["kernel"])
    if "bias" in entry:
        sd[f"{name}.bias"] = _np(entry["bias"])


def _indices(params, prefix, suffix=""):
    """Sorted integers n of the keys ``{prefix}{n}{suffix}``."""
    out = []
    for key in params:
        if key.startswith(prefix) and key.endswith(suffix):
            mid = key[len(prefix):len(key) - len(suffix)]
            if mid.isdigit():
                out.append(int(mid))
    return sorted(out)


def _params(variables) -> dict:
    """The parameter tree of bare params, ``{'params'}`` or ``{'params',
    'batch_stats'}``."""
    return variables["params"] if "params" in variables else variables


def _batch_stats(variables) -> dict:
    return variables.get("batch_stats", {}) if "params" in variables else {}


def _pyramid_from_jax(sd, pyr, prefix):
    pairs = sorted(tuple(int(v) for v in k[len("conv_l"):].split("_"))
                   for k in pyr if k.startswith("conv_l"))
    for lvl, i in pairs:
        _put(sd, f"{prefix}._convs.{lvl}.{i}", pyr[f"conv_l{lvl}_{i}"],
             conv_kernel_from_jax)


def _decoder_from_jax(sd, params):
    """Flow decoders, context deconvs and refinement, shared by PWCFlow and
    PWCProbFlow."""
    levels = _indices(params, "flow_l", "_out")
    for level in levels:
        convs = _indices(params, f"flow_l{level}_c")
        for j in convs:
            _put(sd, f"_flow_layers.{level}.{j}.0", params[f"flow_l{level}_c{j}"],
                 conv_kernel_from_jax)
        _put(sd, f"_flow_layers.{level}.{len(convs)}",
             params[f"flow_l{level}_out"], conv_kernel_from_jax)
        _put(sd, f"_context_up_layers.{level}", params[f"context_up_l{level}"],
             deconv_kernel_from_jax)
    if levels and 0 not in levels:
        sd["_context_up_layers.0.weight"] = np.zeros_like(
            sd[f"_context_up_layers.{levels[0]}.weight"])
        if f"_context_up_layers.{levels[0]}.bias" in sd:
            sd["_context_up_layers.0.bias"] = np.zeros_like(
                sd[f"_context_up_layers.{levels[0]}.bias"])
    refine = _indices(params, "refine_")
    for j in refine:
        _put(sd, f"_refine_model.{2 * j}", params[f"refine_{j}"],
             conv_kernel_from_jax)
    _put(sd, f"_refine_model.{2 * len(refine)}", params["refine_out"],
         conv_kernel_from_jax)


def _tensors(sd) -> dict:
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def uflow_state_dict_from_jax(params) -> dict:
    """JAX ``PWCFlow`` params -> this package's ``PWCFlow`` state_dict
    (float32 CPU tensors). Accepts the bare params or ``{'params': ...}``."""
    params = _params(params)
    sd = {}
    _pyramid_from_jax(sd, params["feature_pyramid"], "_feature_pyramid_extractor")
    _decoder_from_jax(sd, params)
    return _tensors(sd)


def _put_bn(sd, name, p, s):
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])
    sd[f"{name}.running_mean"] = _np(s["mean"])
    sd[f"{name}.running_var"] = _np(s["var"])
    sd[f"{name}.num_batches_tracked"] = np.zeros((), dtype=np.int64)


def _resnet_from_jax(sd, params, stats, prefix):
    """``MixtureWeightsNet``'s ResNet: params and ``batch_stats`` of its
    ``resnet`` scope -> ``{prefix}.conv1.{0,1}``,
    ``{prefix}.layer{s}.{b}.conv{1,2}.{0,1}`` / ``.downsample.{0,1}`` and
    ``{prefix}.fc``."""
    sd[f"{prefix}.conv1.0.weight"] = conv_kernel_from_jax(params["conv1"]["kernel"])
    _put_bn(sd, f"{prefix}.conv1.1", params["bn1"], stats["bn1"])
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        stage, blk = name[len("layer"):].split("_block")
        tp, s = f"{prefix}.layer{stage}.{blk}", stats[name]
        for i in (1, 2):
            sd[f"{tp}.conv{i}.0.weight"] = conv_kernel_from_jax(p[f"conv{i}"]["kernel"])
            _put_bn(sd, f"{tp}.conv{i}.1", p[f"bn{i}"], s[f"bn{i}"])
        if "downsample_conv" in p:
            _put(sd, f"{tp}.downsample.0", p["downsample_conv"], conv_kernel_from_jax)
            _put_bn(sd, f"{tp}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    sd[f"{prefix}.fc.weight"] = np.ascontiguousarray(_np(params["fc"]["kernel"]).T)
    sd[f"{prefix}.fc.bias"] = _np(params["fc"]["bias"])


def _mixture_from_jax(sd, params, stats, prefix):
    if "mixture_weights_net" in params:
        _resnet_from_jax(sd, params["mixture_weights_net"]["resnet"],
                         stats["mixture_weights_net"]["resnet"], prefix)


def _prob_state_dict(params) -> dict:
    sd = {}
    k = 0
    while f"feature_pyramid_{k}" in params:
        _pyramid_from_jax(sd, params[f"feature_pyramid_{k}"],
                          f"_feature_pyramid_extractor.{k}")
        k += 1
    _decoder_from_jax(sd, params)
    return sd


def uflow_prob_state_dict_from_jax(variables) -> dict:
    """JAX ``PWCProbFlow`` variables (bare params, ``{'params'}``, or with
    ``'batch_stats'`` for ``mixture_weights``) -> this package's
    ``PWCProbFlow`` state_dict: pyramid k under
    ``_feature_pyramid_extractor.{k}``, the decoder as ``PWCFlow``'s, the
    weights net under ``_mixture_weights_net.resnet.``."""
    params = _params(variables)
    sd = _prob_state_dict(params)
    _mixture_from_jax(sd, params, _batch_stats(variables),
                      "_mixture_weights_net.resnet")
    return _tensors(sd)


def component_state_dict_from_jax(variables) -> dict:
    """JAX ``ComponentNet`` variables -> this package's ``ComponentNet``
    state_dict: each net's keys under ``pwcnet1.`` / ``pwcnet2.``, the
    weights net under ``mixture_weights_net.resnet.``."""
    params = _params(variables)
    sd = {f"{net}.{key}": v for net in ("pwcnet1", "pwcnet2")
          for key, v in _prob_state_dict(params[net]).items()}
    _mixture_from_jax(sd, params, _batch_stats(variables),
                      "mixture_weights_net.resnet")
    return _tensors(sd)


# The PWC-Lite family: the reference's conv() is Sequential(Conv2d,
# LeakyReLU), so its weights sit under '.0'.

def _lite_pyramid_from_jax(sd, pyr):
    pairs = sorted(tuple(int(v) for v in k[len("conv_l"):].split("_"))
                   for k in pyr if k.startswith("conv_l"))
    for lvl, j in pairs:
        _put(sd, f"feature_pyramid_extractor.convs.{lvl}.{j}.0",
             pyr[f"conv_l{lvl}_{j}"], conv_kernel_from_jax)


def _lite_estimator_from_jax(sd, est, prefix):
    for i in range(1, 6):
        _put(sd, f"{prefix}.conv{i}.0", est[f"conv{i}"], conv_kernel_from_jax)
    last = "predict_flow" if "predict_flow" in est else "conv_last"
    _put(sd, f"{prefix}.{last}.0", est[last], conv_kernel_from_jax)


def _lite_context_from_jax(sd, ctx):
    n = len(_indices(ctx, "ctx_"))
    for i in range(n):
        _put(sd, f"context_networks.convs.{i}.0", ctx[f"ctx_{i}"],
             conv_kernel_from_jax)
    _put(sd, f"context_networks.convs.{n}.0", ctx["ctx_out"],
         conv_kernel_from_jax)


def pwclite_state_dict_from_jax(params) -> dict:
    """JAX ``PWCLite`` or ``PWCLiteProb`` params (the same layout) -> this
    package's state_dict: ``feature_pyramid_extractor.convs.{l}.{j}.0``,
    ``flow_estimators.conv{i}.0``, ``context_networks.convs.{i}.0`` and
    ``conv_1x1.{l}.0``."""
    params = _params(params)
    sd = {}
    _lite_pyramid_from_jax(sd, params["feature_pyramid"])
    _lite_estimator_from_jax(sd, params["flow_estimator"], "flow_estimators")
    _lite_context_from_jax(sd, params["context_network"])
    for level in _indices(params, "conv_1x1_"):
        _put(sd, f"conv_1x1.{level}.0", params[f"conv_1x1_{level}"],
             conv_kernel_from_jax)
    return _tensors(sd)


def pwclite_uflow_state_dict_from_jax(params) -> dict:
    """JAX ``PWCLiteUflow`` params -> this package's state_dict: the
    pyramid as ``PWCLite``'s, ``flow_estimators.{l}.conv{i}.0``,
    ``deconv_networks.{l}`` and ``context_networks.convs.{i}.0``."""
    params = _params(params)
    sd = {}
    _lite_pyramid_from_jax(sd, params["feature_pyramid"])
    for level in _indices(params, "flow_estimator_"):
        _lite_estimator_from_jax(sd, params[f"flow_estimator_{level}"],
                                 f"flow_estimators.{level}")
    for level in _indices(params, "deconv_"):
        _put(sd, f"deconv_networks.{level}", params[f"deconv_{level}"],
             deconv_kernel_from_jax)
    _lite_context_from_jax(sd, params["context_network"])
    return _tensors(sd)


_CONVERTERS = {
    "uflow": uflow_state_dict_from_jax,
    "uflow_prob": uflow_prob_state_dict_from_jax,
    "component": component_state_dict_from_jax,
    "pwclite": pwclite_state_dict_from_jax,
    "pwclite_prob": pwclite_state_dict_from_jax,
    "pwclite_uflow": pwclite_uflow_state_dict_from_jax,
}


def state_dict_from_jax(variables, model_cfg) -> dict:
    """JAX variables (bare params, ``{'params'}`` or with ``'batch_stats'``)
    of the model ``model_cfg`` names -> this package's state_dict, by model
    type."""
    if model_cfg.type not in _CONVERTERS:
        raise NotImplementedError(f"model type {model_cfg.type!r}")
    return _CONVERTERS[model_cfg.type](variables)


def jax_layout(variables, model_cfg) -> dict:
    """Where each entry of ``state_dict_from_jax(variables, model_cfg)``
    comes from: ``{key: (leaf path, flat indices into that leaf)}``, the
    path from the top of ``variables``. An entry that the converter makes
    up (a zero deconv, ``num_batches_tracked``) has none.

    The converters are permutations (transposes and flips) of one leaf per
    entry, so converting two trees of exact float32 integers, each leaf's
    number and each element's flat index, reads the layout off; it then
    carries any tree of the parameters' shape (Adam moments, SGD momentum)
    into the port's layout in its own dtype, with ``take_jax``."""
    paths = []

    def number(tree, path, fill):
        if isinstance(tree, dict):
            return {k: number(v, path + (k,), fill) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.size >= 2**24:
            raise ValueError(f"{'/'.join(path)}: too large for exact indices")
        if fill == "leaf":
            paths.append(path)
            return np.full(a.shape, len(paths), np.float32)
        return np.arange(a.size, dtype=np.float32).reshape(a.shape)

    leaf_of = state_dict_from_jax(number(variables, (), "leaf"), model_cfg)
    index_of = state_dict_from_jax(number(variables, (), "index"), model_cfg)
    layout = {}
    for key, leaf in leaf_of.items():
        ids = np.unique(leaf.numpy())
        if not leaf.is_floating_point() or ids.size != 1 or ids[0] == 0:
            continue
        layout[key] = (paths[int(ids[0]) - 1],
                       index_of[key].numpy().astype(np.int64))
    return layout


def take_jax(tree, path, index) -> torch.Tensor:
    """The leaf of ``tree`` at ``path`` in the port's layout (``index``
    from ``jax_layout``), in the leaf's own dtype."""
    for k in path:
        tree = tree[k]
    return torch.from_numpy(np.array(np.asarray(tree).reshape(-1)[index]))


def save_torch_checkpoint(path: str, variables, model_cfg, epoch: int = 0):
    """Write the reference-format ``{'epoch', 'state_dict'}`` ``.pth.tar`` of
    JAX ``variables``, as ``arflow_tpu/models/torch_export.py``'s
    ``save_torch_checkpoint`` does; ``load_pretrained`` reads it."""
    torch.save({"epoch": epoch,
                "state_dict": state_dict_from_jax(variables, model_cfg)}, path)
    return path


def jax_variables(state: dict) -> dict:
    """A JAX checkpoint's tree -> its variables: ``{'params'}``, with
    ``'batch_stats'`` where it has them (the JAX CLIs' reading)."""
    variables = {"params": state.get("params", state)}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    return variables


def load_pretrained(path: str, model_cfg, device="cuda"):
    """Build the model of ``model_cfg`` on ``device`` and load the
    checkpoint at ``path`` into it with ``strict=True``: a reference-format
    ``.pth(.tar)``, or the JAX package's ``.msgpack`` (its weights, through
    ``state_dict_from_jax``)."""
    from arflow_tpu_torch.models import get_model
    from arflow_tpu_torch.training.checkpoint import load_jax_checkpoint

    dev = resolve_device(device)
    model = get_model(model_cfg, device="cpu")
    if path.endswith(".msgpack") or os.path.isdir(path):  # a directory raises
        sd = state_dict_from_jax(jax_variables(load_jax_checkpoint(path)),
                                 model_cfg)
    elif path.endswith((".pth", ".pth.tar", ".tar", ".pt")):
        # {'epoch', 'state_dict'} as the reference saves it, or a bare one
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
        sd = {k: v for k, v in sd.items() if k != "epoch"}
    else:
        raise ValueError(
            f"{path}: not a .pth(.tar) or JAX .msgpack checkpoint")
    model.load_state_dict(sd, strict=True)
    return model.to(dev)
