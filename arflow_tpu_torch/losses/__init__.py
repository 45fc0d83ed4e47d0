"""Loss factory of the port: ``type: "uflow"``, ``"uflow_elbo"`` and
``"mse"``. The other losses raise and name the roadmap item that brings
them."""

from arflow_tpu_torch.losses.mse import MseLoss  # noqa: F401
from arflow_tpu_torch.losses.uflow import UFlowLoss  # noqa: F401
from arflow_tpu_torch.losses.uflow_elbo import UFlowElboLoss  # noqa: F401

_NOT_PORTED = {
    "unflow": "'the PWC-Lite family'",
    "elbo": "'the PWC-Lite family'",
    "fullres": "'the PWC-Lite family'",
}


def get_loss(cfg):
    """The loss of ``cfg`` (the config's ``loss`` section). Its kind is
    ``type``, or ``name`` where a config has no ``type``
    (``configs/chairs_uflow_elbo.json``)."""
    kind = cfg.get("type", cfg.get("name"))
    if kind == "uflow":
        return UFlowLoss(cfg)
    if kind == "uflow_elbo":
        return UFlowElboLoss(cfg)
    if kind == "mse":
        return MseLoss(cfg)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"loss type {kind!r} is not ported yet: ROADMAP.md queue 1, "
            f"{_NOT_PORTED[kind]}")
    raise NotImplementedError(kind)
