"""Loss factory of the port: ``type: "uflow"``, ``"uflow_elbo"``,
``"mse"``, and the PWC-Lite family's ``"unflow"``, ``"elbo"`` and
``"fullres"``."""

from arflow_tpu_torch.losses.elbo import ElboLoss  # noqa: F401
from arflow_tpu_torch.losses.fullres import FullResLoss  # noqa: F401
from arflow_tpu_torch.losses.mse import MseLoss  # noqa: F401
from arflow_tpu_torch.losses.uflow import UFlowLoss  # noqa: F401
from arflow_tpu_torch.losses.uflow_elbo import UFlowElboLoss  # noqa: F401
from arflow_tpu_torch.losses.unflow import UnFlowLoss  # noqa: F401

_LOSSES = {"uflow": UFlowLoss, "uflow_elbo": UFlowElboLoss, "mse": MseLoss,
           "unflow": UnFlowLoss, "elbo": ElboLoss, "fullres": FullResLoss}


def get_loss(cfg):
    """The loss of ``cfg`` (the config's ``loss`` section). Its kind is
    ``type``, or ``name`` where a config has no ``type``
    (``configs/chairs_uflow_elbo.json``)."""
    kind = cfg.get("type", cfg.get("name"))
    if kind not in _LOSSES:
        raise NotImplementedError(kind)
    return _LOSSES[kind](cfg)
