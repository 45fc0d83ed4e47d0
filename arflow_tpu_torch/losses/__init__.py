"""Loss factory of the port. Only ``type: "uflow"`` is ported so far; the
other losses raise and name the roadmap item that brings them."""

from arflow_tpu_torch.losses.uflow import UFlowLoss  # noqa: F401

_NOT_PORTED = {
    "uflow_elbo": "the probabilistic UFlow path",
    "unflow": "the PWC-Lite family",
    "elbo": "the PWC-Lite family",
    "fullres": "the PWC-Lite family",
    "mse": "the PWC-Lite family",
}


def get_loss(cfg):
    if cfg.type == "uflow":
        return UFlowLoss(cfg)
    if cfg.type in _NOT_PORTED:
        raise NotImplementedError(
            f"loss type {cfg.type!r} is not ported yet: ROADMAP.md queue 1, "
            f"'{_NOT_PORTED[cfg.type]}'")
    raise NotImplementedError(cfg.type)
