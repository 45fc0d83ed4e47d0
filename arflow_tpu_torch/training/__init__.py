"""Training of the port: the optimizer and the ``uflow`` trainer. The other
trainers raise and name the roadmap item that brings them."""

from arflow_tpu_torch.training.optim import create_optimizer  # noqa: F401

_NOT_PORTED = {
    "uflow_elbo": "the probabilistic UFlow path",
    "mse": "the PWC-Lite family",
    "ChairsMse": "the PWC-Lite family",
}


def get_trainer(name: str):
    if name == "uflow":
        from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer

        return UFlowTrainer
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"trainer {name!r} is not ported yet: ROADMAP.md queue 1, "
            f"'{_NOT_PORTED[name]}'")
    raise NotImplementedError(name)
