"""Training of the port: the optimizer and the ``uflow`` and ``uflow_elbo``
trainers. The other trainers raise and name the roadmap item that brings
them."""

from arflow_tpu_torch.training.optim import create_optimizer  # noqa: F401

_NOT_PORTED = {
    "mse": "'the probabilistic UFlow path' (MSE training)",
    "ChairsMse": "'the probabilistic UFlow path' (MSE training)",
}


def get_trainer(name: str):
    if name == "uflow":
        from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer

        return UFlowTrainer
    if name == "uflow_elbo":
        from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer

        return UFlowElboTrainer
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"trainer {name!r} is not ported yet: ROADMAP.md queue 1, "
            f"{_NOT_PORTED[name]}")
    raise NotImplementedError(name)
