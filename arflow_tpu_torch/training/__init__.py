"""Training of the port: the optimizer and the ``uflow``, ``uflow_elbo``
and ``mse`` (``ChairsMse``) trainers."""

from arflow_tpu_torch.training.optim import create_optimizer  # noqa: F401


def get_trainer(name: str):
    if name == "uflow":
        from arflow_tpu_torch.training.uflow_trainer import UFlowTrainer

        return UFlowTrainer
    if name == "uflow_elbo":
        from arflow_tpu_torch.training.uflow_elbo_trainer import UFlowElboTrainer

        return UFlowElboTrainer
    if name in ("mse", "ChairsMse"):
        from arflow_tpu_torch.training.mse_trainer import MseTrainer

        return MseTrainer
    raise NotImplementedError(name)
