"""Serving: the streaming engine (one feature pyramid per frame)."""

from arflow_tpu_torch.serving.engine import StreamingFlowEngine  # noqa: F401
