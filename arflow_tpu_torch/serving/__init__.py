"""Serving: the streaming engine (one feature pyramid per frame),
``run_stream`` over frame files, and ``torch.export`` artifacts
(``serving/export.py``).

The names are imported at first use, so that a loader of artifacts
(``serving.export``) does not import the models.
"""

_NAMES = {
    "StreamingFlowEngine": "engine", "run_stream": "engine",
    "build_inference_fn": "export", "export_inference": "export",
    "export_streaming": "export", "save_artifact": "export",
    "save_streaming_artifact": "export", "load_artifact": "export",
    "load_streaming_artifact": "export", "ServingArtifact": "export",
    "StreamingArtifact": "export",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
