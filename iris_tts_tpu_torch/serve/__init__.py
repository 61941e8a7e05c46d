"""Serving layer: the dynamic batcher, the HTTP frontend, and the
ahead-of-time artifacts (``serve/export.py``).

``python -m iris_tts_tpu_torch.serve`` runs the server from the command
line (``serve/__main__.py``); ``python -m iris_tts_tpu_torch.serve.export``
writes an artifact directory.
"""

from iris_tts_tpu_torch.serve.batcher import (
    BatchItem,
    DynamicBatcher,
    ServerOverloadedError,
    ServerStoppedError,
)
from iris_tts_tpu_torch.serve.server import TTSServer, serve_forever

_EXPORT_NAMES = ("AotPipeline", "ExportedSynthesizer", "export_pipeline")


def __getattr__(name):
    """The export module loads on first use, so that ``python -m
    iris_tts_tpu_torch.serve.export`` does not find it imported already."""
    if name in _EXPORT_NAMES:
        from iris_tts_tpu_torch.serve import export

        return getattr(export, name)
    raise AttributeError(name)


__all__ = [
    "AotPipeline",
    "BatchItem",
    "DynamicBatcher",
    "ExportedSynthesizer",
    "ServerOverloadedError",
    "ServerStoppedError",
    "TTSServer",
    "export_pipeline",
    "serve_forever",
]
