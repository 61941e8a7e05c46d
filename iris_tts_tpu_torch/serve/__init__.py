"""Serving layer: the dynamic batcher and the HTTP frontend.

``python -m iris_tts_tpu_torch.serve`` runs the server from the command
line (``serve/__main__.py``).
"""

from iris_tts_tpu_torch.serve.batcher import (
    BatchItem,
    DynamicBatcher,
    ServerOverloadedError,
    ServerStoppedError,
)
from iris_tts_tpu_torch.serve.server import TTSServer, serve_forever

__all__ = [
    "BatchItem",
    "DynamicBatcher",
    "ServerOverloadedError",
    "ServerStoppedError",
    "TTSServer",
    "serve_forever",
]
