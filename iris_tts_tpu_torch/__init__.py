"""iris_tts_tpu_torch — the PyTorch/CUDA port of the iris TTS framework.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. It imports ``torch`` and nothing of JAX or of
the JAX package; its entry points run on a CUDA device unless the caller
passes ``device="cpu"``. Serving (the dynamic batcher, the HTTP server
and the ahead-of-time artifacts) is in ``iris_tts_tpu_torch.serve``. The
one TPU kernel of the JAX package (the fused log-mel) is a hand-written
CUDA kernel here (``ops/csrc/log_mel.cu``).
"""

from iris_tts_tpu_torch.config import (
    AudioConfig,
    DurationConfig,
    EncoderConfig,
    HiFiGANConfig,
    IrisConfig,
    MeshConfig,
    PostNetConfig,
    TrainConfig,
    VAEConfig,
    load_config,
    save_config,
)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: importing the package does not import torch."""
    if name == "TTSPipeline":
        from iris_tts_tpu_torch.models.pipeline import TTSPipeline

        return TTSPipeline
    if name == "create_text_processor":
        from iris_tts_tpu_torch.text.frontend import create_text_processor

        return create_text_processor
    if name in ("infer_hifigan", "get_pretrained_hifigan"):
        from iris_tts_tpu_torch.convert import hifigan_torch

        return getattr(hifigan_torch, name)
    if name in ("TTSServer", "DynamicBatcher", "serve_forever"):
        from iris_tts_tpu_torch import serve

        return getattr(serve, name)
    if name == "log_mel_spectrogram":
        from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram

        return log_mel_spectrogram
    raise AttributeError(
        f"module 'iris_tts_tpu_torch' has no attribute {name!r}"
    )


__all__ = [
    "__version__",
    "AudioConfig",
    "DurationConfig",
    "EncoderConfig",
    "HiFiGANConfig",
    "IrisConfig",
    "MeshConfig",
    "PostNetConfig",
    "TrainConfig",
    "VAEConfig",
    "load_config",
    "save_config",
]
