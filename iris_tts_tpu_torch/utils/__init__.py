"""Host-side utilities: metrics, audio-quality measures, profiling,
numerical guards."""

from iris_tts_tpu_torch.utils.metrics import (
    MetricsWriter,
    RunningMean,
    SynthesisMeter,
    log_spectral_distance,
    mel_cepstral_distortion,
    quality_report,
)
from iris_tts_tpu_torch.utils.prof import (
    grad_norm,
    guard_finite,
    trace,
    tree_finite,
)

__all__ = [
    "MetricsWriter",
    "RunningMean",
    "SynthesisMeter",
    "grad_norm",
    "log_spectral_distance",
    "mel_cepstral_distortion",
    "quality_report",
    "guard_finite",
    "trace",
    "tree_finite",
]
