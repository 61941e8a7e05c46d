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
    StepTimer,
    grad_norm,
    guard_finite,
    profile_stats,
    trace,
    tree_finite,
)

__all__ = [
    "MetricsWriter",
    "RunningMean",
    "SynthesisMeter",
    "StepTimer",
    "grad_norm",
    "log_spectral_distance",
    "mel_cepstral_distortion",
    "quality_report",
    "guard_finite",
    "profile_stats",
    "trace",
    "tree_finite",
]
