"""Host-side utilities: scalar metrics logging."""

from iris_tts_tpu_torch.utils.metrics import MetricsWriter, RunningMean

__all__ = ["MetricsWriter", "RunningMean"]
