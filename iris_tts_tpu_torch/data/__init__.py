"""Host-side data pipeline: audio IO, alignments, datasets, batching."""

from iris_tts_tpu_torch.data.audio_io import (
    join_wave_chunks,
    load_audio,
    read_wav,
    resample,
    to_mono,
    wav_bytes,
    write_wav,
)
from iris_tts_tpu_torch.data.batching import prefetch_to_device

__all__ = [
    "join_wave_chunks",
    "load_audio",
    "read_wav",
    "resample",
    "to_mono",
    "wav_bytes",
    "write_wav",
    "prefetch_to_device",
]
