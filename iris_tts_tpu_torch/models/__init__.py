"""Model zoo: encoder, duration head, VAE, PostNet, HiFiGAN, and the
synthesis pipeline over them."""

from iris_tts_tpu_torch.models.encoder import (
    DurationPredictor,
    PhonemeEncoder,
    TransformerBlock,
)
from iris_tts_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    HiFiGANVocoder,
    ResBlock,
    TorchConv1d,
    TorchConvTranspose1d,
    create_vocoder,
    iter_stream_windows,
    receptive_radius_frames,
)
from iris_tts_tpu_torch.models.pipeline import (
    FRAME_BUCKETS,
    PHONEME_BUCKETS,
    TTSPipeline,
    pick_bucket,
)
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import (
    APCoupling,
    FiLM,
    TemporalDownsample,
    TemporalUpsample,
    TextConditionedVAE,
    VolumePreservingFlow,
    WaveNetResBlock,
)

__all__ = [
    "DurationPredictor",
    "PhonemeEncoder",
    "TransformerBlock",
    "HiFiGANGenerator",
    "HiFiGANVocoder",
    "ResBlock",
    "TorchConv1d",
    "TorchConvTranspose1d",
    "create_vocoder",
    "iter_stream_windows",
    "receptive_radius_frames",
    "FRAME_BUCKETS",
    "PHONEME_BUCKETS",
    "TTSPipeline",
    "pick_bucket",
    "PostNet",
    "APCoupling",
    "FiLM",
    "TemporalDownsample",
    "TemporalUpsample",
    "TextConditionedVAE",
    "VolumePreservingFlow",
    "WaveNetResBlock",
]
