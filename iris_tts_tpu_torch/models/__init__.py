"""Model zoo (inference): encoder, duration head, VAE, PostNet, HiFiGAN."""

from iris_tts_tpu_torch.models.encoder import (
    DurationPredictor,
    PhonemeEncoder,
    TransformerBlock,
)
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE

__all__ = [
    "DurationPredictor",
    "PhonemeEncoder",
    "TransformerBlock",
    "HiFiGANGenerator",
    "ResBlock",
    "PostNet",
    "TextConditionedVAE",
]
