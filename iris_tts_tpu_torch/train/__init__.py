"""Training layer: train states, schedules, steps, checkpoints, the loop
and the four stages."""

from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.train.gan import GANState, make_gan_steps
from iris_tts_tpu_torch.train.loop import TrainLoop, resume_if_available
from iris_tts_tpu_torch.train.schedules import (
    kl_weight_schedule,
    warmup_cosine,
    warmup_exponential,
)
from iris_tts_tpu_torch.train.state import TrainState, Tx, adam_clipped
from iris_tts_tpu_torch.train.steps import (
    make_duration_eval_step,
    make_duration_train_step,
    make_postnet_train_step,
    make_vae_eval_step,
    make_vae_recon_step,
    make_vae_train_step,
    split_microbatches,
)

__all__ = [
    "CheckpointManager",
    "GANState",
    "make_gan_steps",
    "TrainLoop",
    "resume_if_available",
    "kl_weight_schedule",
    "warmup_cosine",
    "warmup_exponential",
    "TrainState",
    "Tx",
    "adam_clipped",
    "make_duration_eval_step",
    "make_duration_train_step",
    "make_postnet_train_step",
    "make_vae_eval_step",
    "make_vae_recon_step",
    "make_vae_train_step",
    "split_microbatches",
]
