"""The four training stages, wired as the JAX package's stage scripts wire
them (``scripts/train_{encoder,vae,postnet,hifigan}.py``).

Each function builds the stage's datasets, modules (seeded flax-matching
init), optimizer, train state, checkpoint manager and :class:`TrainLoop`,
resumes from the stage's latest checkpoint if there is one, and returns the
loop; ``loop.run()`` trains. The stages read each other's checkpoints under
one output directory::

    out_dir/encoder/checkpoints   duration stage (encoder + duration head)
    out_dir/vae/checkpoints       VAE, frozen encoder, annealed KL weight
    out_dir/postnet/checkpoints   PostNet, frozen encoder and VAE
    out_dir/hifigan_gan/checkpoints  HiFiGAN generator + MPD/MSD

and :meth:`TTSPipeline.from_checkpoints` assembles a servable pipeline
from them. ``compute_dtype=torch.bfloat16`` trains a stage in mixed
precision and ``remat=True`` (VAE, GAN) recomputes block activations in
the backward pass (``train/steps.py``, ``train/gan.py``); the checkpoints
hold f32 params either way.

``mesh`` (``parallel.build_mesh`` of the running processes) trains a stage
over it: the state is replicated from world rank 0 and, on a model axis,
sharded (``TrainState.place_on``), each rank keeps its data coordinate's
rows of every batch (the batch must divide over the data axis), rank 0
alone builds the mel cache and writes the checkpoints (whole tensors) and
metrics, and the other ranks wait for it where they read its files.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import Sequence

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.data.batching import (
    AudioSegmentBatcher,
    BucketedBatcher,
    to_device,
)
from iris_tts_tpu_torch.data.ljspeech import (
    LJSpeechDurationDataset,
    LJSpeechVAEDataset,
)
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from iris_tts_tpu_torch.parallel.mesh import barrier, is_primary, local_rows
from iris_tts_tpu_torch.runtime import (
    DeviceLike,
    DtypeLike,
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.train.gan import GANState, make_gan_train_step
from iris_tts_tpu_torch.train.loop import TrainLoop, resume_if_available
from iris_tts_tpu_torch.train.schedules import (
    kl_weight_schedule,
    warmup_cosine,
)
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import (
    make_duration_eval_step,
    make_duration_train_step,
    make_postnet_train_step,
    make_vae_eval_step,
    make_vae_train_step,
    split_microbatches,
)
from iris_tts_tpu_torch.utils.metrics import MetricsWriter


def _init(module: nn.Module, seed: int, device: torch.device) -> nn.Module:
    init_params(module, seeded_generator(seed, "cpu"))
    return module.to(device)


def _place_fn(device: torch.device, accum_steps: int, mesh=None):
    """Host batch → device batch: the microbatch split, then this rank's
    rows (axis 1 once split) on a mesh."""
    def place(b):
        if accum_steps > 1:
            b = split_microbatches(b, accum_steps)
        if mesh is not None:
            axis = 1 if accum_steps > 1 else 0
            b = {k: local_rows(v, mesh, axis) for k, v in b.items()}
        return to_device(b, device)

    return place


def _on_mesh(mesh, device, batch_size: int) -> torch.device:
    """The device a stage runs on; on a mesh, the rank's, once the batch
    is known to divide over the data axis."""
    if mesh is None:
        return resolve_device(device)
    if batch_size % mesh.data_size:
        raise ValueError(
            f"batch_size={batch_size} does not divide over the "
            f"{mesh.data_size} ranks of the data axis; training needs "
            "batch % ranks == 0")
    return mesh.device


def _metrics(path: Path, mesh):
    return MetricsWriter(path) if is_primary(mesh) else None


def _precompute_mels(mesh, *datasets) -> None:
    """Fill the datasets' mel caches on rank 0; the others wait for it."""
    if is_primary(mesh):
        for ds in datasets:
            ds.precompute_mels()
    barrier(mesh)


def _rank0_first(mesh, build):
    """``build()`` on rank 0, then on the other ranks: a dataset writes its
    alignment and vocab caches as it is built, and no rank may read one
    while another writes it."""
    if is_primary(mesh):
        out = build()
    barrier(mesh)
    if not is_primary(mesh):
        out = build()
    barrier(mesh)
    return out


def _datasets(cls, data_root, alignment_dir, cache_dir, cfg, mesh=None,
              **kwargs):
    def build():
        train = cls(data_root, alignment_dir, split="train",
                    cache_dir=cache_dir, audio=cfg.audio, **kwargs)
        val = cls(data_root, alignment_dir, split="val", cache_dir=cache_dir,
                  audio=cfg.audio, **kwargs)
        return train, val

    return _rank0_first(mesh, build)


def _with_vocab(cfg: IrisConfig, vocab) -> IrisConfig:
    return replace(cfg, encoder=replace(cfg.encoder,
                                        vocab_size=len(vocab)))


def _warmup_cosine_tx(cfg: IrisConfig, steps_per_epoch: int):
    return adam_clipped(
        warmup_cosine(cfg.train.learning_rate,
                      cfg.train.warmup_epochs * steps_per_epoch,
                      cfg.train.num_epochs * steps_per_epoch),
        clip_norm=cfg.train.clip_norm)


def _val_batcher(val_ds, cfg: IrisConfig, with_mel: bool):
    if not len(val_ds):
        return None
    return BucketedBatcher(val_ds, cfg.train.batch_size, with_mel=with_mel,
                           down_factor=cfg.vae.down_factor, seed=0)


def load_frozen_encoder(cfg: IrisConfig, checkpoint_dir: str | Path,
                        device: torch.device) -> PhonemeEncoder:
    """The trained encoder from a duration-stage checkpoint (best, else
    latest), without its optimizer state."""
    sd = CheckpointManager(checkpoint_dir).restore_best_params()
    encoder = PhonemeEncoder(cfg.encoder)
    encoder.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                             if k.startswith("encoder.")})
    return encoder.to(device)


def load_frozen_vae(cfg: IrisConfig, checkpoint_dir: str | Path,
                    device: torch.device) -> TextConditionedVAE:
    vae = TextConditionedVAE(cfg.vae)
    vae.load_state_dict(CheckpointManager(checkpoint_dir)
                        .restore_best_params())
    return vae.to(device)


def duration_stage(cfg: IrisConfig, data_root, alignment_dir, out_dir,
                   cache_dir=None, device: DeviceLike = None,
                   accum_steps: int = 1,
                   max_phoneme_length: int = 256,
                   compute_dtype: DtypeLike = None, mesh=None) -> TrainLoop:
    """Stage 1: encoder + duration head (``scripts/train_encoder.py``)."""
    device = _on_mesh(mesh, device, cfg.train.batch_size)
    pin_math_precision()
    out = Path(out_dir) / "encoder"
    cache_dir = cache_dir or Path(out_dir) / "cache"
    train_ds, val_ds = _datasets(LJSpeechDurationDataset, data_root,
                                 alignment_dir, cache_dir, cfg, mesh,
                                 max_phoneme_length=max_phoneme_length)
    cfg = _with_vocab(cfg, train_ds.vocab)
    params = _init(nn.ModuleDict({
        "encoder": PhonemeEncoder(cfg.encoder),
        "duration": DurationPredictor(cfg.encoder.embed_dim, cfg.duration),
    }), cfg.train.seed, device)
    batcher = BucketedBatcher(train_ds, cfg.train.batch_size * accum_steps,
                              with_mel=False, seed=cfg.train.seed)
    state = TrainState.create(
        params, _warmup_cosine_tx(cfg, batcher.num_batches()),
        cfg.train.seed)
    ckpt = CheckpointManager(out / "checkpoints", cfg,
                             keep_every_n=cfg.train.checkpoint_every_epochs,
                             mesh=mesh)
    state, start_epoch = resume_if_available(ckpt, state)
    if mesh is not None:
        state.place_on(mesh)
    return TrainLoop(
        state=state,
        train_step=make_duration_train_step(cfg, accum_steps, compute_dtype),
        batcher=batcher,
        num_epochs=cfg.train.num_epochs,
        device=device,
        checkpoints=ckpt,
        metrics=_metrics(out / "metrics.csv", mesh),
        eval_step=make_duration_eval_step(cfg),
        val_batcher=_val_batcher(val_ds, cfg, with_mel=False),
        val_metric_key="duration_loss",
        checkpoint_every=cfg.train.checkpoint_every_epochs,
        start_epoch=start_epoch,
        uses_frozen_in_eval=False,
        place_batch=_place_fn(device, accum_steps, mesh),
    )


def vae_stage(cfg: IrisConfig, data_root, alignment_dir, out_dir,
              cache_dir=None, device: DeviceLike = None,
              accum_steps: int = 1, max_frames: int = 2048,
              encoder_checkpoint=None, compute_dtype: DtypeLike = None,
              remat: bool = False, mesh=None) -> TrainLoop:
    """Stage 2: VAE over the frozen encoder, with the KL weight annealed by
    epoch (``scripts/train_vae.py``). Builds the mel cache first."""
    device = _on_mesh(mesh, device, cfg.train.batch_size)
    pin_math_precision()
    out = Path(out_dir) / "vae"
    cache_dir = cache_dir or Path(out_dir) / "cache"
    train_ds, val_ds = _datasets(LJSpeechVAEDataset, data_root,
                                 alignment_dir, cache_dir, cfg, mesh,
                                 max_frames=max_frames, device=device)
    _precompute_mels(mesh, train_ds, val_ds)
    cfg = _with_vocab(cfg, train_ds.vocab)
    encoder = load_frozen_encoder(
        cfg, encoder_checkpoint or Path(out_dir) / "encoder" / "checkpoints",
        device)
    vae = _init(TextConditionedVAE(cfg.vae), cfg.train.seed, device)
    batcher = BucketedBatcher(train_ds, cfg.train.batch_size * accum_steps,
                              with_mel=True, down_factor=cfg.vae.down_factor,
                              seed=cfg.train.seed)
    state = TrainState.create(
        vae, _warmup_cosine_tx(cfg, batcher.num_batches()), cfg.train.seed,
        frozen={"encoder": encoder})
    ckpt = CheckpointManager(out / "checkpoints", cfg,
                             keep_every_n=cfg.train.checkpoint_every_epochs,
                             mesh=mesh)
    state, start_epoch = resume_if_available(ckpt, state)
    if mesh is not None:
        state.place_on(mesh)

    def kl_extras(epoch: int):
        return (kl_weight_schedule(epoch, cfg.train.kl_weight_start,
                                   cfg.train.kl_weight_end,
                                   cfg.train.kl_anneal_epochs),)

    return TrainLoop(
        state=state,
        train_step=make_vae_train_step(cfg, accum_steps, compute_dtype,
                                       remat),
        batcher=batcher,
        num_epochs=cfg.train.num_epochs,
        device=device,
        checkpoints=ckpt,
        metrics=_metrics(out / "metrics.csv", mesh),
        eval_step=make_vae_eval_step(cfg),
        val_batcher=_val_batcher(val_ds, cfg, with_mel=True),
        epoch_extras=kl_extras,
        val_metric_key="total",
        checkpoint_every=cfg.train.checkpoint_every_epochs,
        start_epoch=start_epoch,
        place_batch=_place_fn(device, accum_steps, mesh),
    )


def postnet_stage(cfg: IrisConfig, data_root, alignment_dir, out_dir,
                  cache_dir=None, device: DeviceLike = None,
                  encoder_checkpoint=None, vae_checkpoint=None,
                  compute_dtype: DtypeLike = None, mesh=None) -> TrainLoop:
    """Stage 3: PostNet over the frozen encoder and VAE
    (``scripts/train_postnet.py``). The architecture comes from the config
    recorded beside the VAE checkpoints when there is one."""
    device = _on_mesh(mesh, device, cfg.train.batch_size)
    pin_math_precision()
    out = Path(out_dir) / "postnet"
    cache_dir = cache_dir or Path(out_dir) / "cache"
    vae_dir = Path(vae_checkpoint or Path(out_dir) / "vae" / "checkpoints")
    if (vae_dir / "config.json").exists():
        cfg = replace(CheckpointManager(vae_dir).load_config(),
                      train=cfg.train)
    train_ds, _ = _datasets(LJSpeechVAEDataset, data_root, alignment_dir,
                            cache_dir, cfg, mesh, device=device)
    _precompute_mels(mesh, train_ds)
    cfg = _with_vocab(cfg, train_ds.vocab)
    frozen = {
        "encoder": load_frozen_encoder(
            cfg, encoder_checkpoint
            or Path(out_dir) / "encoder" / "checkpoints", device),
        "vae": load_frozen_vae(cfg, vae_dir, device),
    }
    postnet = _init(PostNet(cfg.postnet), cfg.train.seed, device)
    batcher = BucketedBatcher(train_ds, cfg.train.batch_size, with_mel=True,
                              down_factor=cfg.vae.down_factor,
                              seed=cfg.train.seed)
    state = TrainState.create(
        postnet, adam_clipped(cfg.train.learning_rate,
                              clip_norm=cfg.train.clip_norm),
        cfg.train.seed, frozen=frozen)
    ckpt = CheckpointManager(out / "checkpoints", cfg,
                             keep_every_n=cfg.train.checkpoint_every_epochs,
                             mesh=mesh)
    state, start_epoch = resume_if_available(ckpt, state)
    if mesh is not None:
        state.place_on(mesh)
    return TrainLoop(
        state=state,
        train_step=make_postnet_train_step(cfg, compute_dtype),
        batcher=batcher,
        num_epochs=cfg.train.num_epochs,
        device=device,
        checkpoints=ckpt,
        metrics=_metrics(out / "metrics.csv", mesh),
        val_metric_key="postnet_l1",
        checkpoint_every=cfg.train.checkpoint_every_epochs,
        start_epoch=start_epoch,
        place_batch=_place_fn(device, 1, mesh),
    )


def gan_stage(cfg: IrisConfig, data_root, alignment_dir, out_dir,
              cache_dir=None, device: DeviceLike = None,
              segment_frames: int = 32, disc_width: float = 1.0,
              periods: Sequence[int] = (2, 3, 5, 7, 11), num_scales: int = 3,
              accum_steps: int = 1, ema_decay: float = 0.0,
              compute_dtype: DtypeLike = None,
              remat: bool = False, mesh=None) -> TrainLoop:
    """Stage 4: HiFiGAN adversarial training with MPD/MSD on random
    ``segment_frames``-frame segments (32 → 8192 samples), AdamW-style
    betas (0.8, 0.99) on both sides (``scripts/train_hifigan.py``).
    ``ema_decay`` (e.g. 0.999) tracks an EMA of the generator, which
    ``from_checkpoints`` then serves."""
    device = resolve_device(device)
    pin_math_precision()
    out = Path(out_dir) / "hifigan_gan"
    cache_dir = cache_dir or Path(out_dir) / "cache"
    ds = _rank0_first(mesh, lambda: LJSpeechVAEDataset(
        data_root, alignment_dir, split="train", cache_dir=cache_dir,
        audio=cfg.audio, device=device))
    if mesh is not None:  # no rank reads a clip's mel while another writes it
        _precompute_mels(mesh, ds)
    batcher = AudioSegmentBatcher(ds, cfg.train.batch_size * accum_steps,
                                  segment_frames, cfg.audio,
                                  seed=cfg.train.seed)
    gen = _init(HiFiGANGenerator(cfg.hifigan), cfg.train.seed, device)
    disc = _init(HiFiGANDiscriminators(tuple(periods), num_scales,
                                       disc_width),
                 cfg.train.seed + 1, device)
    tx = adam_clipped(cfg.train.learning_rate, clip_norm=cfg.train.clip_norm,
                      b1=0.8, b2=0.99)
    state = GANState(
        TrainState.create(gen, tx, cfg.train.seed,
                          ema_decay=ema_decay or None),
        TrainState.create(disc, tx, cfg.train.seed + 1))
    ckpt = CheckpointManager(out / "checkpoints", cfg,
                             keep_every_n=cfg.train.checkpoint_every_epochs,
                             mesh=mesh)
    state, start_epoch = resume_if_available(ckpt, state)
    if mesh is not None:
        state.place_on(mesh)
    return TrainLoop(
        state=state,
        train_step=make_gan_train_step(cfg, accum_steps, compute_dtype,
                                       remat),
        batcher=batcher,
        num_epochs=cfg.train.num_epochs,
        device=device,
        checkpoints=ckpt,
        metrics=_metrics(out / "metrics.csv", mesh),
        val_metric_key="gen_mel_l1",
        checkpoint_every=cfg.train.checkpoint_every_epochs,
        start_epoch=start_epoch,
        place_batch=_place_fn(device, accum_steps, mesh),
    )
