"""TTSPipeline — text → waveform synthesis on a CUDA device.

Counterpart of the JAX package's ``models/pipeline.py``:

    text → phoneme IDs (host) → encoder + duration head (stage A) →
    length regulation → VAE prior sample, inverse flow, decode → PostNet →
    HiFiGAN → waveform (stage B)

with the same static bucket ladders. A single utterance takes the fused
path: the frame budget comes from the phoneme count, durations that
overflow it are compressed by largest-remainder apportionment, and rows
compressed beyond ``fused_overflow_tolerance`` are redone on the two-stage
path. Batches take the two-stage path, whose frame bucket is measured from
the predicted durations.

Constructors: seeded random weights (:meth:`TTSPipeline.initialize`), the
JAX package's params (:meth:`TTSPipeline.from_jax_params`), or the four
training stages' checkpoints (:meth:`TTSPipeline.from_checkpoints`).

Not in this package yet: the packed single-transfer wire format (a TPU
transport), meshes, streaming and sharded vocoding, the long-text and
file entry points, and ``save``/``load`` of its own format.

Seeds do not reproduce across the two packages: prior noise here comes
from a ``torch.Generator``. ``temperature=0`` makes the prior sample
exactly zero in both, which is how the tests compare them end to end.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.convert.from_jax import state_dict_from_jax
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    length_regulate,
    padding_mask,
    round_up_to_multiple,
)
from iris_tts_tpu_torch.runtime import (
    DeviceLike,
    pin_f32_math,
    resolve_device,
    seeded_generator,
    wrap_int32,
)
from iris_tts_tpu_torch.text.frontend import (
    TextProcessor,
    create_text_processor,
)
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

logger = logging.getLogger(__name__)

PHONEME_BUCKETS = (16, 32, 64, 128, 256, 512)
FRAME_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (clamps to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def mel_time_major(mel, n_mels: int):
    """Normalise a mel to time-major ``[..., T, n_mels]``, accepting the
    reference layout ``[..., n_mels, T]``. A square mel is taken as
    time-major."""
    if mel.shape[-1] != n_mels:
        if mel.ndim < 2 or mel.shape[-2] != n_mels:
            raise ValueError(f"mel shape {tuple(mel.shape)} has no "
                             f"{n_mels}-sized axis")
        mel = mel.swapaxes(-1, -2)
    return mel


def host_pcm16(audio: np.ndarray) -> np.ndarray:
    """float waveform → int16 PCM on the host, with the same truncation as
    the on-device ``pcm16`` path."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


class SynthesisModel(nn.Module):
    """The five networks of the pipeline; its state-dict keys are the flax
    parameter paths joined with dots (``convert/from_jax.py``)."""

    def __init__(self, config: IrisConfig):
        super().__init__()
        self.encoder = PhonemeEncoder(config.encoder)
        self.duration = DurationPredictor(config.encoder.embed_dim,
                                          config.duration)
        self.vae = TextConditionedVAE(config.vae)
        self.postnet = PostNet(config.postnet)
        self.hifigan = HiFiGANGenerator(config.hifigan)


@dataclass
class TTSPipeline:
    """End-to-end text-to-speech pipeline. Build with :meth:`initialize`
    (seeded random weights) or :meth:`from_jax_params`."""

    config: IrisConfig
    model: SynthesisModel
    vocab: PhonemeVocab
    text_processor: TextProcessor
    device: torch.device
    use_postnet: bool = True
    seed: int = 1337
    phoneme_buckets: Tuple[int, ...] = PHONEME_BUCKETS
    frame_buckets: Tuple[int, ...] = FRAME_BUCKETS
    # Fused-path frame budget per phoneme; rows predicted beyond it are
    # compressed, and redone on the two-stage path when the compressed-away
    # fraction exceeds fused_overflow_tolerance (None: never redo).
    fused_frames_per_phoneme: int = 12
    fused_overflow_tolerance: Optional[float] = 0.1
    fused_overflow_count: int = field(default=0, init=False)
    fused_overflow_frames: int = field(default=0, init=False)
    fused_fallback_count: int = field(default=0, init=False)
    _seed_counter: int = field(default=0, init=False, repr=False)
    _overflow_log_t: float = field(default=0.0, init=False, repr=False)
    _ids_cache: Dict[str, np.ndarray] = field(
        default_factory=dict, init=False, repr=False)
    _ids_cache_max: int = field(default=4096, init=False, repr=False)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @staticmethod
    def _prepare(config: Optional[IrisConfig], vocab, text_processor,
                 lexicon_path):
        config = config or IrisConfig()
        vocab = vocab or PhonemeVocab.default_arpabet()
        if len(vocab) != config.encoder.vocab_size:
            config = replace(config, encoder=replace(
                config.encoder, vocab_size=len(vocab)))
        text_processor = text_processor or create_text_processor(
            lexicon_path=lexicon_path)
        return config, vocab, text_processor

    @classmethod
    def initialize(
        cls,
        config: Optional[IrisConfig] = None,
        seed: int = 1337,
        device: DeviceLike = None,
        vocab: Optional[PhonemeVocab] = None,
        text_processor: Optional[TextProcessor] = None,
        lexicon_path: Optional[Union[str, Path]] = None,
        use_postnet: bool = True,
    ) -> "TTSPipeline":
        """Seeded random-weight pipeline (flax-matching init distributions)
        on ``device`` (default: the CUDA device; raises without one)."""
        device = resolve_device(device)
        config, vocab, text_processor = cls._prepare(
            config, vocab, text_processor, lexicon_path)
        model = SynthesisModel(config)
        init_params(model, seeded_generator(seed, "cpu"))
        return cls._assemble(config, model, vocab, text_processor, device,
                             use_postnet, seed)

    @classmethod
    def from_jax_params(
        cls,
        params: Dict[str, Any],
        config: IrisConfig,
        device: DeviceLike = None,
        vocab: Optional[PhonemeVocab] = None,
        text_processor: Optional[TextProcessor] = None,
        lexicon_path: Optional[Union[str, Path]] = None,
        use_postnet: bool = True,
        seed: int = 1337,
    ) -> "TTSPipeline":
        """Pipeline from the JAX ``TTSPipeline.params`` tree with numpy
        leaves (see ``convert/from_jax.py``)."""
        device = resolve_device(device)
        config, vocab, text_processor = cls._prepare(
            config, vocab, text_processor, lexicon_path)
        model = SynthesisModel(config)
        model.load_state_dict(state_dict_from_jax(params, model), strict=True)
        return cls._assemble(config, model, vocab, text_processor, device,
                             use_postnet, seed)

    @classmethod
    def from_checkpoints(
        cls,
        encoder_checkpoint: Union[str, Path],
        vae_checkpoint: Union[str, Path],
        postnet_checkpoint: Optional[Union[str, Path]] = None,
        hifigan_gan_checkpoint: Optional[Union[str, Path]] = None,
        config: Optional[IrisConfig] = None,
        vocab: Optional[PhonemeVocab] = None,
        vocab_path: Optional[Union[str, Path]] = None,
        lexicon_path: Optional[Union[str, Path]] = None,
        device: DeviceLike = None,
        seed: int = 1337,
    ) -> "TTSPipeline":
        """Assemble the inference pipeline from the training stages' port
        checkpoints (``train/stages.py`` layout), best state first.

        ``config`` defaults to the one recorded beside the VAE checkpoints.
        ``hifigan_gan_checkpoint`` is the GAN stage's directory; its EMA
        generator deploys when the run tracked one. A missing PostNet
        serves the VAE output directly; a missing GAN checkpoint keeps the
        generator's seeded random weights. The vocab must be the one the
        encoder trained with (``vocab_path``: the stage's
        ``phoneme_vocab.json``)."""
        from iris_tts_tpu_torch.train.checkpoint import CheckpointManager

        vae_dir = Path(vae_checkpoint)
        if config is None:
            config = CheckpointManager(vae_dir).load_config()
        if vocab is None:
            vocab = (PhonemeVocab.load(vocab_path) if vocab_path
                     else PhonemeVocab.default_arpabet())
        if len(vocab) != config.encoder.vocab_size:
            raise ValueError(
                f"vocab size {len(vocab)} does not match the checkpointed "
                f"encoder vocab_size {config.encoder.vocab_size}; pass the "
                "vocab the model was trained with")
        device = resolve_device(device)
        config, vocab, text_processor = cls._prepare(
            config, vocab, None, lexicon_path)
        model = SynthesisModel(config)
        init_params(model, seeded_generator(seed, "cpu"))
        sd = model.state_dict()
        # Only the params of each stage are read: the optimizer state of
        # whatever schedule trained it plays no part in inference.
        sd.update(CheckpointManager(encoder_checkpoint)
                  .restore_best_params())
        sd.update({f"vae.{k}": v for k, v in
                   CheckpointManager(vae_dir).restore_best_params().items()})
        if postnet_checkpoint is not None:
            sd.update({f"postnet.{k}": v for k, v in CheckpointManager(
                postnet_checkpoint).restore_best_params().items()})
        if hifigan_gan_checkpoint is not None:
            gen = CheckpointManager(hifigan_gan_checkpoint
                                    ).restore_best_raw()["gen"]
            gen_params = gen["ema_params"] or gen["params"]
            sd.update({f"hifigan.{k}": v for k, v in gen_params.items()})
        model.load_state_dict(sd, strict=True)
        return cls._assemble(config, model, vocab, text_processor, device,
                             postnet_checkpoint is not None, seed)

    @classmethod
    def _assemble(cls, config, model, vocab, text_processor, device,
                  use_postnet, seed) -> "TTSPipeline":
        if config.hifigan.total_upsample != config.audio.hop_length:
            raise ValueError(
                f"HiFiGAN upsamples by {config.hifigan.total_upsample} but "
                f"hop_length is {config.audio.hop_length}")
        pin_f32_math()
        model = model.to(device).eval()
        for p in model.parameters():
            p.requires_grad_(False)
        return cls(config=config, model=model, vocab=vocab,
                   text_processor=text_processor, device=device,
                   use_postnet=use_postnet, seed=seed)

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _stage_a(self, ids: torch.Tensor, lengths: torch.Tensor):
        """[B,P] ids + [B] lengths → (enc [B,P,E], frames [B,P] int64,
        max total frames (0-d tensor))."""
        mask = padding_mask(lengths, ids.shape[1])
        enc = self.model.encoder(ids, padding_mask=mask)
        log_dur = self.model.duration(enc)
        frames = durations_from_log(log_dur).to(torch.int64) * mask
        return enc, frames, frames.sum(dim=1).max()

    def _acoustic(self, enc, frames, seed: int, total_frames: int,
                  temperature: float):
        """Length-regulate + VAE prior sample/inverse flow/decode (+
        PostNet) → (mel [B,T,n_mels], per-row frame counts [B])."""
        cond, frame_mask = length_regulate(enc, frames, total_frames)
        mel, _ = self.model.vae.generate(
            cond, temperature=temperature,
            generator=seeded_generator(seed, self.device))
        if self.use_postnet:
            mel = self.model.postnet(mel)
        return mel, (frame_mask > 0).sum(dim=1)

    @staticmethod
    def _compress(frames: torch.Tensor, total_frames: int):
        """Fit each row's durations into ``total_frames`` by
        largest-remainder apportionment: floor-scale, then give the
        leftover frames to the largest remainders (stable order on ties,
        as ``jnp.argsort``), so a compressed row sums to exactly the
        budget. Returns (frames, per-row deficit = predicted − budget)."""
        frames = frames.clamp(max=total_frames)
        total = frames.sum(dim=1, keepdim=True)
        capped = total.clamp(max=total_frames)
        denom = total.clamp(min=1)
        scaled = (frames * capped) // denom
        rem = (frames * capped) % denom
        shortfall = capped[:, 0] - scaled.sum(dim=1)
        ranks = torch.argsort(torch.argsort(-rem, dim=1, stable=True), dim=1)
        bump = (ranks < shortfall[:, None]).to(frames.dtype)
        frames = torch.where(total > total_frames, scaled + bump, frames)
        deficit = (total - total_frames).clamp(min=0)[:, 0]
        return frames, deficit

    def _vocode_device(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model.hifigan(mel)

    @staticmethod
    def _maybe_pcm16(audio: torch.Tensor, pcm16: bool) -> torch.Tensor:
        """On-device PCM16: ``(clip(audio, −1, 1) · 32767)`` truncated to
        int16, as the JAX package's ``_maybe_pcm16``."""
        if not pcm16:
            return audio
        return (audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)

    # ------------------------------------------------------------------
    # host-side API
    # ------------------------------------------------------------------

    def _next_seed(self, seed: Optional[int]) -> int:
        """The per-call seed (auto-incremented when None), wrapped to
        int32 here and nowhere else."""
        if seed is None:
            self._seed_counter += 1
            seed = self.seed + self._seed_counter
        return wrap_int32(seed)

    def _text_to_ids_cached(self, text: str) -> np.ndarray:
        ids = self._ids_cache.get(text)
        if ids is None:
            ids = self.text_processor.text_to_ids(text, self.vocab)
            if len(self._ids_cache) >= self._ids_cache_max:
                self._ids_cache.pop(next(iter(self._ids_cache)))
            self._ids_cache[text] = ids
        return ids

    def _encode_texts(self, texts: Sequence[str]):
        """Texts → bucketed, padded [B, P] ids + [B] lengths (host)."""
        if not texts:
            raise ValueError("synthesize needs at least one utterance")
        id_lists = [self._text_to_ids_cached(t) for t in texts]
        lengths = np.array([len(i) for i in id_lists], np.int64)
        p_bucket = pick_bucket(int(lengths.max()), self.phoneme_buckets)
        if int(lengths.max()) > p_bucket:
            logger.warning(
                "utterance with %d phonemes exceeds the largest phoneme "
                "bucket (%d); the tail will be truncated",
                int(lengths.max()), p_bucket)
            lengths = np.minimum(lengths, p_bucket)
        ids = np.full((len(texts), p_bucket), self.vocab.pad_id, np.int64)
        for row, seq in zip(ids, id_lists):
            row[: len(seq)] = seq[:p_bucket]
        return ids, lengths

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _run_stage_a(self, texts: Sequence[str]):
        """Host frontend + stage A + frame-bucket choice (one scalar
        comes back to the host)."""
        ids, lengths = self._to_device(*self._encode_texts(texts))
        enc, frames, total_t = self._stage_a(ids, lengths)
        total = int(total_t)
        factor = self.config.vae.down_factor
        t_bucket = pick_bucket(
            round_up_to_multiple(max(total, factor), factor),
            self.frame_buckets)
        if total > t_bucket:
            logger.warning(
                "predicted %d frames exceed the largest frame bucket (%d); "
                "the audio tail will be truncated", total, t_bucket)
        return enc, frames, t_bucket

    def _fused_frame_budget(self, lengths: np.ndarray) -> int:
        factor = self.config.vae.down_factor
        est = int(lengths.max()) * self.fused_frames_per_phoneme
        return pick_bucket(round_up_to_multiple(max(est, factor), factor),
                           self.frame_buckets)

    def _count_overflows(self, deficit: np.ndarray) -> None:
        n_over = int((deficit > 0).sum())
        if not n_over:
            return
        self.fused_overflow_count += n_over
        self.fused_overflow_frames += int(deficit.sum())
        now = time.monotonic()
        if now - self._overflow_log_t > 60.0:
            self._overflow_log_t = now
            logger.warning(
                "fused path compressed %d utterance(s) by up to %d frames "
                "(%d total so far); raise fused_frames_per_phoneme if "
                "frequent", n_over, int(deficit.max()),
                self.fused_overflow_count)

    def _overflow_fallback_rows(self, deficit: np.ndarray,
                                t_bucket: int) -> list:
        """Rows whose compressed-away fraction deficit / (deficit + budget)
        exceeds the tolerance."""
        tol = self.fused_overflow_tolerance
        if tol is None:
            return []
        deficit = np.asarray(deficit, np.int64)
        frac = deficit / np.maximum(deficit + t_bucket, 1)
        rows = np.nonzero(frac > tol)[0].tolist()
        self.fused_fallback_count += len(rows)
        return rows

    def _fetch_rows(self, audio, n_frames, mel, pcm16: bool, n: int):
        """One device→host copy of the batch, trimmed per row."""
        hop = self.config.hifigan.total_upsample
        n_np = n_frames.cpu().numpy().astype(np.int64)
        audio_np = audio.cpu().numpy()
        audio_np = audio_np.astype(np.int16 if pcm16 else np.float32,
                                   copy=False)
        outs = [a[: int(k) * hop] for a, k in zip(audio_np[:n], n_np)]
        mels = None
        if mel is not None:
            mel_np = mel.cpu().numpy()
            mels = [m[: int(k)] for m, k in zip(mel_np[:n], n_np)]
        return outs, mels

    @torch.inference_mode()
    def synthesize(
        self,
        text: Union[str, Sequence[str]],
        seed: Optional[int] = None,
        temperature: float = 1.0,
        return_mel: bool = False,
        fused: Optional[bool] = None,
        pcm16: bool = False,
    ):
        """Text → 22.05 kHz waveform(s) as numpy (float32, or int16 with
        ``pcm16``), trimmed to each utterance's frame count × hop.

        ``fused`` defaults to True for one utterance and False for a
        batch. With ``return_mel`` the trimmed mels come back too."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        if fused is None:
            fused = len(texts) == 1
        seed_int = self._next_seed(seed)

        if fused:
            ids_np, lengths_np = self._encode_texts(texts)
            t_bucket = self._fused_frame_budget(lengths_np)
            ids, lengths = self._to_device(ids_np, lengths_np)
            enc, frames, _ = self._stage_a(ids, lengths)
            frames, deficit = self._compress(frames, t_bucket)
            mel, n_frames = self._acoustic(enc, frames, seed_int, t_bucket,
                                           temperature)
            deficit_np = deficit.cpu().numpy()
            self._count_overflows(deficit_np)
        else:
            enc, frames, t_bucket = self._run_stage_a(texts)
            mel, n_frames = self._acoustic(enc, frames, seed_int, t_bucket,
                                           temperature)
            deficit_np = None
        audio = self._maybe_pcm16(self._vocode_device(mel), pcm16)
        outs, mels = self._fetch_rows(audio, n_frames,
                                      mel if return_mel else None, pcm16,
                                      len(texts))

        if deficit_np is not None:
            redo = self._overflow_fallback_rows(deficit_np, t_bucket)
            if redo:
                logger.info("re-synthesizing %d over-compressed row(s) on "
                            "the two-stage path", len(redo))
                r_outs, r_mels = self._two_stage_rows(
                    [texts[i] for i in redo], seed_int, temperature, pcm16,
                    return_mel)
                for j, i in enumerate(redo):
                    outs[i] = r_outs[j]
                    if mels is not None:
                        mels[i] = r_mels[j]
        if return_mel:
            return (outs[0], mels[0]) if single else (outs, mels)
        return outs[0] if single else outs

    def _two_stage_rows(self, texts, seed_int, temperature, pcm16,
                        return_mel):
        """Two-stage synthesis of a row subset (the overflow redo)."""
        enc, frames, t_bucket = self._run_stage_a(texts)
        mel, n_frames = self._acoustic(enc, frames, seed_int, t_bucket,
                                       temperature)
        audio = self._maybe_pcm16(self._vocode_device(mel), pcm16)
        return self._fetch_rows(audio, n_frames,
                                mel if return_mel else None, pcm16,
                                len(texts))

    @torch.inference_mode()
    def synthesize_mel(
        self,
        text: Union[str, Sequence[str]],
        seed: Optional[int] = None,
        temperature: float = 1.0,
    ):
        """Text → log-mel [T, n_mels] (acoustic model only, two-stage)."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        enc, frames, t_bucket = self._run_stage_a(texts)
        mel, n_frames = self._acoustic(enc, frames, self._next_seed(seed),
                                       t_bucket, temperature)
        n_np = n_frames.cpu().numpy().astype(np.int64)
        mel_np = mel.cpu().numpy()
        outs = [m[: int(k)] for m, k in zip(mel_np, n_np)]
        return outs[0] if single else outs

    @torch.inference_mode()
    def vocode(self, mel) -> np.ndarray:
        """Log-mel → waveform (numpy f32). Accepts time-major [T, n_mels]
        / [B, T, n_mels] or reference layout [n_mels, T] / [B, n_mels, T],
        as numpy or as a tensor; a tensor already on the device stays
        there."""
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.asarray(mel, np.float32))
        mel = mel.to(self.device, torch.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        mel = mel_time_major(mel, self.config.hifigan.in_channels)
        audio = self._vocode_device(mel.contiguous()).cpu().numpy()
        return audio[0] if squeeze else audio
