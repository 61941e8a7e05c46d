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
JAX package's params (:meth:`TTSPipeline.from_jax_params`), the four
training stages' checkpoints (:meth:`TTSPipeline.from_checkpoints`), or a
directory written by :meth:`TTSPipeline.save` (:meth:`TTSPipeline.load`).

Beyond one-shot synthesis: exact chunked vocoding
(:meth:`~TTSPipeline.vocode_streaming`), long text split at sentence
boundaries (:meth:`~TTSPipeline.synthesize_long`,
:meth:`~TTSPipeline.stream`, :meth:`~TTSPipeline.synthesize_to_file`),
warmup of every serving shape, and the dispatch/collect split the serving
batcher (``serve/batcher.py``) drives. Phoneme features reach frame rate by
hard length regulation or, with ``upsample="gaussian"``, by Gaussian
upsampling. The host-side stage methods open ``utils/prof`` spans
(``iris.encode``, ``iris.stage_a``, ``iris.stage_b``, ``iris.acoustic``,
``iris.vocoder``, ``iris.collect``) while a profiler records.

The fused path's device work is one function, :func:`fused_synthesis`,
whose prior noise is an input. The live path draws that noise from a
seeded ``torch.Generator`` (:func:`prior_noise`); ``serve/export.py``
exports the same function per (batch, phoneme) bucket with
``torch.export`` and feeds it the same noise.

``dtype=torch.bfloat16`` on every constructor (or ``dataclasses.replace(
pipe, dtype=...)``) computes in bf16 as the JAX package's ``dtype`` does:
the parameters stay f32, each layer casts at the op
(``models/layers.py``), frame counts are summed in int32, and the public
API returns f32 audio and mels. Not in this package: the packed
single-transfer wire format (a TPU transport).

Multi-device (``parallel/``): :meth:`TTSPipeline.use_mesh` runs every
entry point over a ``(data, model)`` mesh of ``torch.distributed``
processes: each data coordinate runs its rows of the global batch, the
ranks of one model group run the same rows with the wide layers' output
channels split between them (tensor parallelism, ``parallel/tp.py``), and
every rank returns the whole result; :meth:`TTSPipeline.vocode_sharded`
splits one mel's time axis over every rank.

Seeds do not reproduce across the two packages: prior noise here comes
from a ``torch.Generator``. ``temperature=0`` makes the prior sample
exactly zero in both, which is how the tests compare them end to end.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import IrisConfig, load_config, save_config
from iris_tts_tpu_torch.convert.from_jax import state_dict_from_jax
from iris_tts_tpu_torch.data.audio_io import join_wave_chunks, write_wav
from iris_tts_tpu_torch.models.bigvgan import generator_class
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import (
    iter_stream_windows,
    receptive_radius_frames,
)
from iris_tts_tpu_torch.models.layers import (
    dtype_view,
    init_params,
    module_dtype,
    set_dtype,
)
from iris_tts_tpu_torch.models.postnet import PostNet
from iris_tts_tpu_torch.models.vae import TextConditionedVAE
from iris_tts_tpu_torch.parallel.mesh import (
    all_reduce_,
    gather_rows,
    local_only,
    local_rows,
    pad_rows,
    reduce_rows,
    unwiden,
)
from iris_tts_tpu_torch.parallel.sharding import full_state_dict
from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    frame_counts,
    gaussian_upsample,
    length_regulate,
    padding_mask,
    pick_bucket,
    round_up_to_multiple,
)
from iris_tts_tpu_torch.runtime import (
    DeviceLike,
    DtypeLike,
    pin_math_precision,
    resolve_device,
    resolve_dtype,
    seeded_generator,
    wrap_int32,
)
from iris_tts_tpu_torch.text.frontend import (
    TextProcessor,
    chunk_text_by_phonemes,
    create_text_processor,
)
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab
from iris_tts_tpu_torch.utils import prof

logger = logging.getLogger(__name__)

PHONEME_BUCKETS = (16, 32, 64, 128, 256, 512)
FRAME_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


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


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy on the host, floats as f32: a bf16 tensor
    crosses at its own width and is widened on the host (numpy has no
    bf16)."""
    t = t.cpu()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    return t.numpy()


def host_pcm16(audio: np.ndarray) -> np.ndarray:
    """float waveform → int16 PCM on the host, with the same truncation as
    the on-device ``pcm16`` path."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


class _Dispatch(NamedTuple):
    """Device results of one synthesis dispatch, not yet on the host:
    audio rows (the compute dtype, or int16 with ``pcm16``), per-row frame
    counts, the mels when the caller asked for them, and the number of real
    rows.
    ``pcm16`` travels with the handle so the collect cannot misread it."""

    audio: torch.Tensor
    n_frames: torch.Tensor
    mel: Optional[torch.Tensor]
    n: int
    pcm16: bool


class SynthesisModel(nn.Module):
    """The five networks of the pipeline; its state-dict keys are the flax
    parameter paths joined with dots (``convert/from_jax.py``). The vocoder
    (``hifigan``) is the generator the config states: HiFiGAN, or BigVGAN
    for ``activation="snakebeta"`` (``models/bigvgan.py``, NVIDIA's key
    names)."""

    def __init__(self, config: IrisConfig):
        super().__init__()
        self.encoder = PhonemeEncoder(config.encoder)
        self.duration = DurationPredictor(config.encoder.embed_dim,
                                          config.duration)
        self.vae = TextConditionedVAE(config.vae)
        self.postnet = PostNet(config.postnet)
        self.hifigan = generator_class(config.hifigan)(config.hifigan)


UPSAMPLE_MODES = ("hard", "gaussian")


def stage_a(model: SynthesisModel, ids: torch.Tensor, lengths: torch.Tensor):
    """Encoder + duration head: [B,P] ids + [B] lengths → (enc [B,P,E],
    frames [B,P] int64, max total frames as a 0-d tensor: no host sync)."""
    mask = padding_mask(lengths, ids.shape[1])
    enc = model.encoder(ids, padding_mask=mask)
    log_dur = model.duration(enc)
    frames = durations_from_log(log_dur).to(torch.int64) * mask
    return enc, frames, frames.sum(dim=1).max()


def compress_durations(frames: torch.Tensor, total_frames: int):
    """Fit each row's durations into ``total_frames`` by largest-remainder
    apportionment: floor-scale, then give the leftover frames to the
    largest remainders (stable order on ties, as ``jnp.argsort``), so a
    compressed row sums to exactly the budget. Returns (frames, per-row
    deficit = predicted − budget)."""
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


def prior_latent(eps: torch.Tensor, temperature) -> torch.Tensor:
    """The prior latent ``temperature · eps`` in f32 whatever ``eps``'s
    dtype: JAX's temperature is a traced f32 scalar, which promotes its
    compute-dtype draw to f32. A float and a 0-d f32 tensor give the same
    bits here, so the live path and the exported programs agree."""
    return temperature * eps.float()


def acoustic(model: SynthesisModel, enc, frames, total_frames: int,
             z: torch.Tensor, use_postnet: bool, upsample: str):
    """Frame-rate conditioning (hard length regulation, or Gaussian
    upsampling) + inverse flow and decode of the prior latent ``z``
    [B, latent, T/down_factor] (+ PostNet) → (mel [B,T,n_mels], per-row
    frame counts [B])."""
    regulate = gaussian_upsample if upsample == "gaussian" else length_regulate
    cond, frame_mask = regulate(enc, frames, total_frames)
    mel, _ = model.vae.generate(cond, z_prior=z.transpose(1, 2))
    if use_postnet:
        mel = model.postnet(mel)
    return mel, frame_counts(frame_mask)


def prior_noise(batch: int, latent_dim: int, total_frames: int,
                down_factor: int, seed: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The prior's standard normal noise [B, latent, T/down_factor] from a
    generator seeded with ``seed`` on ``device``, drawn in f32 and rounded
    to the compute ``dtype``: the draw ``TextConditionedVAE.generate``
    makes when it is given no latent."""
    return torch.randn((batch, latent_dim, total_frames // down_factor),
                       generator=seeded_generator(seed, device),
                       device=device, dtype=torch.float32).to(dtype)


def fused_mel(model: nn.Module, ids: torch.Tensor, lengths: torch.Tensor,
              eps: torch.Tensor, temperature, total_frames: int,
              use_postnet: bool, upsample: str):
    """The fused path's text→mel work: stage A, compression into the
    ``total_frames`` budget and the acoustic model on the prior latent
    ``temperature · eps`` → (mel [B,T,n_mels], n_frames [B] int32, deficit
    [B]). ``model`` needs only the encoder, duration head, VAE and PostNet
    (the pipeline split's first stage holds no vocoder)."""
    enc, frames, _ = stage_a(model, ids, lengths)
    frames, deficit = compress_durations(frames, total_frames)
    mel, n_frames = acoustic(model, enc, frames, total_frames,
                             prior_latent(eps, temperature), use_postnet,
                             upsample)
    return mel, n_frames, deficit


def fused_synthesis(model: SynthesisModel, ids: torch.Tensor,
                    lengths: torch.Tensor, eps: torch.Tensor, temperature,
                    total_frames: int, use_postnet: bool, upsample: str):
    """The fused path's device work, shared by the live pipeline and the
    exported programs: :func:`fused_mel`, then the vocoder.

    Inputs: ids [B,P] int64, lengths [B] int64, eps [B, latent,
    T/down_factor] in the model's compute dtype, temperature (float or 0-d
    f32 tensor). Outputs: (audio [B, T·hop] and mel [B,T,n_mels] in the
    compute dtype, n_frames [B] int32, deficit [B]). Nothing in it reads a
    value back to the host."""
    mel, n_frames, deficit = fused_mel(model, ids, lengths, eps, temperature,
                                       total_frames, use_postnet, upsample)
    return model.hifigan(mel), mel, n_frames, deficit


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
    # Frame-rate conditioning: "hard" length regulation or "gaussian"
    # upsampling (ops/length.py).
    upsample: str = "hard"
    # Compute dtype (float32 or bfloat16; params stay float32). Another
    # dtype than the model's gives this pipeline a view of the model in it
    # (layers.dtype_view: same parameters), so dataclasses.replace(pipe,
    # dtype=...) leaves the original pipeline as it was.
    dtype: torch.dtype = torch.float32
    phoneme_buckets: Tuple[int, ...] = PHONEME_BUCKETS
    frame_buckets: Tuple[int, ...] = FRAME_BUCKETS
    # Fused-path frame budget per phoneme; rows predicted beyond it are
    # compressed, and redone on the two-stage path when the compressed-away
    # fraction exceeds fused_overflow_tolerance (None: never redo).
    fused_frames_per_phoneme: int = 12
    fused_overflow_tolerance: Optional[float] = 0.1
    fused_overflow_count: int = field(default=0, init=False)
    fused_fallback_count: int = field(default=0, init=False)
    _seed_counter: int = field(default=0, init=False, repr=False)
    _overflow_log_t: float = field(default=0.0, init=False, repr=False)
    _ids_cache: Dict[str, np.ndarray] = field(
        default_factory=dict, init=False, repr=False)
    _ids_cache_max: int = field(default=4096, init=False, repr=False)
    # The (data, model) mesh of use_mesh (None: this process alone).
    _mesh: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.upsample not in UPSAMPLE_MODES:
            raise ValueError(f"upsample={self.upsample!r} is not one of "
                             f"{UPSAMPLE_MODES}")
        self.dtype = resolve_dtype(self.dtype)
        if module_dtype(self.model) != self.dtype:
            self.model = dtype_view(self.model, self.dtype)

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
        vocab: Optional[PhonemeVocab] = None,
        text_processor: Optional[TextProcessor] = None,
        lexicon_path: Optional[Union[str, Path]] = None,
        seed: int = 1337,
        use_postnet: bool = True,
        dtype: DtypeLike = None,
        device: DeviceLike = None,
    ) -> "TTSPipeline":
        """Seeded random-weight pipeline (flax-matching init distributions)
        on ``device`` (default: the CUDA device; raises without one),
        computing in ``dtype`` (default float32; params stay float32)."""
        device = resolve_device(device)
        config, vocab, text_processor = cls._prepare(
            config, vocab, text_processor, lexicon_path)
        model = SynthesisModel(config)
        init_params(model, seeded_generator(seed, "cpu"))
        return cls._assemble(config, model, vocab, text_processor, device,
                             use_postnet, seed, dtype=dtype)

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
        dtype: DtypeLike = None,
        vocoder_state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ) -> "TTSPipeline":
        """Pipeline from the JAX ``TTSPipeline.params`` tree with numpy
        leaves (see ``convert/from_jax.py``), computing in ``dtype``.

        ``vocoder_state_dict``: the vocoder's weights as a state dict of the
        port's generator instead (a ``params`` without ``hifigan``): how a
        BigVGAN, which the JAX package does not have, joins the acoustic
        model (``convert/bigvgan.py`` reads NVIDIA's checkpoints)."""
        device = resolve_device(device)
        config, vocab, text_processor = cls._prepare(
            config, vocab, text_processor, lexicon_path)
        model = SynthesisModel(config)
        if vocoder_state_dict is None:
            sd = state_dict_from_jax(params, model)
        else:
            if "hifigan" in params:
                raise ValueError("pass the vocoder in params or in "
                                 "vocoder_state_dict, not both")
            acoustic = nn.ModuleDict({k: v for k, v in model.named_children()
                                      if k != "hifigan"})
            sd = state_dict_from_jax(params, acoustic)
            sd.update({f"hifigan.{k}": v
                       for k, v in vocoder_state_dict.items()})
        model.load_state_dict(sd, strict=True)
        return cls._assemble(config, model, vocab, text_processor, device,
                             use_postnet, seed, dtype=dtype)

    @classmethod
    def from_checkpoints(
        cls,
        encoder_checkpoint: Union[str, Path],
        vae_checkpoint: Union[str, Path],
        postnet_checkpoint: Optional[Union[str, Path]] = None,
        hifigan_checkpoint: Optional[Union[str, Path]] = None,
        hifigan_gan_checkpoint: Optional[Union[str, Path]] = None,
        config: Optional[IrisConfig] = None,
        vocab: Optional[PhonemeVocab] = None,
        vocab_path: Optional[Union[str, Path]] = None,
        lexicon_path: Optional[Union[str, Path]] = None,
        dtype: DtypeLike = None,
        device: DeviceLike = None,
        seed: int = 1337,
    ) -> "TTSPipeline":
        """Assemble the inference pipeline from the training stages'
        checkpoints, best state first, computing in ``dtype``: the port's
        (``train/stages.py`` layout) or the JAX package's (its orbax stage
        directories, read without JAX and mapped as :meth:`from_jax_params`
        maps, the PostNet's batch statistics included).

        ``config`` defaults to the one recorded beside the VAE checkpoints.
        ``hifigan_checkpoint`` is a torch ``generator.ckpt`` run through
        the weight converter (``convert/hifigan_torch.py``);
        ``hifigan_gan_checkpoint`` is the GAN stage's directory, whose EMA
        generator deploys when the run tracked one; passing both raises. A
        missing PostNet serves the VAE output directly; with neither
        vocoder checkpoint the generator keeps its seeded random weights.
        The vocab must be the one the encoder trained with
        (``vocab_path``: the stage's ``phoneme_vocab.json``)."""
        from iris_tts_tpu_torch.train.checkpoint import (
            CheckpointManager,
            is_jax_state,
        )

        if hifigan_checkpoint is not None and hifigan_gan_checkpoint:
            raise ValueError(
                "pass either hifigan_checkpoint (torch) or "
                "hifigan_gan_checkpoint (train_hifigan stage), not both")
        vae_dir = Path(vae_checkpoint)
        if config is None:
            cfg_file = vae_dir / "config.json"
            if not cfg_file.exists():  # the JAX package's stage scripts
                cfg_file = vae_dir.parent / "config_vae.json"
            config = load_config(cfg_file)
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
        enc = CheckpointManager(encoder_checkpoint).restore_best_raw()
        if is_jax_state(enc):
            sd.update(state_dict_from_jax(
                {k: enc["params"][k] for k in ("encoder", "duration")}))
        else:
            sd.update(enc["params"])
        vae = CheckpointManager(vae_dir).restore_best_raw()
        sd.update(state_dict_from_jax({"vae": vae["params"]})
                  if is_jax_state(vae) else
                  {f"vae.{k}": v for k, v in vae["params"].items()})
        if postnet_checkpoint is not None:
            pn = CheckpointManager(postnet_checkpoint).restore_best_raw()
            sd.update(state_dict_from_jax({"postnet": {
                "params": pn["params"], "batch_stats": pn["batch_stats"]}})
                if is_jax_state(pn) else
                {f"postnet.{k}": v for k, v in pn["params"].items()})
        if hifigan_checkpoint is not None:
            from iris_tts_tpu_torch.convert.hifigan_torch import (
                convert_hifigan_state_dict,
                load_torch_checkpoint,
            )

            gen = convert_hifigan_state_dict(
                load_torch_checkpoint(hifigan_checkpoint), config.hifigan)
            sd.update({f"hifigan.{k}": v for k, v in gen.items()})
        elif hifigan_gan_checkpoint is not None:
            raw = CheckpointManager(hifigan_gan_checkpoint).restore_best_raw()
            if is_jax_state(raw):  # the generator's own stage directory
                sd.update(state_dict_from_jax(
                    {"hifigan": raw.get("ema_params") or raw["params"]}))
            else:
                gen = raw["gen"]
                gen_params = gen["ema_params"] or gen["params"]
                sd.update({f"hifigan.{k}": v for k, v in gen_params.items()})
        model.load_state_dict(sd, strict=True)
        return cls._assemble(config, model, vocab, text_processor, device,
                             postnet_checkpoint is not None, seed,
                             dtype=dtype)

    @classmethod
    def _assemble(cls, config, model, vocab, text_processor, device,
                  use_postnet, seed, upsample="hard",
                  dtype: DtypeLike = None) -> "TTSPipeline":
        pin_math_precision()
        dtype = resolve_dtype(dtype)
        model = set_dtype(model.to(device).eval(), dtype)
        for p in model.parameters():
            p.requires_grad_(False)
        return cls(config=config, model=model, vocab=vocab,
                   text_processor=text_processor, device=device,
                   use_postnet=use_postnet, seed=seed, upsample=upsample,
                   dtype=dtype)

    # ------------------------------------------------------------------
    # deployable directory
    # ------------------------------------------------------------------

    def save(self, path: Union[str, Path], half: bool = False) -> None:
        """Write the assembled pipeline as one deployable directory:
        ``params`` (the model's state dict through
        ``train.checkpoint.save_params``, BatchNorm statistics included),
        ``config.json``, ``vocab.json`` and ``meta.json`` (the options and
        the tuned serving knobs, with the JAX package's keys).

        ``half=True`` stores the floating tensors as float16 (about half
        the bytes; raises ``ValueError`` for a tensor outside float16's
        range); :meth:`load` casts them back to float32. The params are
        f32 whatever the compute dtype, and the compute dtype is not
        stored: :meth:`load` takes it, as the JAX package's does.

        The format is the port's own, which the JAX package does not read.
        The port reads the JAX package's artifacts (orbax ``params``) as
        well: :meth:`load` takes either. A pipeline sharded over a model axis
        writes whole tensors: every rank of the axis calls ``save`` (the
        slices are gathered), each to a path of its own or rank 0 alone
        writing."""
        from iris_tts_tpu_torch.train.checkpoint import save_params

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        sd = {k: v.detach().cpu()
              for k, v in full_state_dict(self.model).items()}
        if half:
            sd = {k: v.half() if v.is_floating_point() else v
                  for k, v in sd.items()}
            for k, v in sd.items():
                if v.is_floating_point() and not bool(v.isfinite().all()):
                    raise ValueError(f"params tensor {k!r} exceeds the "
                                     "float16 range; save it with half=False")
        save_params(path / "params", sd)
        save_config(self.config, path / "config.json")
        self.vocab.save(path / "vocab.json")
        (path / "meta.json").write_text(json.dumps({
            "use_postnet": self.use_postnet,
            "seed": self.seed,
            "upsample": self.upsample,
            "params_dtype": "float16" if half else "float32",
            # Dropping these on reload would silently revert an operator's
            # overflow-budget and bucket tuning.
            "fused_frames_per_phoneme": self.fused_frames_per_phoneme,
            "fused_overflow_tolerance": self.fused_overflow_tolerance,
            "phoneme_buckets": list(self.phoneme_buckets),
            "frame_buckets": list(self.frame_buckets),
        }))

    @classmethod
    def load(
        cls,
        path: Union[str, Path],
        lexicon_path: Optional[Union[str, Path]] = None,
        dtype: DtypeLike = None,
        device: DeviceLike = None,
    ) -> "TTSPipeline":
        """Load a directory written by :meth:`save`, or by the JAX
        package's ``TTSPipeline.save`` (orbax ``params``, read without JAX
        by ``convert/orbax.py`` and mapped as :meth:`from_jax_params`
        maps), onto ``device`` (default: the CUDA device; raises without
        one), computing in ``dtype`` (default float32). Raises
        ``ValueError`` naming the tensor when a stored tensor is missing,
        extra, or of another shape than the config builds."""
        from iris_tts_tpu_torch.convert.orbax import (
            is_orbax_checkpoint,
            read_tree,
        )
        from iris_tts_tpu_torch.train.checkpoint import load_params

        path = Path(path)
        device = resolve_device(device)
        config = load_config(path / "config.json")
        vocab = PhonemeVocab.load(path / "vocab.json")
        meta = json.loads((path / "meta.json").read_text())
        config, vocab, text_processor = cls._prepare(config, vocab, None,
                                                     lexicon_path)
        model = SynthesisModel(config)
        if is_orbax_checkpoint(path / "params"):
            # float16 params come back float32, as every leaf of
            # state_dict_from_jax does; it raises naming a missing, extra
            # or misshapen leaf.
            sd = state_dict_from_jax(read_tree(path / "params"), model)
        else:
            want = model.state_dict()
            sd = load_params(path / "params")
            missing = sorted(set(want) - set(sd))
            extra = sorted(set(sd) - set(want))
            if missing or extra:
                raise ValueError(f"params do not match the config: missing "
                                 f"{missing[:5]}, unexpected {extra[:5]}")
            for k, v in sd.items():
                if tuple(v.shape) != tuple(want[k].shape):
                    raise ValueError(
                        f"params tensor {k!r} has shape {tuple(v.shape)}, "
                        f"the config builds {tuple(want[k].shape)}")
            if meta.get("params_dtype") == "float16":
                sd = {k: v.float() if v.is_floating_point() else v
                      for k, v in sd.items()}
        model.load_state_dict(sd, strict=True)
        pipe = cls._assemble(config, model, vocab, text_processor, device,
                             meta.get("use_postnet", True),
                             meta.get("seed", 1337),
                             meta.get("upsample", "hard"), dtype=dtype)
        pipe.fused_frames_per_phoneme = int(meta.get(
            "fused_frames_per_phoneme", pipe.fused_frames_per_phoneme))
        if "fused_overflow_tolerance" in meta:
            tol = meta["fused_overflow_tolerance"]
            pipe.fused_overflow_tolerance = None if tol is None else float(tol)
        if "phoneme_buckets" in meta:
            pipe.phoneme_buckets = tuple(meta["phoneme_buckets"])
        if "frame_buckets" in meta:
            pipe.frame_buckets = tuple(meta["frame_buckets"])
        return pipe

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _prior_noise(self, batch: int, total_frames: int,
                     seed: int) -> torch.Tensor:
        """The prior noise of a ``batch``-row request. On a mesh the whole
        request's noise is drawn and this rank keeps its rows of the padded
        batch (the pad rows copy the last row's), so the mesh draws what
        one device does."""
        eps = prior_noise(batch, self.config.vae.latent_dim, total_frames,
                          self.config.vae.down_factor, seed, self.device,
                          self.dtype)
        if not self._on_mesh():
            return eps
        return local_rows(pad_rows(eps, self._mesh.data_size), self._mesh)

    def _acoustic(self, enc, frames, seed: int, total_frames: int,
                  temperature: float, n: int):
        """:func:`acoustic` on the prior sample of ``seed`` for this rank's
        rows of an ``n``-row request → (mel [B,T,n_mels], per-row frame
        counts [B])."""
        with prof.span("acoustic"):
            eps = self._prior_noise(n, total_frames, seed)
            return acoustic(self.model, enc, frames, total_frames,
                            prior_latent(eps, temperature), self.use_postnet,
                            self.upsample)

    def _vocode_device(self, mel: torch.Tensor) -> torch.Tensor:
        with prof.span("vocoder"):
            return self.model.hifigan(mel)

    def _vocode_window(self, mel: torch.Tensor, start: int,
                       chunk_samples: int, pcm16: bool) -> torch.Tensor:
        """Vocode one fixed-size mel window and keep only the
        ``chunk_samples`` samples from ``start``, sliced on the device so
        the copy to the host is chunk-sized: the device stage of
        :meth:`vocode_streaming`."""
        audio = self._vocode_device(mel)
        return self._maybe_pcm16(audio[:, start:start + chunk_samples], pcm16)

    @staticmethod
    def _maybe_pcm16(audio: torch.Tensor, pcm16: bool) -> torch.Tensor:
        """On-device PCM16: ``(clip(audio, −1, 1) · 32767)`` truncated to
        int16, as the JAX package's ``_maybe_pcm16``."""
        if not pcm16:
            return audio
        return (audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)

    def _stage_b(self, enc, frames, t_bucket: int, seed_int: int,
                 temperature: float, pcm16: bool, n: int,
                 return_mel: bool = False) -> _Dispatch:
        """Acoustic model, vocoder and optional PCM16 on the device, left
        there (no host sync); on a mesh, this rank's rows of an ``n``-row
        request, gathered."""
        with prof.span("stage_b"):
            mel, n_frames = self._acoustic(enc, frames, seed_int, t_bucket,
                                           temperature, n)
            audio = self._maybe_pcm16(self._vocode_device(mel), pcm16)
            return _Dispatch(self._gather(audio, n),
                             self._gather(n_frames, n),
                             self._gather(mel, n) if return_mel else None, n,
                             pcm16)

    def _sync(self) -> None:
        """Wait for the device's queued work (warmup barrier)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        with prof.span("encode"):
            id_lists = [self._text_to_ids_cached(t) for t in texts]
            lengths = np.array([len(i) for i in id_lists], np.int64)
            p_bucket = pick_bucket(int(lengths.max()), self.phoneme_buckets)
            if int(lengths.max()) > p_bucket:
                logger.warning(
                    "utterance with %d phonemes exceeds the largest phoneme "
                    "bucket (%d); the tail will be truncated",
                    int(lengths.max()), p_bucket)
                lengths = np.minimum(lengths, p_bucket)
            ids = np.full((len(texts), p_bucket), self.vocab.pad_id,
                          np.int64)
            for row, seq in zip(ids, id_lists):
                row[: len(seq)] = seq[:p_bucket]
            return ids, lengths

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    # -- mesh (use_mesh) ----------------------------------------------------

    def _on_mesh(self) -> bool:
        return not local_only(self._mesh)

    def _rows_to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays of a request → on the device; on a mesh, this rank's
        rows of the request padded to the data axis with copies of its last
        row."""
        if not self._on_mesh():
            return self._to_device(*arrays)
        dp = self._mesh.data_size
        return self._to_device(*(local_rows(pad_rows(a, dp), self._mesh)
                                 for a in arrays))

    def _gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's rows → the request's ``n`` rows, on every rank."""
        if not self._on_mesh():
            return t
        return gather_rows(t, self._mesh, n, "use_mesh")

    def use_mesh(self, mesh=None, cfg=None) -> "TTSPipeline":
        """Synthesis over a ``(data, model)`` mesh of processes
        (``parallel/mesh.py``; default: every rank of the process group on
        the data axis, each on this pipeline's device).

        Every rank calls the same entry points with the same texts. A
        request pads to a multiple of the data axis with copies of its last
        row, each data coordinate runs its rows, and the rows are gathered
        back, so every rank returns the whole result with the pad rows
        dropped. The prior noise is the whole request's draw, each data
        coordinate keeping its rows, and the host's choices (frame buckets,
        the overflow redo) are taken on global values: the result is the
        one-device result up to the per-shape choices of convolution
        algorithms. The parameters are replicated from world rank 0; a
        model axis wider than one rank then shards them by JAX's rule
        (``parallel.sharding.tp_param_sharding``): the ranks of one model
        group run the same rows, each computing its slice of every wide
        layer's output channels. The model is copied before it is sharded,
        so a pipeline that shared it keeps the whole one. A one-rank mesh
        changes nothing."""
        import copy

        from iris_tts_tpu_torch.config import MeshConfig
        from iris_tts_tpu_torch.parallel.mesh import build_mesh, world_size
        from iris_tts_tpu_torch.parallel.sharding import tp_param_sharding

        cfg = cfg or MeshConfig()
        if mesh is None:
            mesh = build_mesh(cfg, [self.device] * world_size())
        missing = {cfg.data_axis, cfg.model_axis} - set(mesh.axis_names)
        if missing:
            raise ValueError(
                f"mesh axes {mesh.axis_names} lack {sorted(missing)}; pass "
                "a MeshConfig whose data_axis/model_axis match the mesh")
        if mesh.model_size > 1:
            self.model = copy.deepcopy(self.model)
        tp_param_sharding(self.model, mesh, cfg)
        self.device = mesh.device
        self._mesh = mesh
        return self

    def _stage_a_device(self, ids_np: np.ndarray, lengths_np: np.ndarray):
        """Stage A on this rank's rows of a padded id batch → (enc, frames,
        the request's largest predicted total as a 0-d device tensor: the
        maximum over the ranks on a mesh)."""
        with prof.span("stage_a"):
            ids, lengths = self._rows_to_device(ids_np, lengths_np)
            enc, frames, total = stage_a(self.model, ids, lengths)
            total = all_reduce_(total.reshape(1), self._mesh, "frame_bucket",
                                op="max")
            return enc, frames, total[0]

    def _run_stage_a(self, texts: Sequence[str]):
        """Host frontend + stage A + frame-bucket choice (one scalar
        comes back to the host)."""
        enc, frames, total_t = self._stage_a_device(
            *self._encode_texts(texts))
        return enc, frames, self._frame_bucket(int(total_t))

    def _frame_bucket(self, total: int) -> int:
        """The frame bucket of a batch whose longest row has ``total``
        predicted frames (warns when even the largest bucket truncates)."""
        factor = self.config.vae.down_factor
        t_bucket = pick_bucket(
            round_up_to_multiple(max(total, factor), factor),
            self.frame_buckets)
        if total > t_bucket:
            logger.warning(
                "predicted %d frames exceed the largest frame bucket (%d); "
                "the audio tail will be truncated", total, t_bucket)
        return t_bucket

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

    def _fused_device(self, ids_np: np.ndarray, lengths_np: np.ndarray,
                      t_bucket: int, seed_int: int, temperature: float,
                      pcm16: bool, return_mel: bool = False):
        """:func:`fused_synthesis` on the device for a padded id batch,
        with the prior noise of ``seed_int`` at the ``t_bucket`` budget.
        Returns the handle and the per-row overflow deficit (device
        tensors)."""
        n = len(ids_np)
        ids, lengths = self._rows_to_device(ids_np, lengths_np)
        eps = self._prior_noise(n, t_bucket, seed_int)
        audio, mel, n_frames, deficit = fused_synthesis(
            self.model, ids, lengths, eps, temperature, t_bucket,
            self.use_postnet, self.upsample)
        g = self._gather
        return _Dispatch(g(self._maybe_pcm16(audio, pcm16), n),
                         g(n_frames, n), g(mel, n) if return_mel else None,
                         n, pcm16), g(deficit, n)

    def _fused_dispatch(self, texts: Sequence[str], seed_int: int,
                        temperature: float, pcm16: bool,
                        return_mel: bool = False):
        """Host frontend + frame budget + :meth:`_fused_device` → (handle,
        deficit, frame bucket). Nothing waits for the device."""
        ids_np, lengths_np = self._encode_texts(texts)
        t_bucket = self._fused_frame_budget(lengths_np)
        disp, deficit = self._fused_device(ids_np, lengths_np, t_bucket,
                                           seed_int, temperature, pcm16,
                                           return_mel)
        return disp, deficit, t_bucket

    @torch.inference_mode()
    def _batched_dispatch(
        self,
        texts: Sequence[str],
        seed: Optional[int] = None,
        temperature: float = 1.0,
        pcm16: bool = False,
        return_mel: bool = False,
    ) -> _Dispatch:
        """The two-stage batched path without the copy to the host: returns
        a handle for :meth:`_batched_collect`. The serving batcher
        dispatches slice N+1 before it collects slice N;
        ``synthesize(fused=False)`` is dispatch and collect back to back.

        Stage A's predicted frame total is read on the host to pick the
        frame bucket, which waits for the work queued before it on the
        stream; stage B is then queued and not waited for."""
        enc, frames, t_bucket = self._run_stage_a(texts)
        return self._stage_b(enc, frames, t_bucket, self._next_seed(seed),
                             temperature, pcm16, len(texts), return_mel)

    def _fetch_rows(self, disp: _Dispatch):
        """One device→host copy of the batch, trimmed to each row's frame
        count × hop → (waveforms, mels or None)."""
        with prof.span("collect"):
            hop = self.config.hifigan.total_upsample
            n_np = disp.n_frames.cpu().numpy().astype(np.int64)
            audio_np = to_host(disp.audio)
            outs = [a[: int(k) * hop]
                    for a, k in zip(audio_np[:disp.n], n_np)]
            mels = None
            if disp.mel is not None:
                mel_np = to_host(disp.mel)
                mels = [m[: int(k)] for m, k in zip(mel_np[:disp.n], n_np)]
            return outs, mels

    def _batched_collect(self, disp: _Dispatch) -> List[np.ndarray]:
        """Copy a :meth:`_batched_dispatch` handle to the host and trim →
        list of 1-D waveforms (row order preserved)."""
        return self._fetch_rows(disp)[0]

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
            disp, deficit, t_bucket = self._fused_dispatch(
                texts, seed_int, temperature, pcm16, return_mel)
        else:
            disp = self._batched_dispatch(texts, seed_int, temperature,
                                          pcm16, return_mel)
        outs, mels = self._fetch_rows(disp)

        if fused:
            deficit_np = deficit.cpu().numpy()
            self._count_overflows(deficit_np)
            redo = self._overflow_fallback_rows(deficit_np, t_bucket)
            if redo:
                logger.info("re-synthesizing %d over-compressed row(s) on "
                            "the two-stage path", len(redo))
                r_outs, r_mels = self._fetch_rows(self._batched_dispatch(
                    [texts[i] for i in redo], seed_int, temperature, pcm16,
                    return_mel))
                for j, i in enumerate(redo):
                    outs[i] = r_outs[j]
                    if mels is not None:
                        mels[i] = r_mels[j]
        if return_mel:
            return (outs[0], mels[0]) if single else (outs, mels)
        return outs[0] if single else outs

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
        n = len(texts)
        mel, n_frames = self._acoustic(enc, frames, self._next_seed(seed),
                                       t_bucket, temperature, n)
        n_np = self._gather(n_frames, n).cpu().numpy().astype(np.int64)
        mel_np = to_host(self._gather(mel, n))
        outs = [m[: int(k)] for m, k in zip(mel_np, n_np)]
        return outs[0] if single else outs

    def _mel_tensor(self, mel) -> torch.Tensor:
        """numpy or tensor mel → float32 tensor on the device."""
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.asarray(mel, np.float32))
        return mel.to(self.device, torch.float32)

    @torch.inference_mode()
    def vocode(self, mel) -> np.ndarray:
        """Log-mel → waveform (numpy f32). Accepts time-major [T, n_mels]
        / [B, T, n_mels] or reference layout [n_mels, T] / [B, n_mels, T],
        as numpy or as a tensor of any float dtype (cast to f32, then to
        the compute dtype at the vocoder's first layer); a tensor already on
        the device stays there."""
        mel = self._mel_tensor(mel)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        mel = mel_time_major(mel, self.config.hifigan.in_channels)
        audio = to_host(self._vocode_device(mel.contiguous()))
        return audio[0] if squeeze else audio

    @torch.inference_mode()
    def vocode_streaming(
        self,
        mel,
        chunk_frames: int = 256,
        context_frames: Optional[int] = None,
        pcm16: bool = False,
    ):
        """Log-mel → waveform as a stream of chunks, O(chunk) device memory.

        Yields ``chunk_frames × hop`` samples at a time (the last chunk
        shorter). Each chunk is vocoded from a window carrying
        ``context_frames`` of real context per side (default: the
        generator's receptive-field radius, :func:`receptive_radius_frames`),
        and windows touching the true mel boundaries align to them so the
        layer zero-padding matches the full pass. The network is fully
        convolutional, so the concatenation equals :meth:`vocode` of the
        whole mel up to float rounding: cuDNN on the card (oneDNN on the
        CPU) may choose other convolution algorithms for the window shape
        than for the full shape. Every window has one shape.

        Takes one mel, time-major ``[T, n_mels]`` or reference layout
        ``[n_mels, T]``, numpy or tensor; yields nothing for ``T == 0``.
        ``pcm16`` quantizes on the device and halves the copy to the host,
        as in :meth:`synthesize`.
        """
        mel = self._mel_tensor(mel)
        if mel.ndim != 2:
            raise ValueError("vocode_streaming takes one [T, n_mels] mel")
        mel = mel_time_major(mel, self.config.hifigan.in_channels)
        t = mel.shape[0]
        if t == 0:
            return
        up = self.config.hifigan.total_upsample
        if context_frames is None:
            context_frames = receptive_radius_frames(self.config.hifigan)
        window = chunk_frames + 2 * context_frames
        if t <= window:
            # Too short to split: one exact whole-mel call.
            audio = self.vocode(mel)
            yield host_pcm16(audio) if pcm16 else audio
            return
        mel = mel.contiguous()
        chunk_samples = chunk_frames * up
        for a, b, w0, start_f, start_cl_f in iter_stream_windows(
                t, chunk_frames, context_frames):
            block = self._vocode_window(mel[None, w0:w0 + window],
                                        start_cl_f * up, chunk_samples,
                                        pcm16)
            block_np = to_host(block)[0]
            off = (start_f - start_cl_f) * up
            yield block_np[off:off + (b - a) * up]

    @torch.inference_mode()
    def vocode_sharded(
        self,
        mel,
        mesh=None,
        chunk_frames: Optional[int] = None,
        context_frames: Optional[int] = None,
        pcm16: bool = False,
        chunk_multiple: int = 32,
    ) -> np.ndarray:
        """Log-mel → waveform, the time axis split over the ranks of a mesh
        (default: the one :meth:`use_mesh` installed).

        Sequence parallelism for one long utterance: every rank passes the
        same mel, which is cut into one receptive-field-overlap window per
        rank of the whole mesh, both axes (the exact-streaming plan of
        :meth:`vocode_streaming` with a chunk of ``ceil(T / ranks)``
        rounded up to ``chunk_multiple`` frames); each rank keeps its
        window's chunk (quantized to PCM16 on the device with ``pcm16``),
        and the chunks are gathered to every rank and trimmed. The ranks of
        one model group vocode their windows together as one batch (one
        window at ``model_parallel`` 1), each keeping its own.
        No halo is exchanged: the mel is whole on every rank. With fewer
        windows than ranks the idle ranks redo the last window, and T pads
        to ``chunk · ranks``; the pad is never read. The result equals
        :meth:`vocode` of the whole mel up to the per-shape choice of
        convolution algorithms (a window has another shape than the whole).
        One rank, or a mel no longer than a window, takes :meth:`vocode`
        itself."""
        mesh = mesh if mesh is not None else self._mesh
        mel = self._mel_tensor(mel)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        mel = mel_time_major(mel, self.config.hifigan.in_channels)
        t = mel.shape[1]
        n_dev = 1 if mesh is None else mesh.size
        up = self.config.hifigan.total_upsample
        if context_frames is None:
            context_frames = receptive_radius_frames(self.config.hifigan)
        chunk = chunk_frames or round_up_to_multiple(
            -(-t // n_dev), max(1, chunk_multiple))
        window = chunk + 2 * context_frames
        if n_dev == 1 or t <= window:
            audio = self.vocode(mel[0] if squeeze else mel)
            return host_pcm16(audio) if pcm16 else audio
        plan = list(iter_stream_windows(t, chunk, context_frames))
        if len(plan) > n_dev:
            raise ValueError(
                f"chunk_frames={chunk} yields {len(plan)} windows for "
                f"{n_dev} ranks; use chunk_frames >= ceil(T/ranks)")
        padded = plan + [plan[-1]] * (n_dev - len(plan))
        t_pad = chunk * n_dev
        mel = torch.nn.functional.pad(mel.contiguous(), (0, 0, 0, t_pad - t))
        b = mel.shape[0]
        chunk_samples = chunk * up
        # this model group's lanes as one batch; this rank keeps its own
        mp = mesh.model_size
        lanes = padded[mesh.rank * mp:(mesh.rank + 1) * mp]
        audio = self._vocode_device(torch.cat(
            [mel[:, w0:w0 + window] for _, _, w0, _, _ in lanes]))
        start = lanes[mesh.model_rank][4] * up
        block = self._maybe_pcm16(
            audio[mesh.model_rank * b:(mesh.model_rank + 1) * b,
                  start:start + chunk_samples], pcm16)
        buf, _ = reduce_rows(block[None], (n_dev, b, chunk_samples),
                             block.dtype, block.device, mesh.world_rank,
                             mesh.world_group, mesh.backend,
                             "vocode_sharded")
        out = to_host(unwiden(buf, block.dtype))  # [ranks, B, chunk·hop]
        pieces = []
        for i, (a, b_, _w0, start_f, start_cl) in enumerate(plan):
            off = (start_f - start_cl) * up
            pieces.append(out[i][:, off:off + (b_ - a) * up])
        audio = np.concatenate(pieces, axis=1)
        return audio[0] if squeeze else audio

    # ------------------------------------------------------------------
    # long text
    # ------------------------------------------------------------------

    def _chunk_long_text(self, text: str, max_phonemes: int) -> list:
        """Sentence-pack ``text`` into chunks of at most ``max_phonemes``
        ids (``text/frontend.py:chunk_text_by_phonemes``)."""
        return chunk_text_by_phonemes(self.text_processor, self.vocab, text,
                                      max_phonemes)

    def synthesize_long(
        self,
        text: str,
        seed: Optional[int] = None,
        temperature: float = 1.0,
        gap_ms: float = 120.0,
        max_phonemes: Optional[int] = None,
    ) -> np.ndarray:
        """Long text → one waveform, without bucket truncation.

        ``synthesize`` truncates input past the largest phoneme bucket
        (with a warning); this splits the text at sentence boundaries (word
        boundaries as a last resort), synthesizes the chunks as one
        two-stage batch and joins them with ``gap_ms`` of silence. One
        chunk takes :meth:`synthesize` unchanged."""
        if max_phonemes is None:
            max_phonemes = self.phoneme_buckets[-1]
        chunks = self._chunk_long_text(text, max_phonemes)
        if not chunks:
            return np.zeros(0, np.float32)
        if len(chunks) == 1:
            return self.synthesize(chunks[0], seed=seed,
                                   temperature=temperature)
        outs = self.synthesize(chunks, seed=seed, temperature=temperature,
                               fused=False)
        return self.join_chunks(outs, gap_ms=gap_ms)

    def join_chunks(self, outs: Sequence[np.ndarray],
                    gap_ms: float = 120.0) -> np.ndarray:
        """Concatenate chunk waveforms with ``gap_ms`` of silence between
        them (``data.audio_io.join_wave_chunks``, shared with the serving
        batcher)."""
        return join_wave_chunks(outs, gap_ms, self.config.audio.sample_rate)

    @torch.inference_mode()
    def stream(
        self,
        text: str,
        seed: Optional[int] = None,
        temperature: float = 1.0,
        gap_ms: float = 120.0,
        max_phonemes: Optional[int] = None,
        pcm16: bool = False,
        vocode_chunk_frames: Optional[int] = None,
    ):
        """Incremental synthesis: yields waveform pieces (sentence chunks
        interleaved with ``gap_ms`` of silence) as they are computed.

        The library twin of the HTTP ``/synthesize_stream`` endpoint
        (``serve/server.py``). Chunk i gets seed ``seed + i`` on the fused
        path, so each chunk is reproducible alone. The first chunk is
        collected before anything else is dispatched, so time to first
        audio is one chunk's; from the second chunk on, chunk i+1 is
        dispatched before chunk i is copied to the host. A lookahead that
        fails still yields the chunk already computed, then raises.

        ``vocode_chunk_frames`` streams within each sentence too: the
        acoustic model makes the sentence's mel, then audio flows in
        pieces of that many frames through :meth:`vocode_streaming`.
        """
        if max_phonemes is None:
            max_phonemes = self.phoneme_buckets[-1]
        chunks = self._chunk_long_text(text, max_phonemes)
        if not chunks:
            return
        base = None if seed is None else int(seed)
        gap = np.zeros(
            int(round(gap_ms / 1000.0 * self.config.audio.sample_rate)),
            np.int16 if pcm16 else np.float32)

        def chunk_seed(i):
            return self._next_seed(None if base is None else base + i)

        if vocode_chunk_frames is not None:
            for i, chunk in enumerate(chunks):
                if i:
                    yield gap
                mel = self.synthesize_mel(chunk, seed=chunk_seed(i),
                                          temperature=temperature)
                yield from self.vocode_streaming(
                    mel, chunk_frames=vocode_chunk_frames, pcm16=pcm16)
            return

        def dispatch(i):
            disp, deficit, _ = self._fused_dispatch(
                [chunks[i]], chunk_seed(i), temperature, pcm16)
            return disp, deficit

        def collect(handle):
            disp, deficit = handle
            outs, _ = self._fetch_rows(disp)
            self._count_overflows(deficit.cpu().numpy())
            return outs[0]

        yield collect(dispatch(0))  # time to first audio: chunk 0 alone
        pending = None
        err = None
        for i in range(1, len(chunks)):
            try:
                nxt = dispatch(i)
            except Exception as e:  # noqa: BLE001 — flush finished audio
                err = e
                break
            if pending is not None:
                yield gap
                yield collect(pending)
            pending = nxt
        if pending is not None:
            yield gap
            yield collect(pending)
        if err is not None:
            raise err

    def synthesize_to_file(self, text: str, path: Union[str, Path],
                           seed: Optional[int] = None) -> np.ndarray:
        """:meth:`synthesize_long` written to a PCM16 WAV at ``path``."""
        audio = self.synthesize_long(text, seed=seed)
        write_wav(path, audio, self.config.audio.sample_rate)
        return audio

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def fused_bucket_pairs(self, max_phonemes: Optional[int] = None) -> list:
        """Every (phoneme-bucket, frame-bucket) pair the fused path can
        resolve to for utterances of up to ``max_phonemes`` ids, found by
        walking every length through :meth:`_fused_frame_budget`."""
        max_p = max_phonemes or self.phoneme_buckets[-1]
        pairs = set()
        for length in range(1, max_p + 1):
            p_bucket = pick_bucket(length, self.phoneme_buckets)
            t_bucket = self._fused_frame_budget(np.asarray([length]))
            pairs.add((p_bucket, t_bucket))
        return sorted(pairs)

    @torch.inference_mode()
    def warmup_fused(
        self,
        max_phonemes: Optional[int] = None,
        pcm16: bool = False,
        temperature: float = 1.0,
        batch_sizes: Sequence[int] = (1,),
    ) -> int:
        """Run every fused-path shape once, at the given batch sizes, before
        traffic. Returns the number of shapes run.

        There is no compile step here as there is in the JAX package. What
        a first call of a new shape pays on the card is cuDNN's choice and
        set-up of each convolution's execution plan for that shape, and the
        caching allocator growing to the shape's working set; running each
        (batch, phoneme-bucket, frame-bucket) shape once on synthetic ids
        moves both out of the first live request of that shape. PyTorch
        keeps those plans per thread, so run the warmup on the thread that
        will serve (``DynamicBatcher.start`` does). (TF32 and
        ``cudnn.benchmark`` stay off: ``runtime.pin_math_precision``.)

        ``batch_sizes`` defaults to ``(1,)``: the serving batcher sends only
        single-utterance groups down the fused path."""
        pairs = self.fused_bucket_pairs(max_phonemes)
        for b in batch_sizes:
            for p_bucket, t_bucket in pairs:
                ids_np = np.full((b, p_bucket), self.vocab.pad_id, np.int64)
                lengths_np = np.full((b,), p_bucket, np.int64)
                self._fused_device(ids_np, lengths_np, t_bucket,
                                   self._next_seed(0), temperature, pcm16)
                self._sync()
        return len(pairs) * len(batch_sizes)

    @torch.inference_mode()
    def warmup_batched(
        self,
        batch_sizes: Sequence[int],
        pcm16: bool = False,
        temperature: float = 1.0,
        max_frames_per_phoneme: int = 24,
    ) -> int:
        """Run the two-stage path's shapes once before traffic (what that
        does on the card: :meth:`warmup_fused`). Returns the count.

        Stage A runs at every (batch, phoneme-bucket); stage B at every
        (batch, phoneme-bucket, frame-bucket) whose frame bucket is
        plausibly reachable, T ≤ P × ``max_frames_per_phoneme``. The
        smallest frame bucket is always reachable (short predictions clamp
        up to it), so it is never skipped."""
        n = 0
        for b in batch_sizes:
            stage_a_out = {}
            for p_bucket in self.phoneme_buckets:
                ids_np = np.full((b, p_bucket), self.vocab.pad_id, np.int64)
                lengths_np = np.full((b,), p_bucket, np.int64)
                enc, frames, _ = self._stage_a_device(ids_np, lengths_np)
                stage_a_out[p_bucket] = (enc, frames)
                n += 1
            for p_bucket, (enc, frames) in stage_a_out.items():
                for i, t_bucket in enumerate(self.frame_buckets):
                    if i and t_bucket > p_bucket * max_frames_per_phoneme:
                        break
                    self._stage_b(enc, frames, t_bucket, self._next_seed(0),
                                  temperature, pcm16, b)
                    self._sync()
                    n += 1
        return n
