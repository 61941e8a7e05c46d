"""Single configuration tree shared by every stage of the framework.

The port's own copy of the JAX package's ``config.py``: the same dataclasses,
the same defaults (the full-width model) and the same JSON round-trip, so a
config file written by either package loads in the other.

The reference scatters hyperparameters across per-script argparse defaults that
drift out of sync (reference scripts/train_vae.py:118 vs :525 and
scripts/synthesize.py:124-135 — SURVEY.md §5 "Config / flag system").  Here a
single dataclass tree is the source of truth.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Audio / mel-spectrogram contract.

    Mirrors the reference mel convention exactly (magnitude spectrogram,
    power=1.0, log with clip at 1e-5): reference src/iris/data.py:25-67.
    HiFiGAN's upsampling factor (8*8*2*2 = 256) must equal ``hop_length``.
    """

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    # log(clip(mel, min=log_clip_min)) — data.py:65
    log_clip_min: float = 1e-5
    # STFT centering pad mode. The reference pins librosa>=0.10
    # (pyproject.toml), whose stft default is zero padding ("constant") —
    # that is the contract its features (and mel caches) were built with.
    pad_mode: str = "constant"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer phoneme encoder (reference: src/iris/encoder.py:115-225)."""

    vocab_size: int = 72
    embed_dim: int = 256
    num_blocks: int = 4
    num_heads: int = 4
    ffn_dim: int = 0  # 0 → 4 * embed_dim (encoder.py:152)
    max_length: int = 1000
    dropout: float = 0.1

    @property
    def ffn_hidden(self) -> int:
        return self.ffn_dim if self.ffn_dim > 0 else 4 * self.embed_dim


@dataclass(frozen=True)
class DurationConfig:
    """Conv duration predictor head (reference: src/iris/encoder.py:228-325)."""

    hidden_dim: int = 256
    num_layers: int = 2
    kernel_size: int = 3
    dropout: float = 0.1


@dataclass(frozen=True)
class VAEConfig:
    """PortaSpeech-style text-conditioned VAE (reference: src/iris/vae.py:255-
    347, production values from scripts/synthesize.py:124-135)."""

    n_mels: int = 80
    cond_dim: int = 256
    model_channels: int = 192
    latent_dim: int = 16
    num_wavenet_blocks: int = 8
    decoder_blocks: int = 4
    wavenet_kernel_size: int = 5
    down_stages: int = 2
    flow_layers: int = 4
    flow_hidden: int = 64
    dropout: float = 0.1
    # Train the VP flow as the LATENT PRIOR (the PortaSpeech recipe):
    # the decoder consumes the posterior sample z directly, and the flow
    # learns flow(z) ~ N(0,I) via its NLL inside the KL term — making the
    # training decode input and the generation decode input
    # (flow⁻¹(N(0,I))) the SAME space. False = the reference's exact
    # composition (decode(flow(z)) in training, decode(flow⁻¹(z')) at
    # generation — vae.py:401,466), kept for converted-checkpoint parity;
    # it only coheres when the KL actually pins q(z|x) ≈ N(0,I) AND the
    # flow stays near identity, which the reference's kl_weight=0.01
    # never achieves (measured round 4: prior-generation MCD no better
    # than a shuffled control while posterior recon was 12 dB).
    flow_prior: bool = False

    @property
    def down_factor(self) -> int:
        return 2**self.down_stages


@dataclass(frozen=True)
class PostNetConfig:
    """Tacotron2-style PostNet (reference: src/iris/postnet.py:8-67; inference
    architecture from scripts/synthesize.py:152-158)."""

    n_mels: int = 80
    num_layers: int = 3
    channels: int = 256
    kernel_size: int = 5
    dropout: float = 0.3


@dataclass(frozen=True)
class HiFiGANConfig:
    """Vocoder topology: HiFiGAN's generator (reference:
    src/iris/hifigan_pretrained.py:74-121 — torch padding semantics, and
    src/iris/vocoder.py:52-142), or with ``activation="snakebeta"``
    BigVGAN-v2's (NVIDIA/BigVGAN, ``models/bigvgan.py``): the same ladder of
    upsamplers and resblocks, the keys named as in BigVGAN's config files.

    ``activation`` is written to JSON only where it is not the default
    (:data:`_OMIT_AT_DEFAULT`), so a HiFiGAN config serialises as it always
    has and the JAX package, which has no such key, still reads it."""

    in_channels: int = 80
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    # "leaky_relu" (HiFiGAN: conv_post with a bias, tanh) or "snakebeta"
    # (BigVGAN-v2's anti-aliased SnakeBeta AMP blocks, with the source's
    # snake_logscale true, use_tanh_at_final and use_bias_at_final false).
    activation: str = "leaky_relu"

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for data/model parallel execution.

    The reference has no parallelism of any kind (SURVEY.md §2.4); this is new
    functionality. ``data`` shards the batch; ``model`` is a hook
    for sharding wide channel dims (HiFiGAN, FFN) via sharding constraints.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    # 0 → use all available devices on the data axis.
    data_parallel: int = 0
    model_parallel: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Shared optimizer/schedule/checkpoint settings (reference equivalents:
    scripts/train_encoder.py:162-195, train_vae.py:232-265)."""

    batch_size: int = 16
    learning_rate: float = 1e-4
    warmup_epochs: int = 5
    num_epochs: int = 100
    steps_per_epoch: int = 0  # 0 → derived from dataset size
    clip_norm: float = 1.0
    weight_decay: float = 0.0
    # KL annealing for the VAE stage: linear from start to end over
    # anneal_epochs (reference: train_vae.py:232-239).
    kl_weight_start: float = 0.001
    kl_weight_end: float = 0.01
    kl_anneal_epochs: int = 20
    # Huber delta for the duration loss (reference: encoder.py:441).
    duration_huber_delta: float = 10.0
    checkpoint_every_epochs: int = 5
    seed: int = 1337


@dataclass(frozen=True)
class IrisConfig:
    """Top-level configuration for the whole framework."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    duration: DurationConfig = field(default_factory=DurationConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    postnet: PostNetConfig = field(default_factory=PostNetConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------


# Fields left out of the JSON while they hold their defaults.
_OMIT_AT_DEFAULT = {
    "HiFiGANConfig": ("activation",),
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        omit = _OMIT_AT_DEFAULT.get(type(obj).__name__, ())
        return {
            f.name: _to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not (f.name in omit and getattr(obj, f.name) == f.default)
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_jsonable(cls: type, data: Any, path: str = "") -> Any:
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            raise ValueError(
                f"config{path or ' root'}: expected an object for "
                f"{cls.__name__}, got {type(data).__name__}"
            )
        names = {f.name for f in dataclasses.fields(cls)}
        # A typo'd key silently training the DEFAULT architecture is the
        # reference's config-drift bug class (SURVEY §2.6) — reject it.
        unknown = set(data) - names
        if unknown:
            raise ValueError(
                f"config{path or ' root'}: unknown field(s) "
                f"{sorted(unknown)} for {cls.__name__} "
                f"(valid: {sorted(names)})"
            )
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            kwargs[f.name] = _coerce_field(
                f.type, data[f.name], f"{path}.{f.name}"
            )
        return cls(**kwargs)
    return data


def _coerce_field(ftype: Any, value: Any, path: str = "") -> Any:
    # Resolve string annotations from `from __future__ import annotations`.
    if isinstance(ftype, str):
        ftype = _TYPE_REGISTRY.get(ftype, ftype)
    if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
        return _from_jsonable(ftype, value, path)
    if isinstance(value, list):
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    # Scalar type check: a string where an int/float belongs would only
    # blow up deep inside tracing, far from the config that caused it.
    if ftype in (int, "int") and not isinstance(value, int):
        raise ValueError(f"config{path}: expected int, got {value!r}")
    if ftype in (float, "float") and not isinstance(value, (int, float)):
        raise ValueError(f"config{path}: expected number, got {value!r}")
    if ftype in (bool, "bool") and not isinstance(value, bool):
        raise ValueError(f"config{path}: expected bool, got {value!r}")
    return value


def config_to_json(cfg: Any, indent: int = 2) -> str:
    return json.dumps(_to_jsonable(cfg), indent=indent)


def config_from_json(text: str, cls: type = IrisConfig) -> Any:
    return _from_jsonable(cls, json.loads(text))


def save_config(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(config_to_json(cfg))


def load_config(path: str | Path, cls: type = IrisConfig) -> Any:
    return config_from_json(Path(path).read_text(), cls)


_TYPE_REGISTRY = {
    c.__name__: c
    for c in (
        AudioConfig,
        EncoderConfig,
        DurationConfig,
        VAEConfig,
        PostNetConfig,
        HiFiGANConfig,
        MeshConfig,
        TrainConfig,
        IrisConfig,
    )
}
