"""Torch HiFiGAN checkpoint → the port's generator (weight-norm folding).

The port's counterpart of the JAX package's ``convert/hifigan_torch.py``.
A pretrained torch generator (the speechbrain ``tts-hifigan-ljspeech``
``generator.ckpt``, or any checkpoint in the published HiFi-GAN layout) is
converted once into the state dict of
:class:`~iris_tts_tpu_torch.models.hifigan.HiFiGANGenerator`:

1. **weight-norm folding**: ``w = v · g / ‖v‖``, the norm over every dim
   but 0 (for a ConvTranspose that is ``C_in``), in float64, then float32;
2. **layout**: none to change. The port's modules hold torch's own
   layouts, Conv1d ``[C_out, C_in, K]`` and ConvTranspose1d ``[C_in,
   C_out, K]`` in true-convolution orientation (not flipped);
3. **keys**: ``ups.{i}`` → ``ups_{i}``, ``resblocks.{n}.convs1.{c}`` →
   ``resblocks_{n}.convs1_{c}``, after :func:`normalize_state_dict_keys`
   strips the ``module.`` / ``generator.`` prefixes and speechbrain's
   ``.conv.`` level.

Weights may come as ``weight_g``/``weight_v``, as the newer
``parametrizations.weight.original0/1``, or already folded as ``weight``;
tensors may be torch tensors or numpy arrays.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.runtime import DeviceLike, DtypeLike


def _to_numpy(t: Any) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _fold_weight(sd: Mapping[str, Any], prefix: str) -> np.ndarray:
    """The effective weight of ``prefix`` with weight-norm folded:
    ``w = g · v / ‖v‖`` (norm over every dim but 0), float64."""
    if f"{prefix}.weight_v" in sd:
        v = _to_numpy(sd[f"{prefix}.weight_v"]).astype(np.float64)
        g = _to_numpy(sd[f"{prefix}.weight_g"]).astype(np.float64)
    elif f"{prefix}.parametrizations.weight.original1" in sd:
        v = _to_numpy(
            sd[f"{prefix}.parametrizations.weight.original1"]
        ).astype(np.float64)
        g = _to_numpy(
            sd[f"{prefix}.parametrizations.weight.original0"]
        ).astype(np.float64)
    elif f"{prefix}.weight" in sd:
        return _to_numpy(sd[f"{prefix}.weight"]).astype(np.float64)
    else:
        raise KeyError(f"no weight found for '{prefix}'")
    norm = np.sqrt(
        np.sum(v**2, axis=tuple(range(1, v.ndim)), keepdims=True)
    )
    return v * (g / norm)


def _layer(sd: Mapping[str, Any], prefix: str, name: str,
           out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(_fold_weight(sd, prefix), np.float32))
    out[f"{name}.bias"] = torch.from_numpy(
        np.ascontiguousarray(_to_numpy(sd[f"{prefix}.bias"]), np.float32))


def normalize_state_dict_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Canonicalize generator state-dict key layouts to the published
    naming (``conv_pre.*``, ``ups.{i}.*``, ``resblocks.{n}.convs{1,2}.{j}.*``,
    ``conv_post.*``):

    * a ``module.`` prefix (torch DataParallel), stripped when every key
      has it,
    * a ``generator.`` prefix (combined GAN checkpoints with flat keys),
      stripped when every key has it,
    * a ``.conv.`` wrapper level: speechbrain's ``nnet.CNN`` modules hold
      the torch conv as ``self.conv``, so the real ``generator.ckpt``
      nests every parameter one level deeper than the published module.
    """
    keys = list(sd.keys())
    for prefix in ("module.", "generator."):
        if keys and all(k.startswith(prefix) for k in keys):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
            keys = list(sd.keys())
    return {k.replace(".conv.", "."): v for k, v in sd.items()}


def convert_hifigan_state_dict(
    state_dict: Mapping[str, Any],
    config: HiFiGANConfig = HiFiGANConfig(),
) -> Dict[str, torch.Tensor]:
    """Torch generator state dict → the port's ``HiFiGANGenerator`` state
    dict (float32 CPU tensors). Speechbrain / DataParallel / flat-GAN
    layouts are canonicalized first (:func:`normalize_state_dict_keys`);
    a missing layer raises ``KeyError``."""
    sd = normalize_state_dict_keys(state_dict)
    out: Dict[str, torch.Tensor] = {}
    _layer(sd, "conv_pre", "conv_pre", out)
    nk = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        _layer(sd, f"ups.{i}", f"ups_{i}", out)
        for j in range(nk):
            n = i * nk + j
            for c in range(len(config.resblock_dilations[j])):
                for side in ("convs1", "convs2"):
                    _layer(sd, f"resblocks.{n}.{side}.{c}",
                           f"resblocks_{n}.{side}_{c}", out)
    _layer(sd, "conv_post", "conv_post", out)
    return out


def load_torch_checkpoint(path: str | Path) -> Mapping[str, Any]:
    """Load a torch checkpoint and unwrap nested state dicts (a module, or
    a dict holding ``generator``, ``model`` or ``state_dict``). Loads with
    ``weights_only=False``, as the JAX package does: a checkpoint may
    pickle its module, so load only files you trust."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(ckpt, "state_dict"):
        return ckpt.state_dict()
    if isinstance(ckpt, dict):
        for key in ("generator", "model", "state_dict"):
            if key in ckpt and isinstance(ckpt[key], dict):
                return ckpt[key]
        return ckpt
    raise ValueError(f"unsupported checkpoint type: {type(ckpt)}")


def load_pretrained_hifigan(
    checkpoint_path: str | Path,
    config: HiFiGANConfig = HiFiGANConfig(),
    dtype: DtypeLike = None,
    device: DeviceLike = None,
):
    """Checkpoint file → ready-to-run
    :class:`~iris_tts_tpu_torch.models.hifigan.HiFiGANVocoder` on
    ``device`` (the CUDA device by default)."""
    from iris_tts_tpu_torch.models.hifigan import HiFiGANVocoder

    sd = load_torch_checkpoint(checkpoint_path)
    params = convert_hifigan_state_dict(sd, config)
    return HiFiGANVocoder(params, config, device, dtype)


# ---------------------------------------------------------------------------
# Singleton convenience API (the JAX package's, with a device)
# ---------------------------------------------------------------------------

_vocoder_instance = None
_vocoder_key = None


def default_checkpoint_path() -> Path:
    """Default pretrained-checkpoint location: ``IRIS_HIFIGAN_CKPT`` when
    set, else ``models/hifigan/generator.ckpt`` relative to the working
    directory (the speechbrain ``tts-hifigan-ljspeech`` generator file)."""
    env = os.environ.get("IRIS_HIFIGAN_CKPT")
    if env:
        return Path(env)
    return Path("models") / "hifigan" / "generator.ckpt"


def get_pretrained_hifigan(
    checkpoint_path: str | Path | None = None, force_reload: bool = False,
    device: DeviceLike = None,
):
    """Lazy singleton vocoder, reloaded when the path or device changes."""
    global _vocoder_instance, _vocoder_key
    path = Path(checkpoint_path or default_checkpoint_path())
    key = (path, str(device))
    if force_reload or _vocoder_instance is None or _vocoder_key != key:
        if not path.exists():
            raise FileNotFoundError(
                f"HiFiGAN checkpoint not found: {path}. Set IRIS_HIFIGAN_CKPT "
                "or pass checkpoint_path."
            )
        _vocoder_instance = load_pretrained_hifigan(path, device=device)
        _vocoder_key = key
    return _vocoder_instance


def infer_hifigan(
    mel: np.ndarray,
    sample_rate: Optional[int] = None,
    hop_length: Optional[int] = None,
    checkpoint_path: str | Path | None = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Mel [n_mels, T] or [B, n_mels, T] → waveform (numpy); a ``[1, ...]``
    batch comes back squeezed. ``sample_rate`` and ``hop_length`` are
    accepted for the reference's signature and not used."""
    del sample_rate, hop_length
    vocoder = get_pretrained_hifigan(checkpoint_path, device=device)
    audio = vocoder(mel).float().cpu().numpy()
    if audio.ndim == 2 and audio.shape[0] == 1:
        audio = audio[0]
    return audio
