"""Read NVIDIA's BigVGAN checkpoints into the port's generator.

A published BigVGAN generator (``bigvgan_generator.pt``: ``{"generator":
state_dict}``) holds each conv under weight norm, as ``weight_g`` /
``weight_v`` (``torch.nn.utils.weight_norm``) or
``parametrizations.weight.original0`` / ``original1`` (its parametrization
form), and each activation's anti-aliasing filters as buffers
(``...upsample.filter``, ``...downsample.lowpass.filter``).
:func:`fold_bigvgan_state_dict` folds each weight, ``g · v / ‖v‖`` with
the norm over every dim but the first (``weight_norm``'s ``dim=0``),
checks every filter against the formula
(``ops.amp_cuda.kaiser_sinc_filter``) and drops it, and returns the state
dict of :class:`~iris_tts_tpu_torch.models.bigvgan.BigVGANGenerator`, whose
module names are NVIDIA's. :func:`load_bigvgan` reads a file and checks
the result against a generator built from the config. Hand it to
``TTSPipeline.from_jax_params(..., vocoder_state_dict=...)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import torch

from iris_tts_tpu_torch.config import HiFiGANConfig
from iris_tts_tpu_torch.ops.amp_cuda import kaiser_sinc_filter

_PAIRS = (("weight_g", "weight_v"),
          ("parametrizations.weight.original0",
           "parametrizations.weight.original1"))
_FILTERS = (".upsample.filter", ".downsample.lowpass.filter")
# A stored filter may have been computed on other hardware than this one.
FILTER_TOL = 1e-6


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``weight_norm``'s weight at ``dim=0``: ``v · g / ‖v‖``, the norm
    taken per index of the first dim."""
    norm = v.norm(dim=tuple(range(1, v.ndim)), keepdim=True)
    return v * (g / norm)


def fold_bigvgan_state_dict(sd: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A BigVGAN generator state dict with weight norm and filter buffers →
    the port's, in float32. Raises on a filter that is not the formula's."""
    want = kaiser_sinc_filter()
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.endswith(_FILTERS):
            got = value.detach().float().cpu().reshape(-1)
            if got.shape != want.shape or not torch.allclose(
                    got, want, rtol=0.0, atol=FILTER_TOL):
                raise ValueError(f"{key}: not the 12-tap Kaiser sinc filter "
                                 "that BigVGAN's formula gives")
            continue
        for g_name, v_name in _PAIRS:
            if key.endswith("." + g_name):
                base = key[:-len(g_name)]
                out[base + "weight"] = fold_weight_norm(
                    value.float(), sd[base + v_name].float())
                break
            if key.endswith("." + v_name):
                break
        else:
            out[key] = value.float()
    return out


def load_bigvgan(path: Union[str, Path],
                 config: HiFiGANConfig) -> Dict[str, torch.Tensor]:
    """The port's BigVGAN state dict from a checkpoint file (a state dict,
    or a dict holding one under ``"generator"``), checked key by key and
    shape by shape against ``config``'s generator."""
    from iris_tts_tpu_torch.models.bigvgan import BigVGANGenerator

    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = fold_bigvgan_state_dict(raw.get("generator", raw))
    with torch.device("meta"):
        want = BigVGANGenerator(config).state_dict()
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint does not fit the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for k, v in want.items():
        if sd[k].shape != v.shape:
            raise ValueError(f"{k}: checkpoint {tuple(sd[k].shape)}, config "
                             f"{tuple(v.shape)}")
    return sd
