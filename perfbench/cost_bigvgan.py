"""Operations and bytes of a configuration whose vocoder is BigVGAN-v2.

:class:`BigVGANFlopModel` is ``cost.FlopModel`` with the vocoder's FLOPs
counted by ``FlopCounterMode`` over the plain BigVGAN reference
(``reference/bigvgan.py``) on the ``meta`` device; the acoustic stages are
counted over ``reference/model.py``'s modules as before. Convolution FLOPs,
two a multiply-add, the anti-aliasing filters' depthwise convolutions
among them; elementwise work (SnakeBeta) is not counted.

:func:`activation_shapes` lists the ``[B, C, T]`` of every anti-aliased
activation of a vocoder call, from the configuration; :func:`amp_cost`
gives one activation's work as the port's operator registers it: the FIR
multiply-adds, ``48 · B · C · T`` FLOPs, and ``4 · (2 · B · C · T + 2 ·
C)`` bytes (the input read and the output written once, α and β).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Tuple

import torch

from perfbench.cost import FlopModel, _count
from perfbench.reference.bigvgan import BigVGAN


class BigVGANFlopModel(FlopModel):
    """FLOPs of the synthesis stages with BigVGAN as the vocoder."""

    def __init__(self, model_cfg: Dict[str, Any]):
        with torch.device("meta"):
            self.bigvgan = BigVGAN(model_cfg["hifigan"])
        super().__init__(model_cfg)

    @lru_cache(maxsize=None)
    def vocoder(self, b: int, t: int) -> int:
        mel = torch.zeros(b, t, self.n_mels, device="meta")
        return _count(self.bigvgan, mel)


def activation_shapes(hifigan_cfg: Dict[str, Any], b: int,
                      t: int) -> List[Tuple[int, int, int]]:
    """[B, C, T] of each anti-aliased activation of a call on ``b`` rows
    of ``t`` frames: two a resblock layer, in every resblock of every
    stage, and ``activation_post``."""
    c, rate, out = hifigan_cfg["upsample_initial_channel"], t, []
    per_stage = sum(2 * len(d) for d in hifigan_cfg["resblock_dilations"])
    for u in hifigan_cfg["upsample_rates"]:
        c, rate = c // 2, rate * u
        out += [(b, c, rate)] * per_stage
    return out + [(b, c, rate)]


def amp_cost(shape: Tuple[int, int, int]) -> Tuple[int, int]:
    """(FLOPs, bytes) of one activation on ``shape`` [B, C, T], float32."""
    b, c, t = shape
    return 48 * b * c * t, 4 * (2 * b * c * t + 2 * c)


def flop_model(ctx) -> BigVGANFlopModel:
    """The run's configuration's FLOP model, built once a run."""
    return ctx.memo("bigvgan_flop_model", lambda: BigVGANFlopModel(
        ctx.parts["config"]["model"]))


def vocoder_params(ctx) -> int:
    return ctx.memo("bigvgan_params", lambda: sum(
        p.numel() for p in flop_model(ctx).bigvgan.parameters()))
