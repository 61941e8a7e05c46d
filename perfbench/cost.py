"""Operations counted from shapes, and the card's peaks.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
benchmark's own reference model on the ``meta`` device (no data, no
device): matrix products and convolutions, two FLOPs a multiply-add;
elementwise work is not counted. So no change to the program's kernels
changes the count. Convolution FLOPs grow linearly with the frame count
and the encoder's quadratically with the phoneme count; :class:`FlopModel`
counts each at a few sizes and interpolates exactly.

Peaks are the NVIDIA H100 SXM5 data sheet's dense rates, keyed by the name
``torch.cuda.get_device_name`` gives.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.model import SynthesisModel

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 66.9e12,
                              "bfloat16_flops": 989e12,
                              "hbm_bytes_per_s": 3350e9},
}


def _count(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return int(fc.get_total_flops())


class FlopModel:
    """FLOPs of the synthesis stages of one configuration."""

    def __init__(self, model_cfg: Dict[str, Any]):
        with torch.device("meta"):
            self.model = SynthesisModel(model_cfg)
        self.e = model_cfg["encoder"]["embed_dim"]
        self.n_mels = model_cfg["hifigan"]["in_channels"]
        self.down = 2 ** model_cfg["vae"]["down_stages"]
        self.latent = model_cfg["vae"]["latent_dim"]
        # stage A is quadratic in P, stage B linear in T (per row).
        a = [self.stage_a(1, p) for p in (16, 32, 64)]
        self._a = (a[0], a[1], a[2])
        self._b = (self.acoustic(1, 256) + self.vocoder(1, 256),
                   self.acoustic(1, 512) + self.vocoder(1, 512))

    @lru_cache(maxsize=None)
    def stage_a(self, b: int, p: int) -> int:
        ids = torch.zeros(b, p, dtype=torch.long, device="meta")
        valid = torch.ones(b, p, dtype=torch.bool, device="meta")

        def run(ids, valid):
            self.model.duration(self.model.encoder(ids, valid))

        return _count(run, ids, valid)

    @lru_cache(maxsize=None)
    def acoustic(self, b: int, t: int) -> int:
        """VAE prior path + PostNet at ``b`` rows of ``t`` frames."""
        cond = torch.zeros(b, t, self.e, device="meta")
        z = torch.zeros(b, self.latent, t // self.down, device="meta")
        return _count(lambda c, z: self.model.postnet(
            self.model.vae.generate(c, z)), cond, z)

    @lru_cache(maxsize=None)
    def vocoder(self, b: int, t: int) -> int:
        mel = torch.zeros(b, t, self.n_mels, device="meta")
        return _count(self.model.hifigan, mel)

    def utterance(self, phonemes: int, frames: int) -> float:
        """One utterance at its own phoneme and frame counts."""
        (f16, f32, f64) = self._a
        # quadratic through (16, f16), (32, f32), (64, f64)
        p = float(phonemes)
        l0 = (p - 32) * (p - 64) / ((16 - 32) * (16 - 64))
        l1 = (p - 16) * (p - 64) / ((32 - 16) * (32 - 64))
        l2 = (p - 16) * (p - 32) / ((64 - 16) * (64 - 32))
        a = f16 * l0 + f32 * l1 + f64 * l2
        b256, b512 = self._b
        b = b256 + (b512 - b256) * (frames - 256) / 256.0
        return a + b

