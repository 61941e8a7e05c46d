"""Speed-of-light analysis of the synthesis path on the card.

The port's counterpart of the JAX package's ``scripts/roofline.py``. Each
synthesis stage is run once for real at the given shape (production
config, seeded random weights, zero inputs) while two dispatch modes
count its work:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
  convolutions, two a multiply-add; elementwise work is not counted);
* bytes: the input and output tensor bytes of every aten op of the call
  that moves data (views, detach and the like move none).

and each stage is bounded by ``max(FLOPs / peak, bytes / HBM rate)``, with
the implied maximum realtime factor. The byte count is what an eager run
moves, each op reading its inputs from HBM and writing its outputs there.
It is an upper bound on what a fused program needs: on the full-width
vocoder it reads 8.3% above XLA's fused count of the JAX generator
(``tests/test_torch_analysis.py``). In bf16 the per-op weight casts are
counted, because the port pays for them. The counts come from the aten
ops, not the kernels that run them, so they do not depend on the device:
the MRF kernel's operator (``ops/mrf_cuda.py``) counts as the composition
of convs and elementwise ops it replaces, in both counts.

Peaks default to the NVIDIA H100 SXM5 data sheet (dense, 700 W): 989
TFLOP/s in bf16 on the tensor cores, 66.9 TFLOP/s in f32 on the CUDA cores
(the port runs f32 with TF32 off), 3350 GB/s of HBM3.

Usage:
    python -m iris_tts_tpu_torch.scripts.roofline [--batch 8] \
        [--frames 1024] [--phonemes 256] [--dtype bfloat16|float32] \
        [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models.pipeline import (
    TTSPipeline,
    fused_mel,
    fused_synthesis,
)
from iris_tts_tpu_torch.ops import amp_cuda, mrf_cuda
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg

# NVIDIA H100 SXM5 data sheet, dense: TFLOP/s by compute dtype, HBM GB/s.
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 66.9}
PEAK_HBM_GBPS = 3350.0

STAGES = ("text_to_mel (enc+dur+VAE+PostNet)", "vocoder (HiFiGAN)",
          "fused end-to-end")

aten = torch.ops.aten
# Ops that move no data although their schema is not a view's.
_NO_DATA = {aten._unsafe_view, aten.lift_fresh, aten.empty, aten.empty_like,
            aten.empty_strided, aten.new_empty, aten.new_empty_strided}
# The port's own operators, counted as what they replace.
_OP_BYTES = {torch.ops.iris_tts.mrf_stage: mrf_cuda.mrf_stage_bytes,
             torch.ops.iris_tts.amp_act: amp_cuda.amp_act_bytes}


class ByteCounter(TorchDispatchMode):
    """Sums the input and output tensor bytes (``numel · element_size``)
    of every aten op run inside it, by op in :attr:`by_op`; views,
    ``detach`` and allocations without a write count nothing, and an
    operator of :data:`_OP_BYTES` counts its formula."""

    def __init__(self):
        super().__init__()
        self.by_op: Counter = Counter()

    @property
    def total(self) -> int:
        return sum(self.by_op.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = _OP_BYTES.get(func.overloadpacket)
        if formula is not None:
            self.by_op[func.overloadpacket.__name__] += formula(*args,
                                                                **kwargs)
        elif not func.is_view and func.overloadpacket not in _NO_DATA:
            self.by_op[func.overloadpacket.__name__] += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def count_cost(fn: Callable, *args, **kwargs) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call ``fn(*args, **kwargs)`` under
    ``torch.no_grad()``: FlopCounterMode's count and the eager byte count
    of :class:`ByteCounter`. The call runs for real."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with torch.no_grad(), flops, nbytes:
        fn(*args, **kwargs)
    return flops.get_total_flops(), nbytes.total


def stage_fns(pipe, batch: int, phonemes: int,
              frames: int) -> Dict[str, Callable]:
    """The three stages of one fused dispatch as zero-argument calls on
    ``pipe``'s device, with the JAX tool's zero inputs: ids 0, every row
    ``phonemes`` long, a ``frames`` budget, prior seed 0 (drawn inside the
    call, as JAX draws it inside its executable), an f32 zero mel for the
    vocoder; the end-to-end stage quantizes to PCM16 on the device."""
    dev, cfg = pipe.device, pipe.config
    ids = torch.zeros((batch, phonemes), dtype=torch.int64, device=dev)
    lengths = torch.full((batch,), phonemes, dtype=torch.int64, device=dev)
    mel = torch.zeros((batch, frames, cfg.hifigan.in_channels),
                      dtype=torch.float32, device=dev)

    def text_to_mel():
        return fused_mel(pipe.model, ids, lengths,
                         pipe._prior_noise(batch, frames, 0), 1.0, frames,
                         pipe.use_postnet, pipe.upsample)

    def vocoder():
        return pipe._vocode_device(mel)

    def fused():
        audio, _, n_frames, deficit = fused_synthesis(
            pipe.model, ids, lengths, pipe._prior_noise(batch, frames, 0),
            1.0, frames, pipe.use_postnet, pipe.upsample)
        return pipe._maybe_pcm16(audio, True), n_frames, deficit

    return dict(zip(STAGES, (text_to_mel, vocoder, fused)))


def roofline_rows(costs: Dict[str, Tuple[int, int]], audio_s: float,
                  peak_tflops: float, peak_hbm_gbps: float) -> list:
    """One row a stage from its (FLOPs, bytes), in the JAX tool's keys."""
    peak_fl, peak_bw = peak_tflops * 1e12, peak_hbm_gbps * 1e9
    rows = []
    for name, (fl, by) in costs.items():
        t_fl, t_bw = fl / peak_fl, by / peak_bw
        t_sol = max(t_fl, t_bw)
        rows.append({
            "stage": name,
            "gflops": fl / 1e9,
            "gbytes": by / 1e9,
            "arith_intensity": fl / by if by else float("inf"),
            "t_flops_ms": t_fl * 1e3,
            "t_hbm_ms": t_bw * 1e3,
            "bound": "HBM" if t_bw > t_fl else "FLOPs",
            "sol_rt_factor": audio_s / t_sol if t_sol else float("inf"),
        })
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=1024,
                    help="mel frames per utterance (1024 ≈ 11.9 s audio)")
    ap.add_argument("--phonemes", type=int, default=256)
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="peak TFLOP/s of the compute dtype (default: the "
                    "NVIDIA H100 SXM5 data sheet, dense: 989 in bfloat16 "
                    "on the tensor cores, 66.9 in float32 on the CUDA "
                    "cores)")
    ap.add_argument("--peak_hbm_gbps", type=float, default=PEAK_HBM_GBPS,
                    help="peak HBM GB/s (H100 SXM5 data sheet: 3350)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="compute dtype (bfloat16 = the JAX package's "
                    "serving default)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the table")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    """Prints the table (or the JSON line) and returns the JSON object."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = IrisConfig()
    pipe = TTSPipeline.initialize(cfg, seed=0, dtype=args.dtype,
                                  device=device)
    B, P, T = args.batch, args.phonemes, args.frames
    audio_s = B * T * cfg.audio.hop_length / cfg.audio.sample_rate
    peak_tflops = args.peak_tflops or PEAK_TFLOPS[args.dtype]
    costs = {name: count_cost(fn)
             for name, fn in stage_fns(pipe, B, P, T).items()}
    rows = roofline_rows(costs, audio_s, peak_tflops, args.peak_hbm_gbps)
    report = {"config": {"B": B, "T": T, "P": P, "dtype": args.dtype},
              "audio_s_per_dispatch": audio_s,
              "peak_tflops": peak_tflops,
              "peak_hbm_gbps": args.peak_hbm_gbps,
              "stages": rows}
    if args.json:
        print(json.dumps(report))
        return report
    print(f"B={B} T={T} frames P={P} {args.dtype} on {device} "
          f"({audio_s:.2f} s audio/dispatch); peaks: {peak_tflops} TFLOP/s, "
          f"{args.peak_hbm_gbps} GB/s")
    hdr = (f"{'stage':38} {'GFLOP':>8} {'GB':>7} {'F/B':>6} "
           f"{'t_fl ms':>8} {'t_bw ms':>8} {'bound':>6} {'SoL RT×':>9}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['stage']:38} {r['gflops']:8.2f} {r['gbytes']:7.3f} "
              f"{r['arith_intensity']:6.1f} {r['t_flops_ms']:8.3f} "
              f"{r['t_hbm_ms']:8.3f} {r['bound']:>6} "
              f"{r['sol_rt_factor']:9.0f}")
    e2e = rows[-1]
    print(f"\nspeed of light: {e2e['sol_rt_factor']:.0f}x realtime per "
          f"dispatch shape ({e2e['bound']}-bound). A measured device time "
          f"of the same dispatch divides into this for the efficiency "
          f"fraction.")
    return report


if __name__ == "__main__":
    main()
