"""BigVGAN's least time at the shapes it ran in the traced jobs over its
measured device time (under ``iris.vocoder``), in percent. The least time
of a batch is the larger of its FLOPs over the float32 peak and its bytes
over the HBM bandwidth, the bytes being the mel and the weights read once
and the waveform written once; FLOPs are counted over the plain BigVGAN
reference (``perfbench/cost_bigvgan.py``)."""

from perfbench import cost_bigvgan, progspans, speech


def read(ctx):
    spans = progspans.device_us(ctx)
    if not spans or ctx.peaks is None:
        return None
    us = spans.get("vocoder", 0.0)
    shapes = speech.traced_vocoder_shapes(ctx)
    if us <= 0 or not shapes:
        return None
    fm, pk = cost_bigvgan.flop_model(ctx), ctx.peaks
    hop, params = speech.hop(ctx), cost_bigvgan.vocoder_params(ctx)
    n_mels = speech.model_cfg(ctx)["hifigan"]["in_channels"]
    least = 0.0
    for b, t in shapes:
        nbytes = 4 * (b * t * n_mels + params + b * t * hop)
        least += max(fm.vocoder(b, t) / pk["float32_flops"],
                     nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / (us * 1e-6)
