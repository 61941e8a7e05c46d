"""Device time of the kernels launched under the HiFiGAN range in the
traced jobs, per batch."""

from perfbench import speech


def read(ctx):
    trace = ctx.trace
    batches = len(speech.traced_vocoder_shapes(ctx))
    if trace is None or not batches:
        return None
    us = trace["range_device_us"].get("hifigan", 0.0)
    return us / 1e3 / batches if us > 0 else None
