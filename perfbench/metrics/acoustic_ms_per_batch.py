"""Device time of the kernels launched under the encoder, duration-head,
VAE (``generate``) and PostNet ranges in the traced jobs, per batch."""

from perfbench import speech

RANGES = ("encoder", "duration", "vae", "postnet")


def read(ctx):
    trace = ctx.trace
    batches = len(speech.traced_vocoder_shapes(ctx))
    if trace is None or not batches:
        return None
    us = sum(trace["range_device_us"].get(r, 0.0) for r in RANGES)
    return us / 1e3 / batches if us > 0 else None
