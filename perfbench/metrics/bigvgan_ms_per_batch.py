"""Device time of the kernels launched under the program's vocoder span
(``iris.vocoder``: BigVGAN) in the traced jobs, per batch."""

from perfbench import progspans, speech


def read(ctx):
    spans = progspans.device_us(ctx)
    batches = len(speech.traced_vocoder_shapes(ctx))
    if not spans or not batches:
        return None
    us = spans.get("vocoder", 0.0)
    return us / 1e3 / batches if us > 0 else None
