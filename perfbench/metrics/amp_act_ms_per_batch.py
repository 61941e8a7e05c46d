"""Device time of the kernels launched under the program's anti-aliased
activation spans (``iris.amp_act``, each of BigVGAN's activations) in the
traced jobs, per batch."""

from perfbench import progspans, speech


def read(ctx):
    spans = progspans.device_us(ctx)
    batches = len(speech.traced_vocoder_shapes(ctx))
    if not spans or not batches:
        return None
    us = spans.get("amp_act", 0.0)
    return us / 1e3 / batches if us > 0 else None
