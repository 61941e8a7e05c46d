"""The anti-aliased activations' least time at the shapes they ran in the
traced jobs over their measured device time (under ``iris.amp_act``), in
percent: per activation the larger of its FIR FLOPs over the float32 peak
and its bytes (input read and output written once, α and β) over the HBM
bandwidth, which is the larger (``perfbench/cost_bigvgan.py``)."""

from perfbench import progspans, speech
from perfbench.cost_bigvgan import activation_shapes, amp_cost


def read(ctx):
    spans = progspans.device_us(ctx)
    if not spans or ctx.peaks is None:
        return None
    us = spans.get("amp_act", 0.0)
    shapes = speech.traced_vocoder_shapes(ctx)
    if us <= 0 or not shapes:
        return None
    pk = ctx.peaks
    hifigan = speech.model_cfg(ctx)["hifigan"]
    least = 0.0
    for b, t in shapes:
        for shape in activation_shapes(hifigan, b, t):
            flops, nbytes = amp_cost(shape)
            least += max(flops / pk["float32_flops"],
                         nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / (us * 1e-6)
