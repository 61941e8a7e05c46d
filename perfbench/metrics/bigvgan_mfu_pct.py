"""FLOPs of every utterance finished in the window, each at its own
phoneme and frame counts, with BigVGAN's FLOPs for the vocoder
(``perfbench/cost_bigvgan.py``), over the window's time at the card's
float32 peak, in percent: the whole synthesis step's share of the chip."""

from perfbench import cost_bigvgan, speech


def read(ctx):
    if ctx.peaks is None:
        return None
    sizes = speech.utterance_sizes(ctx)
    if not sizes:
        return None
    fm = cost_bigvgan.flop_model(ctx)
    flops = sum(fm.utterance(p, t) for p, t in sizes)
    return 100.0 * flops / (ctx.record["window_s"]
                            * ctx.peaks["float32_flops"])
