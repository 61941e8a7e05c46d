"""Seconds of audio that reached the host, each utterance trimmed to its
own frames, over the window's wall time: all the work and all the time of
the window."""

from perfbench import speech


def read(ctx):
    rec = ctx.record
    rate = speech.model_cfg(ctx)["audio"]["sample_rate"]
    return sum(rec["samples"]) / rate / rec["window_s"]
