"""What the metrics of a speech-synthesis driver derive from its record
(``drivers/bulk_synthesize.py`` writes ``texts``, ``samples``,
``job_shapes`` and ``trace_jobs``), each worked out once a run through
the context's ``memo``."""

from __future__ import annotations

import numpy as np


def model_cfg(ctx) -> dict:
    return ctx.parts["config"]["model"]


def hop(ctx) -> int:
    return int(np.prod(model_cfg(ctx)["hifigan"]["upsample_rates"]))


def traced_vocoder_shapes(ctx) -> list:
    """(rows, frames) of each batch's vocoder call in the traced jobs."""
    rec = ctx.record
    return [s for j in rec["trace_jobs"] for s in rec["job_shapes"][j]]


def flop_model(ctx):
    from perfbench.cost import FlopModel

    return ctx.memo("flop_model", lambda: FlopModel(model_cfg(ctx)))


def vocoder_params(ctx) -> int:
    return ctx.memo("vocoder_params", lambda: sum(
        p.numel() for p in flop_model(ctx).model.hifigan.parameters()))


def utterance_sizes(ctx) -> list:
    """(phonemes, frames) of each finished utterance, the phonemes counted
    by the reference frontend."""

    def sizes():
        from perfbench import weights
        from perfbench.reference.frontend import Frontend, read_lexicon

        cfg = ctx.parts["config"]
        fe = Frontend(read_lexicon(), weights.vocab(cfg))
        h = hop(ctx)
        return [(len(fe.ids(t)), n // h)
                for t, n in zip(ctx.record["texts"], ctx.record["samples"])
                if n]

    return ctx.memo("utterance_sizes", sizes)
