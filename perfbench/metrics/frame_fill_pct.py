"""Speech frames over stage B's padded frames in the traced jobs, in
percent: the program's counter ``stage_b.frames_useful`` (each distinct
utterance's own frames) over ``stage_b.frames_padded`` (each batch's rows
× its frame bucket). They advance only while the profiler records."""

from perfbench import progtrace


def read(ctx):
    c = progtrace.counters(ctx)
    if not c or not c.get("stage_b.frames_padded"):
        return None
    return (100.0 * c.get("stage_b.frames_useful", 0)
            / c["stage_b.frames_padded"])
