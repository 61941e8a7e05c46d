"""Device time under the program's own ranges in a traced run: for each
``iris.<name>`` range that ``iris_tts_tpu_torch`` opened while the profiler
recorded (``utils/prof.py``), the device time of the kernels launched
under it, summed over its calls, as ``devtrace.summarize`` reads the
harness's ``pb.`` ranges (``device_time_total`` of the host-side range,
which holds the kernels of the ranges nested in it). None off a traced
run; an empty dict where the program opened no such range."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

from perfbench.devtrace import _device_time_us, _is_device
from perfbench.progtrace import SPAN


def device_us(ctx) -> Optional[Dict[str, float]]:
    """Short span name → microseconds of device time under it."""

    def make():
        prof = ctx.record.get("profile")
        if prof is None:
            return None
        out: Dict[str, float] = defaultdict(float)
        for e in prof.events():
            if not _is_device(e) and e.name.startswith(SPAN):
                out[e.name[len(SPAN):]] += _device_time_us(e)
        return dict(out)

    return ctx.memo("program_span_device_us", make)
