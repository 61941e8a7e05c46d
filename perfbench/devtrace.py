"""Spans from the benchmark's own side, and the device trace of a stretch.

:class:`Spans` opens a ``torch.profiler.record_function`` range named
``pb.<name>`` around calls into the program's layers: forward hooks on
model modules (the range opens in a pre-hook and closes in the hook) and
wrappers of a pipeline instance's methods, which also add the call's host
time to a counter. Nothing of the program is edited; the hooks and
wrappers go when :meth:`Spans.remove` runs.

:func:`summarize` reads a profiler's events: the device intervals (kernels,
copies and sets; not the device-side copies of the ranges), the device
time of the kernels launched under each range, the busiest device
operations, and the longest idle gaps on the device, each named by the
innermost range and operation the host had open at its middle.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

PREFIX = "pb."


class Spans:
    def __init__(self):
        self._undo = []
        self.host_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def module(self, name: str, module: torch.nn.Module) -> None:
        """A range around every forward call of ``module``."""
        open_ranges = []

        def pre(_mod, _args):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_mod, _args, _out):
            open_ranges.pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre),
                   module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def method(self, name: str, obj, attr: str) -> None:
        """A range around every call of ``obj.attr`` on this instance,
        whose host time is added to ``host_s[name]``."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            self.host_s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def _device_time_us(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    return float(t if t is not None else evt.cuda_time_total)


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def summarize(events, top: int = 10) -> Dict:
    """Reduce a profiler's ``events()`` to: ``busy_us`` (the union of the
    device intervals), ``range_device_us`` (kernel time launched under
    each ``pb.`` range), ``device_ops`` and ``idle_gaps`` (the ``top``
    largest, in seconds)."""
    device, host, ranges = [], [], defaultdict(float)
    for e in events:
        is_range = e.name.startswith(PREFIX)
        if _is_device(e):
            if not is_range and not getattr(e, "is_user_annotation", False):
                device.append((e.time_range.start, e.time_range.end, e.name))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name,
                         is_range))
            if is_range:
                ranges[e.name[len(PREFIX):]] += _device_time_us(e)
    device.sort()
    busy, gaps, by_name = 0.0, [], defaultdict(float)
    cur_s = cur_e = None
    for s, e, name in device:
        by_name[name] += e - s
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, (s + cur_e) / 2))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    return {
        "busy_us": busy,
        "range_device_us": dict(ranges),
        "device_ops": [[name[:160], us * 1e-6] for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_at(host, at), us * 1e-6]
                      for us, at in gaps[:top]],
    }


def _host_at(host: List[Tuple[float, float, str, bool]], t: float) -> str:
    """'<innermost pb range> / <innermost host op>' open at time ``t``."""
    rng, op = None, None
    rng_len = op_len = float("inf")
    for s, e, name, is_range in host:
        if s <= t <= e:
            if is_range and e - s < rng_len:
                rng, rng_len = name, e - s
            elif not is_range and e - s < op_len:
                op, op_len = name, e - s
    return f"{rng or 'no range'} / {op or 'no host op'}"
