"""The reduction of a profiler's events to busy time, range device time,
busiest operations and labelled idle gaps."""

from types import SimpleNamespace

import pytest
import torch

from perfbench.devtrace import Spans, summarize

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _evt(name, start, end, device=CPU, device_us=0.0, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, device_time_total=device_us,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


def test_busy_ranges_ops_and_gaps():
    events = [
        _evt("pb.hifigan", 0, 50, device_us=30.0),
        _evt("pb.frontend", 55, 95),
        _evt("aten::conv1d", 10, 20),
        _evt("k1", 10, 30, CUDA),
        _evt("k2", 25, 40, CUDA),   # overlaps k1
        _evt("pb.hifigan", 12, 45, CUDA, annotation=True),  # not a kernel
        _evt("k1", 100, 110, CUDA),  # after a 60 us gap in the frontend
    ]
    s = summarize(events)
    assert s["busy_us"] == pytest.approx(40.0)
    assert s["range_device_us"] == {"hifigan": 30.0, "frontend": 0.0}
    assert s["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert s["idle_gaps"] == [["pb.frontend / no host op",
                               pytest.approx(60e-6)]]


def test_spans_wrap_and_unwrap_an_instance():
    class Obj:
        def f(self, x):
            return x + 1

    obj, spans = Obj(), Spans()
    spans.method("f", obj, "f")
    assert obj.f(1) == 2 and spans.calls["f"] == 1 and spans.host_s["f"] > 0
    spans.remove()
    assert "f" not in vars(obj) and obj.f(2) == 3
