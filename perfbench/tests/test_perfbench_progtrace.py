"""The readers of the program's spans and counters
(``perfbench/progtrace.py`` and the four metrics it serves): the idle
split on a synthetic trace with a known answer, the readers' None where
the program or the card gives nothing to read, and the frame fill of a
tiny traced run on the CPU against a count from the run's own record."""

import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import progtrace, run, speech
from perfbench.metrics import (
    frame_fill_pct,
    idle_collect_pct,
    idle_dispatch_pct,
    idle_frontend_pct,
)
from perfbench.tests.test_perfbench_run import SEED, TINY, _tiny_bench

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
IDLE_READERS = {"frontend": idle_frontend_pct, "dispatch": idle_dispatch_pct,
                "collect": idle_collect_pct}


def _evt(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


# A stretch of 200 us holding two jobs, 5-120 and 130-200 (the stretch
# ends where the last job does). The device is busy 20-40, 60-70, 95-110
# and 160-170, so the idle intervals are an edge (0-20: job 1's frontend
# before the first kernel), gaps that straddle two spans (40-60, 70-95,
# 110-160) and the last job's tail (170-200).
EVENTS = [
    _evt("iris.job", 5, 120),
    _evt("iris.frontend", 5, 50),
    _evt("iris.stage_a", 50, 60),
    _evt("iris.collect", 80, 100),
    _evt("iris.job", 130, 200),
    _evt("iris.frontend", 130, 150),
    _evt("iris.stage_b", 150, 165),
    _evt("pb.hifigan", 150, 165),
    _evt("aten::conv1d", 151, 152),
    _evt("k", 20, 40, CUDA),
    _evt("k", 60, 70, CUDA),
    _evt("memcpy", 95, 105, CUDA),
    _evt("k", 100, 110, CUDA),
    _evt("k", 160, 170, CUDA),
    # device copies of the ranges: not device work
    _evt("iris.job", 20, 110, CUDA, annotation=True),
    _evt("pb.hifigan", 160, 170, CUDA),
]
WANT = {
    # 0-5 outside, 5-20 frontend; 40-50 frontend, 50-60 dispatch;
    # 70-80 dispatch, 80-95 collect; 110-120 dispatch, 120-130 outside,
    # 130-150 frontend, 150-160 dispatch; 170-200 dispatch
    "frontend": 15 + 10 + 20, "collect": 15,
    "dispatch": 10 + 10 + 10 + 10 + 30, "outside": 5 + 10,
}


def _shifted(events, dt):
    return [_evt(e.name, e.time_range.start + dt, e.time_range.end + dt,
                 e.device_type, e.is_user_annotation) for e in events]


def _ctx(events, window_s, profiled=True):
    memo = {}
    return SimpleNamespace(
        record={"profile": (SimpleNamespace(events=lambda: events)
                            if profiled else None),
                "trace_window_s": window_s},
        memo=lambda key, make: memo[key] if key in memo
        else memo.setdefault(key, make()))


@pytest.mark.parametrize("dt", [0.0, 37.5])
def test_split_has_the_known_answer_and_adds_up(dt):
    # dt: the profiler's clock started dt before the harness's
    split = progtrace.split_idle(_shifted(EVENTS, dt), 200.0)
    assert {k: split[k] for k in WANT} == pytest.approx(WANT)
    assert split["idle"] == pytest.approx(200 - 20 - 10 - 15 - 10)
    assert sum(split[k] for k in WANT) == pytest.approx(split["idle"])


def test_readers_give_shares_of_the_stretch():
    ctx = _ctx(EVENTS, 200e-6)
    for part, reader in IDLE_READERS.items():
        assert reader.read(ctx) == pytest.approx(100.0 * WANT[part] / 200)


@pytest.mark.parametrize("events", [
    [e for e in EVENTS if not e.name.startswith("iris.")],  # no spans
    [e for e in EVENTS if e.device_type == CPU],  # no device: the CPU
])
def test_idle_readers_give_nothing_without_spans_or_device(events):
    ctx = _ctx(events, 200e-6)
    assert all(r.read(ctx) is None for r in IDLE_READERS.values())
    assert all(r.read(_ctx(EVENTS, None)) is None
               for r in IDLE_READERS.values())


def test_frame_fill_reads_the_counters_and_nothing_without_them(
        monkeypatch):
    from iris_tts_tpu_torch.utils import prof

    monkeypatch.setattr(prof, "_COUNTERS", {"stage_b.frames_useful": 3,
                                            "stage_b.frames_padded": 4})
    assert frame_fill_pct.read(_ctx(EVENTS, 1.0)) == pytest.approx(75.0)
    assert frame_fill_pct.read(_ctx(EVENTS, 1.0, profiled=False)) is None
    monkeypatch.setattr(prof, "_COUNTERS", {})
    assert frame_fill_pct.read(_ctx(EVENTS, 1.0)) is None
    monkeypatch.delattr(prof, "counters")  # a program without counters
    assert frame_fill_pct.read(_ctx(EVENTS, 1.0)) is None


def test_tiny_traced_run_fill_equals_the_records_count(monkeypatch):
    from iris_tts_tpu_torch.utils import prof

    monkeypatch.setattr(prof, "_COUNTERS", {})
    out = run.run_cell(_tiny_bench(), "tiny-bulk", SEED + 5, 0.2, True,
                       torch.device("cpu"), time.perf_counter(), base=TINY)
    rec, metrics = out["record"], out["result"]["metrics"]
    hop = speech.hop(out["ctx"])
    per_job = out["ctx"].parts["traffic"]["utterances_per_job"]
    useful = sum(n // hop for j in rec["trace_jobs"]
                 for n in rec["samples"][j * per_job:(j + 1) * per_job])
    padded = sum(b * t for j in rec["trace_jobs"]
                 for b, t in rec["job_shapes"][j])
    assert metrics["frame_fill_pct"]["value"] == pytest.approx(
        100.0 * useful / padded, rel=1e-12)
    assert not {f"idle_{p}_pct" for p in IDLE_READERS} & set(metrics)
