"""The synthesis path's spans and counters (``iris_tts_tpu_torch/utils/
prof.py``): off unless a profiler records, no effect on the audio, the
spans nested as the bulk path documents them, and the frame counters equal
to what the returned audio and the chosen buckets say."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.scripts.batch_synthesize import synthesize_batches
from iris_tts_tpu_torch.utils import prof
from tests.torch_port_utils import small_config

TEXTS = ["Hello world.", "The quick brown fox jumps.", "A test.",
         "Speech synthesis is fast.", "Good morning to you all."]
BATCH = 2
N_BATCHES = 3  # five texts at two a batch, the last padded

# Each span → the nearest ``iris.`` span open around it (None: the root).
PARENT = {"job": None, "frontend": "job", "encode": "job",
          "stage_a": "job", "bucket": "job", "stage_b": "job",
          "acoustic": "stage_b", "vocoder": "stage_b", "collect": "job"}


@pytest.fixture(scope="module")
def pipe():
    return TTSPipeline.initialize(small_config(tcfg), seed=7, device="cpu")


@pytest.fixture
def fresh_counters(monkeypatch):
    monkeypatch.setattr(prof, "_COUNTERS", {})


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _iris_events(p):
    return [e for e in p.events() if e.name.startswith(prof.SPAN_PREFIX)]


def _short(name):
    return name[len(prof.SPAN_PREFIX):]


def _vocoder_layers(pipe):
    """The resblock layers of one vocoder call, which the generator counts
    as ``vocoder.library_layers`` on the CPU (``vocoder.fused_layers``
    where its CUDA kernel runs them)."""
    cfg = pipe.config.hifigan
    return len(cfg.upsample_rates) * sum(len(d)
                                         for d in cfg.resblock_dilations)


def test_off_without_a_profiler(pipe, fresh_counters):
    off = prof.span("job")
    assert off is prof.span("stage_b")  # one shared no-op
    with off:
        pass
    prof.count("stage_b.frames_padded", 5)
    synthesize_batches(pipe, TEXTS, BATCH, 3)
    assert prof.counters() == {}
    with _cpu_profile():
        assert prof.span("job") is not off
        prof.count("x", 2)
        prof.count("x")
    got = prof.counters()
    assert got == {"x": 3}
    got["x"] = 0  # a copy
    assert prof.counters() == {"x": 3}


def test_tracing_is_on_exactly_while_the_profiler_records():
    """The flag the spans test agrees with the profiler's own C-side state
    outside a profile, inside one, and through a schedule's wait, warm-up
    and recording steps."""
    states = [(prof.tracing(), torch._C._autograd._profiler_enabled())]
    with _cpu_profile():
        states.append((prof.tracing(),
                       torch._C._autograd._profiler_enabled()))
    schedule = torch.profiler.schedule(wait=1, warmup=1, active=1)
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule) as p:
        for _ in range(3):
            states.append((prof.tracing(),
                           torch._C._autograd._profiler_enabled()))
            p.step()
    states.append((prof.tracing(), torch._C._autograd._profiler_enabled()))
    assert [a for a, _ in states] == [b for _, b in states]
    assert [a for a, _ in states] == [False, True, False, False, True,
                                      False]


def test_audio_is_bitwise_the_same_under_the_profiler(pipe, fresh_counters):
    want_audio, want_plan = synthesize_batches(pipe, TEXTS, BATCH, 11)
    with _cpu_profile():
        audio, plan = synthesize_batches(pipe, TEXTS, BATCH, 11)
    assert plan == want_plan
    assert sorted(audio) == sorted(want_audio)
    for i, a in want_audio.items():
        assert audio[i].dtype == a.dtype and np.array_equal(audio[i], a)


def test_spans_nest_as_the_bulk_path_documents(pipe, fresh_counters):
    with _cpu_profile() as p:
        synthesize_batches(pipe, TEXTS, BATCH, 5)
    events = _iris_events(p)
    per_batch = {"encode", "stage_a", "stage_b", "acoustic", "vocoder",
                 "collect"}
    want = {n: (N_BATCHES if n in per_batch else 1) for n in PARENT}
    assert Counter(_short(e.name) for e in events) == want
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(
                prof.SPAN_PREFIX):
            parent = parent.cpu_parent
        name = _short(e.name)
        assert (parent and _short(parent.name)) == PARENT[name], name
        if parent is not None:
            assert (parent.time_range.start <= e.time_range.start
                    and e.time_range.end <= parent.time_range.end), name


def test_frame_counters_equal_the_audio_and_the_buckets(pipe,
                                                        fresh_counters,
                                                        monkeypatch):
    buckets = []
    stage_b = pipe._stage_b

    def recording(enc, frames, t_bucket, *args):
        buckets.append(t_bucket)
        return stage_b(enc, frames, t_bucket, *args)

    monkeypatch.setattr(pipe, "_stage_b", recording)
    with _cpu_profile():
        audio, plan = synthesize_batches(pipe, TEXTS, BATCH, 9)
    hop = pipe.config.hifigan.total_upsample
    assert all(len(a) % hop == 0 for a in audio.values())
    assert len(buckets) == len(plan) == N_BATCHES
    assert prof.counters() == {
        "stage_b.frames_useful": sum(len(a) // hop for a in audio.values()),
        "stage_b.frames_padded": sum(len(idxs) * t for (idxs, _), t
                                     in zip(plan, buckets)),
        "vocoder.library_layers": N_BATCHES * _vocoder_layers(pipe),
    }
    assert any(len(set(idxs)) < len(idxs) for idxs, _ in plan)  # padded


@pytest.mark.parametrize("fused,want", [
    (False, {"encode", "stage_a", "stage_b", "acoustic", "vocoder",
             "collect"}),
    # the fused path's device work is one module-level function, the one
    # serve/export.py exports and captures: it carries no span
    (True, {"encode", "collect"}),
])
def test_other_entry_points_open_the_method_spans(pipe, fresh_counters,
                                                  fused, want):
    with _cpu_profile() as p:
        pipe.synthesize(TEXTS[:2], seed=1, fused=fused)
    got = Counter(_short(e.name) for e in _iris_events(p))
    assert got == {n: 1 for n in want}
    # only the bulk path counts frames; every vocoder call counts its layers
    assert prof.counters() == {"vocoder.library_layers":
                               _vocoder_layers(pipe)}
