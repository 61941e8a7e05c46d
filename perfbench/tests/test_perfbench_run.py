"""A whole run of a cell, at a tiny size on the CPU with the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath (half of each batch left out; one answer altered where the
vocoder produces it; a row left without audio), it comes out not correct. On the card: the control
(the timed path in TF32) fails the shipped cell, sound runs pass. And
without a card the command fails and prints no line."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"
SEED = 2**31 + 977


def _tiny_bench():
    bench = run.benchmark()
    bench["workloads"] = [{"name": "tiny-bulk", "config": "tiny",
                           "traffic": "tiny-bulk", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["tiny-bulk"]
    return bench


def _run(trace=False):
    return run.run_cell(_tiny_bench(), "tiny-bulk", SEED, 0.2, trace,
                        torch.device("cpu"), time.perf_counter(),
                        base=TINY)


def test_sound_run_is_correct():
    out = _run()
    result = out["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 8 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_traced_run_prints_no_device_metric_off_the_card():
    result = _run(trace=True)["result"]
    assert result["correct"]
    device_metrics = {"acoustic_ms_per_batch", "hifigan_ms_per_batch",
                      "hifigan_roofline", "synth_mfu_pct",
                      "device_idle_pct"}
    assert not device_metrics & set(result["metrics"])


def test_half_of_each_batch_left_out_is_caught(monkeypatch):
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    collect = TTSPipeline._batched_collect

    def first_half_twice(self, disp):
        rows = collect(self, disp)
        half = len(rows) // 2
        return rows[:half] + rows[:len(rows) - half]

    monkeypatch.setattr(TTSPipeline, "_batched_collect", first_half_twice)
    assert not _run()["result"]["correct"]


def test_an_answer_altered_in_the_vocoder_is_caught(monkeypatch):
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator

    forward = HiFiGANGenerator.forward

    def altered(self, mel):
        out = forward(self, mel).clone()
        out[0, 40] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(HiFiGANGenerator, "forward", altered)
    result = _run()["result"]
    assert not result["correct"]
    assert result["checks"]["wave_gap"]["value"] > \
        result["checks"]["wave_gap"]["limit"]


def test_a_row_left_without_audio_is_caught(monkeypatch):
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    collect = TTSPipeline._batched_collect

    def second_row_dropped(self, disp):
        rows = collect(self, disp)
        rows[1] = None
        return rows

    monkeypatch.setattr(TTSPipeline, "_batched_collect", second_row_dropped)
    result = _run()["result"]
    assert not result["correct"]
    assert result["failed"] > 0
    assert result["checks"]["frames_bad_rows"]["value"] > 0


def test_without_a_card_the_command_fails_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "v1-bulk-ljspeech", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v1-bulk-ljspeech", "v2-bulk-ljspeech"])
def test_control_fails_and_sound_runs_pass_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from perfbench.calibrate import readings

    with open(os.devnull, "w") as sink:
        lines = readings(cell, [SEED, SEED + 1, SEED + 2],
                         [SEED + 3, SEED + 4, SEED + 5], out=sink)
    assert all(r["correct"] for r in lines if not r["control"])
    assert not any(r["correct"] for r in lines if r["control"])
    assert np.isfinite([r["checks"]["wave_gap"]["value"]
                        for r in lines]).all()
