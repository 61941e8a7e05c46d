"""The port's benchmark drivers (``iris_tts_tpu_torch.bench`` and
``iris_tts_tpu_torch.scripts.bench_{batch_sweep,mel,serve,stream,train}``),
run in-process with ``--device cpu`` at small widths: their options and
JSON keys against the JAX package's scripts, the JAX command-line tests
mirrored, the headline bench's timed dispatch against JAX's stage
functions on the same weights, its roofline keys from the roofline tool's
count, its cold start, the streaming check and its planted miss, and the
log-mel bench on a host without a card."""

import argparse
import functools
import importlib
import json
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import bench
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.scripts import (
    bench_batch_sweep,
    bench_mel,
    bench_serve,
    bench_stream,
    bench_train,
    roofline,
)
from tests.torch_port_utils import (
    max_abs,
    numpy_tree,
    port_config,
    small_config,
)

torch.set_num_threads(2)

DRIVERS = {"bench_batch_sweep": bench_batch_sweep, "bench_mel": bench_mel,
           "bench_serve": bench_serve, "bench_stream": bench_stream,
           "bench_train": bench_train}
# tests/test_scripts.py's SMALL_CFG (hop 256 against a generator that
# upsamples by 8, as the JAX tests run it).
SMALL_CFG = {
    "encoder": {"vocab_size": 41, "embed_dim": 16, "num_blocks": 1,
                "num_heads": 2},
    "duration": {"hidden_dim": 8, "num_layers": 1},
    "vae": {"n_mels": 16, "cond_dim": 16, "model_channels": 8,
            "latent_dim": 4, "num_wavenet_blocks": 1, "decoder_blocks": 1,
            "flow_layers": 1, "flow_hidden": 8},
    "postnet": {"n_mels": 16, "num_layers": 2, "channels": 8},
    "hifigan": {"in_channels": 16, "upsample_rates": [4, 2],
                "upsample_kernel_sizes": [8, 4],
                "upsample_initial_channel": 16,
                "resblock_kernel_sizes": [3],
                "resblock_dilations": [[1]]},
}
SERVE_ARGS = ["--clients", "2", "--requests", "2", "--phoneme_buckets",
              "16,32", "--frame_buckets", "32,64", "--max_batch", "2",
              "--device", "cpu"]

# The JAX scripts' JSON keys, where they print them.
# bench.py:524-543 (the unpacked-fetch A/B's key is not ported).
JAX_BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "mel_frames_per_sec",
    "rtf_b8", "mel_frames_per_sec_b8",
    "bulk_batch", "bulk_rtf", "bulk_mel_frames_per_sec",  # :335-339
    "p50_fused_dispatch_ms", "p50_public_api_ms", "p50_public_api_pcm16_ms",
    "p50_public_api_unpacked_ms",
    "sol_rt_factor", "sol_fraction", "sol_bound",  # :489-493
    # :172-195
    "cold_start_to_first_audio_s", "cold_start_env_floor_s",
    "cold_start_marginal_jit_s", "cold_start_backend_compile_s",
    "cold_start_framework_s", "cold_start_import_s", "cold_start_init_s",
    "cold_start_first_synth_s", "aot_export_s",
}
NOT_PORTED_BENCH_KEYS = {"p50_public_api_unpacked_ms"}
JAX_COLD_KEYS = {k for k in JAX_BENCH_KEYS
                 if k.startswith("cold_start_") or k == "aot_export_s"}
# bench.py:356-365 (JAX's "device" is "cpu_fallback"; the port's "cpu").
JAX_BENCH_CPU_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
# scripts/bench_batch_sweep.py:100-110
JAX_SWEEP_KEYS = {"metric", "batch", "frames", "mel_frames_per_sec", "rtf",
                  "step_ms", "marginal_scaling_eff", "compile_s", "dtype"}
# scripts/bench_train.py:121-128 and :197-204
JAX_TRAIN_KEYS = {"metric", "value", "unit", "step_ms", "batch", "dtype"}
# scripts/bench_serve.py:334-361
JAX_SERVE_KEYS = {"metric", "value", "unit", "mode", "transport", "batcher",
                  "max_batch_limit", "clients", "offered_qps",
                  "requests_sent", "requests_completed", "rejected_503",
                  "latency_ms", "audio_rt_factor", "mean_batch_size",
                  "batch_size_hist", "pcm16", "wall_s"}


@pytest.fixture
def small_cfg_file(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(SMALL_CFG))
    return p


def _small():
    return small_config(tcfg)


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# options and the device
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _jax_options(name, monkeypatch) -> set:
    """The option strings of the JAX script ``scripts/<name>.py``: its
    ``main()`` runs up to ``parse_args``, which hands over the parser."""
    mod = importlib.import_module(f"scripts.{name}")
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        mod.main()
    monkeypatch.undo()
    return {s for a in seen["parser"]._actions for s in a.option_strings}


def _options(mod) -> set:
    return {s for a in mod.build_parser()._actions for s in a.option_strings}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_options_are_jaxs_plus_device(name, monkeypatch):
    assert _options(DRIVERS[name]) == (_jax_options(name, monkeypatch)
                                       | {"--device"})


def test_bench_takes_device_alone():
    """JAX's ``bench.py`` parses no arguments (``main()`` at :201 reads
    only ``IRIS_BENCH_SKIP_COLDSTART``); the port's takes ``--device``."""
    assert _options(bench) == {"-h", "--help", "--device"}


@pytest.mark.parametrize("name", sorted(DRIVERS) + ["bench"])
def test_driver_without_cuda_raises(name, monkeypatch, capsys):
    """No CUDA and no ``--device``: the driver stops with resolve_device's
    error before it builds or prints anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = bench if name == "bench" else DRIVERS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the headline bench
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """JAX's small pipeline (HiFiGAN kernels ×15, so the audio is an
    order-one signal) and the port's on the same weights."""
    jpipe = JPipeline.initialize(small_config(), seed=3)
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    return jpipe, pipe


def _assert_durations_clear_of_half(jpipe, ids, lengths):
    """Frame counts are round(exp(p) − 1): a prediction within float noise
    of .5 could round apart in the two packages."""
    mask = np.arange(ids.shape[1])[None] < lengths[:, None]
    enc = jpipe._encoder.apply({"params": jpipe.params["encoder"]},
                               jnp.asarray(ids, jnp.int32),
                               padding_mask=jnp.asarray(mask))
    log_dur = jpipe._duration.apply({"params": jpipe.params["duration"]}, enc)
    x = np.exp(np.asarray(log_dur, np.float64)) - 1.0
    assert np.abs((x - np.floor(x)) - 0.5)[mask].min() > 1e-3


def test_timed_dispatch_matches_jax_stages(pipes):
    """``bench.synth_step`` (the port's stage A then stage B at the frame
    budget, and the on-device checksum) against the JAX bench's jitted
    ``_stage_a_fn`` + ``_stage_b_fn`` on the same weights and ids, at
    temperature 0 (both priors are exactly zero, as in
    ``tests/test_torch_pipeline.py``): waveform within 1e-3, checksum
    within 1e-3 of its scale."""
    jpipe, pipe = pipes
    B, P, T = 2, 16, 128
    rng = np.random.default_rng(1337)
    ids = rng.integers(2, len(pipe.vocab), size=(B, P))
    lengths = np.array([P, 11], np.int64)
    _assert_durations_clear_of_half(jpipe, ids, lengths)

    @jax.jit
    def synth(params, ids, lengths, seed, acc):
        enc, frames, _ = jpipe._stage_a_fn(params, ids, lengths)
        audio, _mel, _n = jpipe._stage_b_fn(params, enc, frames, seed,
                                            total_frames=T, temperature=0.0)
        return audio, acc + jnp.sum(audio, dtype=jnp.float32)

    want, want_acc = synth(jpipe.params, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(lengths, jnp.int32),
                           jnp.asarray(0, jnp.int32), jnp.float32(0.5))
    got, got_acc = bench.synth_step(pipe, ids, lengths, T, 0,
                                    torch.tensor(0.5), temperature=0.0)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, T * 256)
    assert float(np.abs(want).max()) > 0.05  # a real signal is compared
    assert max_abs(got, want) <= 1e-3
    assert abs(float(got_acc) - float(want_acc)) <= 1e-3 * max(
        1.0, float(np.abs(want).sum()))


def test_sol_keys_come_from_the_roofline_count(pipes, monkeypatch):
    """``sol_of`` reads ``roofline.count_cost`` over the timed dispatch and
    divides by ``roofline``'s peaks for the pipeline's dtype; the fraction
    is the bound over the measured wall (≤ 1 whenever the wall is at least
    the bound)."""
    _, pipe = pipes
    ids = np.full((2, 16), 5, np.int64)
    lengths = np.full((2,), 16, np.int64)
    acc0 = torch.zeros(())
    want = roofline.count_cost(bench.synth_step, pipe, ids, lengths, 64, 0,
                               acc0)
    calls = []
    real = roofline.count_cost

    def spy(fn, *args):
        calls.append((fn, args[1:4]))
        return real(fn, *args)

    monkeypatch.setattr(roofline, "count_cost", spy)
    audio_s = 2 * 64 * 256 / 22050
    row, = roofline.roofline_rows({"d": want}, audio_s,
                                  roofline.PEAK_TFLOPS["float32"],
                                  roofline.PEAK_HBM_GBPS)
    rtf = 0.5 * row["sol_rt_factor"]  # a wall of twice the bound
    sol = bench.sol_of(pipe, ids, lengths, 64, audio_s, rtf)
    assert calls and calls[0][0] is bench.synth_step
    assert set(sol) == {"sol_rt_factor", "sol_fraction", "sol_bound"}
    assert sol["sol_rt_factor"] == round(row["sol_rt_factor"], 1)
    assert sol["sol_fraction"] == 0.5
    assert sol["sol_bound"] == {"HBM": "hbm", "FLOPs": "flops"}[row["bound"]]
    fl, by = want
    t_sol = max(fl / (roofline.PEAK_TFLOPS["float32"] * 1e12),
                by / (roofline.PEAK_HBM_GBPS * 1e9))
    assert row["sol_rt_factor"] == pytest.approx(audio_s / t_sol)


def test_bench_cpu_line_is_jaxs_cpu_line(monkeypatch, capsys):
    """``--device cpu``: JAX's CPU shape (B=1, T=256, two iterations) and
    one stdout line in the keys of JAX's CPU line, ``device`` ``"cpu"``."""
    monkeypatch.setattr(bench, "IrisConfig", _small)
    monkeypatch.setattr(bench, "measure_cold_start", lambda device: (
        pytest.fail("the CPU line carries no cold start")))
    out = bench.main(["--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [out]
    assert set(out) == JAX_BENCH_CPU_KEYS and out["device"] == "cpu"
    assert out["metric"] == "synthesis_rtf_per_chip"
    assert out["unit"] == "x_realtime" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 50.0, 3)


def test_bench_card_line_keys_are_jaxs_less_the_unpacked_fetch():
    bulk = {"bulk_batch": 128, "bulk_rtf": 900.0,
            "bulk_mel_frames_per_sec": 9e4}
    sol = {"sol_rt_factor": 3000.0, "sol_fraction": 0.3, "sol_bound": "hbm"}
    cold = {k: 1.0 for k in JAX_COLD_KEYS}
    line = bench.headline(500.0, 4e4, bulk, 0.01, 0.02, 0.02, sol, cold)
    assert set(line) == JAX_BENCH_KEYS - NOT_PORTED_BENCH_KEYS
    assert line["value"] == 900.0 and line["vs_baseline"] == 18.0
    assert line["mel_frames_per_sec"] == 9e4 and line["rtf_b8"] == 500.0
    assert line["p50_fused_dispatch_ms"] == 10.0


def _cold_stdout(**skip) -> str:
    marks = {"ENV_FLOOR_S": 2.5, "MARGINAL_JIT_S": 0.01, "IMPORT_S": 1.5,
             "DESERIALIZE_S": 3.0, "WARM_S": 4.0, "FIRST_SYNTH_S": 0.02,
             "FIRST_AUDIO_S": 11.1}
    return "".join(f"{k}={v}\nnoise line\n" for k, v in marks.items()
                   if k not in skip)


def test_cold_start_keys_are_jaxs():
    keys = bench.cold_start_keys(_cold_stdout(), 20.0, 13.0)
    assert set(keys) == JAX_COLD_KEYS
    assert keys["cold_start_framework_s"] == pytest.approx(1.5 + 3.0 + 0.02)
    assert keys["cold_start_backend_compile_s"] == 4.0
    assert keys["cold_start_init_s"] == 3.0 and keys["aot_export_s"] == 20.0
    with pytest.raises(RuntimeError, match="WARM_S"):
        bench.cold_start_keys(_cold_stdout(WARM_S=1), 20.0, 13.0)


@pytest.mark.parametrize("failing", ["export", "child"])
def test_a_failed_cold_start_child_fails_the_bench(failing, monkeypatch):
    """JAX returns ``{}`` on a failed child; the port raises."""
    class Done:
        def __init__(self, rc, out=""):
            self.returncode, self.stdout, self.stderr = rc, out, "boom"

    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        export = "iris_tts_tpu_torch.serve.export" in cmd
        if failing == ("export" if export else "child"):
            return Done(1)
        return Done(0, "" if export else _cold_stdout())

    monkeypatch.setattr(bench.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="exited 1: boom"):
        bench.measure_cold_start(torch.device("cpu"))
    assert seen[0][seen[0].index("--device") + 1] == "cpu"
    assert len(seen) == (1 if failing == "export" else 2)


def test_cold_start_children_run_the_export_then_a_fresh_process(
        monkeypatch):
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        out = "" if "-m" in cmd else _cold_stdout()
        return type("Done", (), {"returncode": 0, "stdout": out,
                                 "stderr": ""})()

    monkeypatch.setattr(bench.subprocess, "run", run)
    keys = bench.measure_cold_start(torch.device("cuda"))
    export, child = cmds
    assert export[1:3] == ["-m", "iris_tts_tpu_torch.serve.export"]
    for flag, value in (("--batch_sizes", "1"), ("--phoneme_buckets", "64"),
                        ("--device", "cuda")):
        assert export[export.index(flag) + 1] == value
    assert "--random_weights" in export
    assert child[1] == "-c" and child[3] == export[export.index("--output")
                                                   + 1]
    assert child[4:] == [bench.TEXT, "cuda"]
    assert set(keys) == JAX_COLD_KEYS


# ---------------------------------------------------------------------------
# the JAX command-line tests, mirrored (tests/test_scripts.py)
# ---------------------------------------------------------------------------


def test_bench_batch_sweep_cli(small_cfg_file, capsys):
    """:123 — one JSON line a batch point, the marginal scaling efficiency
    filled in from the second point on."""
    rows = bench_batch_sweep.main([
        "--config", str(small_cfg_file), "--batches", "1,2", "--phonemes",
        "8", "--frames", "32", "--iters", "2", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == rows
    assert [row["batch"] for row in rows] == [1, 2]
    assert all(set(row) == JAX_SWEEP_KEYS for row in rows)
    assert all(row["metric"] == "synthesis_batch_sweep" for row in rows)
    assert all(row["mel_frames_per_sec"] > 0 for row in rows)
    assert rows[0]["marginal_scaling_eff"] is None
    assert rows[1]["marginal_scaling_eff"] is not None


def test_bench_train_cli_shape(monkeypatch, capsys):
    """:140 — exactly one JSON line on stdout (tiny shapes)."""
    monkeypatch.setattr(bench_train, "IrisConfig", _small)
    out = bench_train.main(["--batch_size", "2", "--frames", "32",
                            "--phonemes", "8", "--iters", "2", "--device",
                            "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [out] and set(out) == JAX_TRAIN_KEYS
    assert out["metric"] == "vae_train_mel_frames_per_sec"
    assert out["value"] > 0 and out["batch"] == [2, 32]
    assert out["dtype"] == "f32"


def test_bench_train_gan_round(monkeypatch, capsys):
    """``--stage gan --bf16``: one disc step and one generator step a round
    (discriminators narrowed for the CPU)."""
    monkeypatch.setattr(bench_train, "IrisConfig", _small)
    narrow = dict(periods=(2,), num_scales=1)
    monkeypatch.setattr(bench_train, "HiFiGANDiscriminators", functools.partial(
        bench_train.HiFiGANDiscriminators, width=0.05, **narrow))
    monkeypatch.setattr(bench_train, "make_gan_steps", functools.partial(
        bench_train.make_gan_steps, disc_width=0.05, **narrow))
    out = bench_train.main(["--stage", "gan", "--batch_size", "2",
                            "--segment_frames", "8", "--iters", "2",
                            "--bf16", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [out]
    assert set(out) == JAX_TRAIN_KEYS
    assert out["metric"] == "gan_train_audio_sec_per_sec"
    assert out["value"] > 0 and out["batch"] == [2, 8]
    assert out["dtype"] == "bf16"


def test_bench_train_rejects_frames_off_the_phonemes():
    with pytest.raises(SystemExit):
        bench_train.main(["--frames", "30", "--phonemes", "8", "--device",
                          "cpu"])


def test_bench_serve_cli(small_cfg_file, capsys):
    """:259 — one JSON line (closed loop, tiny shapes) with sane
    counters."""
    payloads = bench_serve.main(["--config", str(small_cfg_file),
                                 *SERVE_ARGS])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and len(payloads) == 1
    payload = lines[0]
    assert set(payload) == JAX_SERVE_KEYS
    assert payload["metric"] == "serve_qps"
    assert payload["requests_completed"] == 4
    assert payload["latency_ms"]["p99"] is not None
    assert payload["value"] > 0
    assert sum(int(k) * v for k, v in payload["batch_size_hist"].items()) \
        >= 4


def test_bench_serve_cli_ab(small_cfg_file, capsys):
    """:278 — ``--ab_max_batch_limit`` runs the fixed baseline and the
    adaptive batcher in one process: one JSON line a config, labelled."""
    bench_serve.main(["--config", str(small_cfg_file), *SERVE_ARGS,
                      "--ab_max_batch_limit", "4"])
    rows = _json_lines(capsys.readouterr().out)
    assert [row["batcher"] for row in rows] == ["fixed", "adaptive"]
    assert rows[0]["max_batch_limit"] is None
    assert rows[1]["max_batch_limit"] == 4
    assert all(row["requests_completed"] == 4 for row in rows)
    assert all(row["value"] > 0 for row in rows)


def test_bench_serve_http_and_open_loop(small_cfg_file, capsys):
    """``--http`` over localhost, then one open-loop rate in-process."""
    http, = bench_serve.main(["--config", str(small_cfg_file), *SERVE_ARGS,
                              "--http"])
    assert http["transport"] == "http" and http["requests_completed"] == 4
    opened, = bench_serve.main(["--config", str(small_cfg_file),
                                *SERVE_ARGS, "--offered_qps", "50",
                                "--requests", "3"])
    assert opened["mode"] == "open" and opened["offered_qps"] == 50.0
    assert opened["clients"] is None and opened["requests_sent"] == 3
    assert opened["requests_completed"] + opened["rejected_503"] == 3
    assert [set(r) for r in _json_lines(capsys.readouterr().out)] == [
        JAX_SERVE_KEYS] * 2


@pytest.mark.parametrize("argv", [
    ["--offered_qps", "0"], ["--offered_qps", "x"],
    ["--offered_qps", "5", "--http"], ["--ab_max_batch_limit", "4", "--http"],
    ["--ab_max_batch_limit", "4", "--max_batch_limit", "8"]])
def test_bench_serve_rejects_bad_flags_before_any_work(argv, monkeypatch):
    """JAX's argparse-time checks (scripts/bench_serve.py:183-235): the
    driver exits before it builds a pipeline."""
    monkeypatch.setattr(bench_serve.TTSPipeline, "initialize", lambda *a, **k: (
        pytest.fail("built a pipeline")))
    with pytest.raises(SystemExit):
        bench_serve.main(argv + ["--device", "cpu"])


def test_bench_serve_texts_and_arrivals_are_jaxs(monkeypatch):
    """The workload texts, and the open loop's submit times and texts under
    one fake clock, equal the JAX module's."""
    jmod = importlib.import_module("scripts.bench_serve")
    assert bench_serve.TEXTS == jmod.TEXTS

    def arrivals(mod):
        clock = [100.0]
        seen = []

        class Batcher:
            def submit(self, text):
                seen.append((clock[0], text))
                fut = Future()
                fut.set_result(np.zeros(220, np.float32))
                return fut

        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
        monkeypatch.setattr(mod.time, "sleep",
                            lambda s: clock.__setitem__(0, clock[0] + s))
        lats, audio_s, rejected, _ = mod.open_loop(Batcher(), 22050, 7.0,
                                                   12, 5.0)
        monkeypatch.undo()
        assert lats == [0.0] * 12 and rejected == 0
        assert audio_s == pytest.approx(12 * 220 / 22050)
        return seen

    assert arrivals(bench_serve) == arrivals(jmod)


# ---------------------------------------------------------------------------
# the streaming vocoder and the log-mel bench
# ---------------------------------------------------------------------------


@pytest.fixture
def loud_small_pipeline(monkeypatch):
    """``bench_stream``'s pipeline at the small width, HiFiGAN kernels ×15
    (an order-one waveform, so PCM16 sees real samples)."""
    init = TTSPipeline.initialize

    def initialize(config=None, *args, **kwargs):
        pipe = init(_small(), *args, **kwargs)
        with torch.no_grad():
            for name, p in pipe.model.hifigan.named_parameters():
                if name.endswith("weight"):
                    p.mul_(15.0)
        return pipe

    monkeypatch.setattr(bench_stream.TTSPipeline, "initialize",
                        staticmethod(initialize))


STREAM_ARGS = ["--frames", "300", "--chunk", "64", "--device", "cpu"]


@pytest.mark.parametrize("pcm16", [False, True])
def test_bench_stream_passes_at_the_ports_tolerance(pcm16, loud_small_pipeline,
                                                    capsys):
    out = bench_stream.main(STREAM_ARGS + (["--pcm16"] if pcm16 else []))
    line = capsys.readouterr().out.strip()
    assert out["ok"] and out["chunks"] == 5
    assert "(300 frames, chunk 64" in line and "5 chunks" in line
    if pcm16:
        assert out["err"] <= bench_stream.PCM16_LSB_LIMIT
    else:
        assert out["err"] <= bench_stream.STREAM_LIMIT


@pytest.mark.parametrize("plant", ["drop", "perturb"])
def test_bench_stream_exits_1_on_a_planted_miss(plant, loud_small_pipeline,
                                                monkeypatch, capsys):
    """A stream that drops its second chunk, or moves one sample of it by
    1e-4 of the peak, exits 1."""
    stream = TTSPipeline.vocode_streaming

    def planted(self, *args, **kwargs):
        for i, chunk in enumerate(stream(self, *args, **kwargs)):
            if i == 1:
                if plant == "drop":
                    continue
                chunk = chunk.copy()
                chunk[7] += 1e-4 * float(np.abs(chunk).max())
            yield chunk

    monkeypatch.setattr(TTSPipeline, "vocode_streaming", planted)
    with pytest.raises(SystemExit) as e:
        bench_stream.main(STREAM_ARGS)
    assert e.value.code == 1
    assert ("streamed samples" in capsys.readouterr().out) == (
        plant == "drop")


def test_bench_mel_on_the_cpu_prints_no_kernel_time(capsys):
    out = bench_mel.main(["--seconds", "0.25", "--batch", "2", "--device",
                          "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert out["single"] is None and out["batch"] is None
    assert len(lines) == 2
    assert all("needs a CUDA device" in ln and " ms" not in ln
               for ln in lines)


def test_bench_mel_inputs_are_jaxs(monkeypatch):
    """The inputs JAX's ``scripts/bench_mel.py`` hands its ``run_case``
    (four tones plus ``default_rng(0)`` noise, each batched by rolls of
    17·j samples, :52-66), captured from its ``main()``, equal
    ``make_inputs``'s."""
    jbench_mel = importlib.import_module("scripts.bench_mel")
    seen = []
    monkeypatch.setattr(jbench_mel, "run_case",
                        lambda label, arrays, cfg: seen.append(arrays))
    monkeypatch.setattr("sys.argv", ["bench_mel.py", "--seconds", "0.1",
                                     "--batch", "3"])
    jbench_mel.main()
    singles, batches = bench_mel.make_inputs(0.1, 3, tcfg.AudioConfig(),
                                             torch.device("cpu"))
    assert len(seen) == 2
    for got, want in zip((singles, batches), seen):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
