"""The port's ahead-of-time serving path on the CPU at a small width:
``torch.export`` programs per (batch, phoneme) bucket, ``ExportedSynthesizer``
and ``AotPipeline`` against the port's live fused path (at temperature 1 as
well as 0: the prior noise is an input of the programs) and, at temperature
0, against the JAX package's ``AotPipeline`` with the same weights."""

import dataclasses
import http.client
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.models import pipeline as tpipeline
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from iris_tts_tpu_torch.ops.length import (
    durations_from_log,
    length_regulate,
    padding_mask,
)
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.serve import TTSServer
from iris_tts_tpu_torch.serve import export as texport
from iris_tts_tpu_torch.serve.export import (
    AotPipeline,
    ExportedSynthesizer,
    export_pipeline,
)
from tests.test_torch_pipeline import _assert_clear_of_half, _assert_same_audio
from tests.torch_port_utils import numpy_tree, port_config, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LADDERS = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128, 256, 512))
TEXTS = ["first utterance", "the second one", "third"]


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline.initialize(small_config(), seed=3)
    # Random HiFiGAN weights give near-silent audio at this width; scale the
    # kernels so the comparisons see order-one signal.
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **LADDERS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    return jpipe, dataclasses.replace(pipe, **LADDERS)


@pytest.fixture(scope="module")
def pipeline(pipes):
    return pipes[1]


@pytest.fixture(scope="module")
def artifact_dir(pipeline, tmp_path_factory):
    out = tmp_path_factory.mktemp("aot")
    export_pipeline(pipeline, out, batch_sizes=(1, 4),
                    phoneme_buckets=(16, 32), vocode_chunk_frames=16)
    return out


@pytest.fixture(scope="module")
def aot(pipeline, artifact_dir):
    pipe = AotPipeline(artifact_dir, text_processor=pipeline.text_processor,
                       device="cpu")
    pipe.warmup()
    return pipe


@pytest.fixture(scope="module")
def synth(pipeline, artifact_dir):
    return ExportedSynthesizer(artifact_dir,
                               text_processor=pipeline.text_processor,
                               device="cpu")


def _subset(artifact_dir, dest, keep=("synth_b1_p16.pt2",), **manifest_kw):
    """A copy of the artifact with only the programs in ``keep`` (loads
    in a second) and manifest fields replaced by ``manifest_kw``."""
    dest.mkdir()
    manifest = json.loads((artifact_dir / "manifest.json").read_text())
    manifest["entries"] = [e for e in manifest["entries"]
                           if e["file"] in keep]
    if manifest["vocode_window"]["file"] not in keep:
        del manifest["vocode_window"]
    manifest.update(manifest_kw)
    for f in list(keep) + ["vocab.json"]:
        shutil.copy(artifact_dir / f, dest / f)
    (dest / "manifest.json").write_text(json.dumps(manifest))
    return dest


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 0.05, peak  # a real signal is compared
    return float(np.abs(got - want).max()) / peak


# -- export ---------------------------------------------------------------------


def test_export_writes_artifacts(artifact_dir, pipeline):
    manifest = json.loads((artifact_dir / "manifest.json").read_text())
    assert manifest["format_version"] == texport.AOT_FORMAT_VERSION
    assert manifest["sample_rate"] == 22050
    assert manifest["device"] == "cpu" and manifest["id_dtype"] == "int64"
    assert manifest["upsample"] == "hard"
    assert manifest["frame_buckets"] == list(LADDERS["frame_buckets"])
    files = {e["file"] for e in manifest["entries"]}
    assert files == {f"synth_b{b}_p{p}.pt2" for b in (1, 4) for p in (16, 32)}
    for e in manifest["entries"]:
        assert (artifact_dir / e["file"]).stat().st_size == e["bytes"] > 1000
        assert e["frame_bucket"] == pipeline._fused_frame_budget(
            np.full(e["batch"], e["phoneme_bucket"]))
    assert (artifact_dir / "vocab.json").exists()


def test_live_frame_budget_is_the_pipelines(artifact_dir, pipeline):
    """The noise budget computed from the manifest's ladder equals the live
    path's for every length the buckets take."""
    manifest = json.loads((artifact_dir / "manifest.json").read_text())
    for n in range(1, 33):
        assert texport.live_frame_budget(manifest, n) == \
            pipeline._fused_frame_budget(np.asarray([n]))


def test_exported_matches_pipeline(pipeline, synth):
    """The loaded program reproduces the live fused path: the bucket's
    budget (256 frames) is not the live one (128), but the live path's
    noise fills the front of the program's noise input."""
    got = synth.synthesize("hello world", seed=5)
    want = pipeline.synthesize("hello world", seed=5, fused=True)
    assert _rel(got, want) <= 1e-6


def test_exported_bucket_overflow_raises(synth):
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        synth.synthesize("word " * 40)


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_export_cli(tmp_path):
    """python -m iris_tts_tpu_torch.serve.export end to end (subprocess)."""
    port_cfg.save_config(small_config(port_cfg), tmp_path / "cfg.json")
    r = subprocess.run(
        [sys.executable, "-m", "iris_tts_tpu_torch.serve.export",
         "--random_weights", "--config", str(tmp_path / "cfg.json"),
         "--output", str(tmp_path / "aot"), "--batch_sizes", "1",
         "--phoneme_buckets", "16", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "aot" / "synth_b1_p16.pt2").exists()
    audio = ExportedSynthesizer(tmp_path / "aot",
                                device="cpu").synthesize("hi", seed=1)
    assert audio.ndim == 1 and audio.size and np.isfinite(audio).all()


def test_exported_temperature_input(pipeline, synth):
    """Temperature is an input of the program: 0 and 1 differ, and 0
    matches the live path at 0."""
    hot = synth.synthesize("hello world", seed=5, temperature=1.0)
    cold = synth.synthesize("hello world", seed=5, temperature=0.0)
    assert hot.shape == cold.shape and not np.allclose(hot, cold)
    want = pipeline.synthesize("hello world", seed=5, temperature=0.0,
                               fused=True)
    assert _rel(cold, want) <= 1e-6


# -- AotPipeline ----------------------------------------------------------------


@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_aot_pipeline_matches_live(pipeline, aot, temperature):
    """One sentence and a batch of 3 (in the B=4 program) equal the live
    fused path within 1e-6 of the peak."""
    got = aot.synthesize("hello world", seed=5, temperature=temperature)
    want = pipeline.synthesize("hello world", seed=5, fused=True,
                               temperature=temperature)
    assert _rel(got, want) <= 1e-6
    got_b = aot.synthesize(TEXTS, seed=9, temperature=temperature)
    want_b = pipeline.synthesize(TEXTS, seed=9, fused=True,
                                 temperature=temperature)
    assert len(got_b) == 3
    for a, b in zip(got_b, want_b):
        assert _rel(a, b) <= 1e-6
    mel_got = aot.synthesize("hello world", seed=5, return_mel=True,
                             temperature=temperature)[1]
    mel_want = pipeline.synthesize("hello world", seed=5, fused=True,
                                   return_mel=True, temperature=temperature)[1]
    assert mel_got.shape == mel_want.shape
    np.testing.assert_allclose(mel_got, mel_want, atol=1e-4)
    pcm = aot.synthesize("hello world", seed=5, temperature=temperature,
                         pcm16=True)
    np.testing.assert_array_equal(pcm, host_pcm16(got))


def test_a_mutated_noise_prefix_breaks_the_match(pipeline, aot, monkeypatch):
    """The match at temperature 1 rests on the noise prefix: one changed
    latent frame of it moves the audio far past the 1e-6 contract."""
    want = pipeline.synthesize("hello world", seed=5, fused=True)
    draw = texport.prior_noise

    def mutated(*a, **kw):
        eps = draw(*a, **kw)
        eps[:, :, 1] += 1.0
        return eps

    monkeypatch.setattr(texport, "prior_noise", mutated)
    assert _rel(aot.synthesize("hello world", seed=5), want) > 1e-3


def test_noise_in_the_padded_tail_is_masked(pipeline, aot, monkeypatch):
    """Frames past the live budget are masked: random noise there instead
    of zeros leaves the kept audio within the contract (here the kept
    frames end far more than a receptive field before the live budget)."""
    want = pipeline.synthesize("hello world", seed=5, fused=True)
    fill = texport._fill_synth_inputs

    def noisy_tail(bufs, ids, lengths, noise, temperature):
        fill(bufs, ids, lengths, noise, temperature)
        eps = bufs[2]
        tail = torch.randn(eps[:, :, noise.shape[2]:].shape,
                           generator=torch.Generator().manual_seed(1))
        eps[:, :, noise.shape[2]:] = tail

    monkeypatch.setattr(texport, "_fill_synth_inputs", noisy_tail)
    assert _rel(aot.synthesize("hello world", seed=5), want) <= 1e-6


def test_aot_pipeline_matches_jax_aot_pipeline(pipes, artifact_dir,
                                               tmp_path):
    """The JAX package's AotPipeline and the port's, exported from the same
    weights, agree at temperature 0 within the port's synthesis contract."""
    from iris_tts_tpu.serve.export import AotPipeline as JAotPipeline
    from iris_tts_tpu.serve.export import export_pipeline as jexport

    jpipe, pipe = pipes
    text = "Hello world, this is a test."
    _assert_clear_of_half(jpipe, [text])
    jexport(jpipe, tmp_path / "jax_aot", batch_sizes=(1,),
            phoneme_buckets=(32,))
    jaot = JAotPipeline(tmp_path / "jax_aot",
                        text_processor=jpipe.text_processor)
    taot = AotPipeline(_subset(artifact_dir, tmp_path / "port_aot",
                               keep=("synth_b1_p32.pt2",)),
                       text_processor=pipe.text_processor, device="cpu")
    _assert_same_audio(taot.synthesize(text, temperature=0.0),
                       jaot.synthesize(text, temperature=0.0))


def test_aot_pipeline_behind_full_serving_stack(pipeline, aot):
    """TTSServer → DynamicBatcher over the artifact: WAV, stream, stats,
    and a seeded WAV equal to AotPipeline.synthesize."""
    srv = TTSServer(aot, host="127.0.0.1", port=0, max_batch=4,
                    max_wait_ms=1.0)
    srv.start()
    try:
        host, port = srv.address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": "hello world", "seed": 5}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        with wave.open(io.BytesIO(resp.read())) as w:
            assert w.getframerate() == 22050
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        np.testing.assert_array_equal(
            pcm, aot.synthesize("hello world", seed=5, pcm16=True))
        conn.request("POST", "/synthesize_stream",
                     body=json.dumps({"text": "hello. world."}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        data = resp.read()
        assert len(data) > 0 and len(data) % 2 == 0
        conn.close()
        stats = srv.batcher.stats()
        assert stats["requests"] >= 2 and stats["healthy"]
        assert stats["fused_fallbacks"] == 0
    finally:
        srv.stop()


def test_serve_cli_aot_boots_and_answers(artifact_dir):
    """python -m iris_tts_tpu_torch.serve --aot boots, clamps the batch to
    the largest exported bucket, answers, and stops on SIGINT."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "iris_tts_tpu_torch.serve", "--aot",
         str(artifact_dir), "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max_batch", "8"],
        cwd=REPO, env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        log, port = [], None
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            log.append(line)
            m = re.search(r"serving on [\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(log)
        assert any("clamping max_batch 8 -> 4" in ln for ln in log)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/synthesize", body=json.dumps({"text": "hello"}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read(4) == b"RIFF"
        conn.close()
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stderr.close()
    assert rc == 0


def test_progressive_warmup(pipeline, artifact_dir, tmp_path):
    """warmup(block=False) returns after the smallest bucket; the rest warm
    on a daemon thread while requests are served; block=True warms all."""
    small = _subset(artifact_dir, tmp_path / "small",
                    keep=("synth_b1_p16.pt2", "synth_b4_p16.pt2"))
    pipe = AotPipeline(small, text_processor=pipeline.text_processor,
                       device="cpu")
    assert pipe.warmup(block=False) == 1
    out = pipe.synthesize(TEXTS, seed=3)
    assert all(o.size and np.isfinite(o).all() for o in out)
    deadline = time.time() + 120
    while not pipe.warm_all_done() and time.time() < deadline:
        time.sleep(0.05)
    assert pipe.warm_all_done() and not pipe.warmup_errors
    assert pipe._ready == set(pipe._programs)
    assert pipe.warmup() == 0  # the first call decides
    blocking = AotPipeline(small, text_processor=pipeline.text_processor,
                           device="cpu")
    assert blocking.warmup(block=True) == len(blocking._programs) == 2
    assert blocking.warm_all_done()


def test_a_warm_bucket_does_not_wait_for_a_capture(pipeline, artifact_dir,
                                                   tmp_path, monkeypatch):
    """Capture and replay take separate locks: while the background thread
    is held inside another bucket's capture, a request to the bucket
    captured first returns (the old single lock made it wait for the
    capture to end)."""
    small = _subset(artifact_dir, tmp_path / "small",
                    keep=("synth_b1_p16.pt2", "synth_b4_p16.pt2"))
    pipe = AotPipeline(small, text_processor=pipeline.text_processor,
                       device="cpu")
    capture = AotPipeline._capture
    in_capture, release = threading.Event(), threading.Event()

    def slow_capture(self, prog):
        if self._ready:  # every capture after the first bucket's
            in_capture.set()
            assert release.wait(120)
        capture(self, prog)

    monkeypatch.setattr(AotPipeline, "_capture", slow_capture)
    assert pipe.warmup(block=False) == 1
    assert in_capture.wait(60)
    out = {}
    request = threading.Thread(
        target=lambda: out.update(audio=pipe.synthesize("third", seed=3)))
    try:
        request.start()
        request.join(60)
        finished = not request.is_alive()
        capture_in_flight = not pipe.warm_all_done()
    finally:
        release.set()
        request.join(60)
    assert finished and capture_in_flight
    assert out["audio"].size and np.isfinite(out["audio"]).all()
    deadline = time.time() + 120
    while not pipe.warm_all_done() and time.time() < deadline:
        time.sleep(0.05)
    assert pipe.warm_all_done() and not pipe.warmup_errors


def test_a_cold_bucket_waits_for_one_capture_not_all(pipeline, artifact_dir,
                                                     tmp_path, monkeypatch):
    """A request to a bucket not captured yet waits for the capture in
    flight and then captures its own; it does not wait behind the
    background warmup's remaining captures (the background thread lets
    waiting requests go first)."""
    small = _subset(artifact_dir, tmp_path / "small",
                    keep=("synth_b1_p16.pt2", "synth_b1_p32.pt2",
                          "synth_b4_p16.pt2", "synth_b4_p32.pt2"))
    pipe = AotPipeline(small, text_processor=pipeline.text_processor,
                       device="cpu")
    capture = AotPipeline._capture
    order = []

    def slow_capture(self, prog):
        key = next(k for k, v in self._programs.items() if v is prog)
        order.append(key)
        if len(order) > 1:
            time.sleep(0.5)
        capture(self, prog)

    monkeypatch.setattr(AotPipeline, "_capture", slow_capture)
    assert pipe.warmup(block=False) == 1
    while len(order) < 2:  # the background thread is capturing (1, 32)
        time.sleep(0.01)
    out = pipe.synthesize(["the second one", "third"], seed=3)  # (4, 16)
    left = not pipe.warm_all_done()
    assert len(out) == 2 and all(o.size for o in out)
    assert order[:3] == [(1, 16), (1, 32), (4, 16)] and left
    deadline = time.time() + 120
    while not pipe.warm_all_done() and time.time() < deadline:
        time.sleep(0.05)
    assert pipe.warm_all_done() and order[3:] == [(4, 32)]


def test_bf16_export_matches_the_live_bf16_function(pipeline, tmp_path):
    """A bf16 pipeline exports bf16 programs: the manifest records the
    dtype, the noise input is bf16 (the live path's noise), the program
    equals the live bf16 fused function at the bucket's shapes bitwise,
    and ``AotPipeline`` over it returns f32 audio equal to the live bf16
    ``synthesize`` at the same frame budget."""
    pipe16 = dataclasses.replace(pipeline, dtype=torch.bfloat16)
    out = export_pipeline(pipe16, tmp_path / "aot16", batch_sizes=(1,),
                          phoneme_buckets=(16,))
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["dtype"] == "bfloat16"
    aot = AotPipeline(out, text_processor=pipeline.text_processor,
                      device="cpu")
    assert aot.dtype == torch.bfloat16
    aot.warmup()
    prog = aot._programs[(1, 16)]
    ids_t, len_t, eps_t, temp_t = prog.inputs
    assert eps_t.dtype == torch.bfloat16
    entry = aot._entries[(1, 16)]
    ids = pipeline._encode_texts(["the second one"])[0][:, :16]
    lengths = np.array([int((ids[0] != pipeline.vocab.pad_id).sum())])
    ids_t.copy_(torch.from_numpy(ids))
    len_t.copy_(torch.from_numpy(lengths))
    eps_t.copy_(pipe16._prior_noise(1, entry["frame_bucket"], 5))
    temp_t.fill_(0.8)
    got = prog.run()
    with torch.inference_mode():
        want = tpipeline.fused_synthesis(
            pipe16.model, torch.from_numpy(ids), torch.from_numpy(lengths),
            pipe16._prior_noise(1, entry["frame_bucket"], 5), 0.8,
            entry["frame_bucket"], pipe16.use_postnet, pipe16.upsample)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # The public API: f32 audio, the live path at the bucket's budget.
    text = "a " * 14  # 14+ phonemes: the live budget is the bucket's
    n = len(pipe16.text_processor.text_to_ids(text, pipe16.vocab))
    assert pipe16._fused_frame_budget(np.array([n])) == entry["frame_bucket"]
    a = aot.synthesize(text, seed=4, temperature=0.0)
    b = pipe16.synthesize(text, seed=4, temperature=0.0, fused=True)
    assert a.dtype == np.float32 and np.array_equal(a, b)


def test_process_exits_cleanly_during_background_warmup(artifact_dir):
    """A process that ends while the background thread is still warming
    exits with 0: interpreter shutdown under a daemon thread running torch
    work aborts the process."""
    code = ("import sys\n"
            "from iris_tts_tpu_torch.serve.export import AotPipeline\n"
            "AotPipeline(sys.argv[1], device='cpu').warmup(block=False)\n")
    r = subprocess.run([sys.executable, "-c", code, str(artifact_dir)],
                       cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_warmup_async_constructor_overlap(artifact_dir, tmp_path):
    """warmup_async=True starts every capture on the warmup thread from the
    constructor and builds the text frontend meanwhile."""
    pipe = AotPipeline(_subset(artifact_dir, tmp_path / "small",
                               keep=("synth_b1_p16.pt2", "synth_b1_p32.pt2")),
                       warmup_async=True, device="cpu")
    assert pipe.text_processor is not None
    out = pipe.synthesize("hello world", seed=3)
    assert out.size and np.isfinite(out).all()
    deadline = time.time() + 120
    while not pipe.warm_all_done() and time.time() < deadline:
        time.sleep(0.05)
    assert pipe.warm_all_done()


def test_aot_vocode_streaming_matches_live(pipeline, aot, artifact_dir):
    """The window program reproduces the live streaming vocoder."""
    vw = json.loads((artifact_dir / "manifest.json").read_text()
                    )["vocode_window"]
    assert vw["chunk_frames"] == 16
    assert (artifact_dir / vw["file"]).stat().st_size > 1000
    rng = np.random.default_rng(3)
    mel = rng.normal(-3.0, 2.0, size=(70, 80)).astype(np.float32)
    got = np.concatenate(list(aot.vocode_streaming(mel)))
    live = np.concatenate(list(pipeline.vocode_streaming(
        mel, chunk_frames=16, context_frames=vw["context_frames"])))
    assert _rel(got, live) <= 1e-6
    assert _rel(got, pipeline.vocode(mel)) <= 1e-5
    pcm = np.concatenate(list(aot.vocode_streaming(mel.T, pcm16=True)))
    np.testing.assert_array_equal(pcm, host_pcm16(got))


def test_aot_vocode_streaming_guards(pipeline, aot, artifact_dir, tmp_path):
    with pytest.raises(ValueError, match="frames <= the exported window"):
        list(aot.vocode_streaming(np.zeros((10, 80), np.float32)))
    no_win = AotPipeline(_subset(artifact_dir, tmp_path / "no_win"),
                         text_processor=pipeline.text_processor, device="cpu")
    with pytest.raises(RuntimeError, match="without a streaming-vocoder"):
        list(no_win.vocode_streaming(np.zeros((100, 80), np.float32)))


# -- the port's own checks --------------------------------------------------------


def test_wrong_format_version_is_refused(artifact_dir, tmp_path):
    old = _subset(artifact_dir, tmp_path / "old", format_version=0)
    with pytest.raises(ValueError, match="re-export with python -m "
                                         "iris_tts_tpu_torch.serve.export"):
        AotPipeline(old, device="cpu")


def test_serving_needs_no_model_code(pipeline, artifact_dir, tmp_path,
                                     monkeypatch):
    """Loading and serving the artifact builds none of the port's model
    modules: every computation comes from the saved programs."""
    from iris_tts_tpu_torch.models.encoder import PhonemeEncoder
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.vae import TextConditionedVAE

    want = pipeline.synthesize("hello world", seed=5, fused=True)

    def refuse(self, *a, **kw):
        raise AssertionError(f"built {type(self).__name__}")

    for cls in (tpipeline.SynthesisModel, PhonemeEncoder, TextConditionedVAE,
                HiFiGANGenerator):
        monkeypatch.setattr(cls, "__init__", refuse)
    with pytest.raises(AssertionError, match="built SynthesisModel"):
        tpipeline.SynthesisModel(pipeline.config)
    pipe = AotPipeline(
        _subset(artifact_dir, tmp_path / "sub",
                keep=("synth_b1_p16.pt2", "vocwin_c16_x9.pt2")),
        text_processor=pipeline.text_processor, device="cpu")
    pipe.warmup()
    assert _rel(pipe.synthesize("hello world", seed=5), want) <= 1e-6
    mel = np.random.default_rng(0).normal(-3, 2, (70, 80)).astype(np.float32)
    assert len(list(pipe.vocode_streaming(mel)))


def test_a_program_exported_on_another_device_type_is_moved(
        pipeline, artifact_dir, tmp_path):
    """A manifest naming another device type than the loader's goes
    through ``move_to_device_pass`` (here onto the CPU it already uses)."""
    moved = _subset(artifact_dir, tmp_path / "moved", device="cuda")
    synth = ExportedSynthesizer(moved, text_processor=pipeline.text_processor,
                                device="cpu")
    want = pipeline.synthesize("hello world", seed=5, fused=True)
    assert _rel(synth.synthesize("hello world", seed=5), want) <= 1e-6


@pytest.mark.parametrize("start", [0, 1, 700, 1536, 5000])
def test_window_gather_equals_the_slice(start):
    """The window program's gather is bitwise the slice of the live
    window stage; a start past the end clamps as a dynamic slice does."""
    audio = torch.randn(1, 2048, generator=torch.Generator().manual_seed(0))
    got = texport.window_cut(audio, torch.tensor(start), 512)
    s = min(start, 2048 - 512)
    assert torch.equal(got, audio[:, s:s + 512])


def _fused_device_before(pipe, ids_np, lengths_np, t_bucket, seed, temp):
    """The live fused path as it was before it shared its body with the
    exported programs: stage A, compression, length regulation, the VAE's
    own prior draw from the seeded generator, PostNet, HiFiGAN."""
    ids, lengths = torch.from_numpy(ids_np), torch.from_numpy(lengths_np)
    model = pipe.model
    mask = padding_mask(lengths, ids.shape[1])
    enc = model.encoder(ids, padding_mask=mask)
    frames = durations_from_log(model.duration(enc)).to(torch.int64) * mask
    frames, deficit = tpipeline.compress_durations(frames, t_bucket)
    cond, frame_mask = length_regulate(enc, frames, t_bucket)
    mel, _ = model.vae.generate(cond, temperature=temp,
                                generator=seeded_generator(seed, "cpu"))
    mel = model.postnet(mel)
    return model.hifigan(mel), mel, (frame_mask > 0).sum(dim=1), deficit


@torch.inference_mode()
def test_refactored_live_fused_path_is_bitwise_the_old_one(pipeline):
    ids, lengths = pipeline._encode_texts(TEXTS)
    disp, deficit = pipeline._fused_device(ids, lengths, 256, 7, 1.0, False,
                                           return_mel=True)
    audio, mel, n_frames, want_deficit = _fused_device_before(
        pipeline, ids, lengths, 256, 7, 1.0)
    assert torch.equal(disp.audio, audio)
    assert torch.equal(disp.mel, mel)
    assert torch.equal(disp.n_frames, n_frames)
    assert torch.equal(deficit, want_deficit)
