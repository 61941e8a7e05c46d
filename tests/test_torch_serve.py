"""The port's serving layer on the CPU: the dynamic batcher's grouping and
admission, the HTTP frontend, the command-line entry point, and one
waveform against the JAX package through the whole stack."""

import dataclasses
import http.client
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from iris_tts_tpu_torch.serve import (
    DynamicBatcher,
    ServerOverloadedError,
    ServerStoppedError,
    TTSServer,
)
from iris_tts_tpu_torch.serve.server import _pcm16le
from tests.test_torch_pipeline import _assert_clear_of_half
from tests.torch_port_utils import numpy_tree, port_config, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LADDERS = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128))
SENT = "the quick brown fox jumps over the lazy dog."


@pytest.fixture(scope="module")
def pipeline():
    pipe = TTSPipeline.initialize(small_config(port_cfg), device="cpu")
    return dataclasses.replace(pipe, **LADDERS)


# -- batcher ------------------------------------------------------------------


def test_batcher_single_request(pipeline):
    with DynamicBatcher(pipeline, max_batch=4, max_wait_ms=1.0) as b:
        audio = b.synthesize("hello world", timeout=120)
    assert audio.ndim == 1 and np.isfinite(audio).all()
    assert b.stats()["requests"] == 1


def test_batcher_groups_concurrent_requests(pipeline):
    """Concurrent submissions ride one (or few) batched dispatches."""
    b = DynamicBatcher(pipeline, max_batch=8, max_wait_ms=200.0)
    with b:
        b.synthesize("warm up", timeout=300)
        futs = [b.submit(f"utterance number {i}") for i in range(6)]
        outs = [f.result(timeout=300) for f in futs]
    assert all(np.isfinite(o).all() for o in outs)
    stats = b.stats()
    assert stats["requests"] == 7
    assert stats["batches"] < 7, stats
    assert max(stats["batch_size_hist"]) > 1, stats


@pytest.mark.parametrize("action", ["submit", "start"])
def test_stopped_batcher_refuses_work_and_restart(pipeline, action):
    b = DynamicBatcher(pipeline).start()
    b.stop()
    if action == "submit":
        with pytest.raises(ServerStoppedError):
            b.submit("too late")
    else:
        with pytest.raises(RuntimeError, match="cannot restart"):
            b.start()


def test_batcher_error_propagates(pipeline):
    """A failing dispatch resolves every waiter with the exception, and the
    batcher keeps serving afterwards."""
    with DynamicBatcher(pipeline, max_wait_ms=1.0) as b:
        with pytest.raises(Exception):
            b.submit("boom", temperature="not-a-number").result(timeout=120)
        audio = b.synthesize("still alive", timeout=120)
    assert np.isfinite(audio).all()


def test_dispatch_failure_fails_only_its_group(pipeline, monkeypatch):
    """A failure inside the device thread fails that group's futures and
    leaves the thread serving the next group."""
    b = DynamicBatcher(pipeline, max_wait_ms=200.0)
    inner = pipeline._batched_dispatch

    def flaky(texts, **kw):
        if any("poison" in t for t in texts):
            raise RuntimeError("device fault")
        return inner(texts, **kw)

    monkeypatch.setattr(pipeline, "_batched_dispatch", flaky)
    futs = [b.submit(f"poison {i}") for i in range(2)]
    with b:
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=120)
        assert b.healthy()
        ok = [b.submit(f"fine {i}") for i in range(2)]
        assert all(np.isfinite(f.result(timeout=120)).all() for f in ok)


def test_batcher_long_text_chunks_and_rejoins(pipeline):
    """Text past the phoneme cap is chunked inside the batch and re-joined
    with silence gaps — serving never silently truncates."""
    long_text = " ".join([SENT] * 8)
    with DynamicBatcher(pipeline, max_wait_ms=1.0, gap_ms=50.0) as b:
        audio = b.synthesize(long_text, timeout=300)
        short = b.synthesize(SENT, timeout=300)
    assert len(audio) > 2 * len(short)
    chunks = pipeline._chunk_long_text(long_text,
                                       pipeline.phoneme_buckets[-1])
    assert len(chunks) > 1
    gap = int(round(0.050 * pipeline.config.audio.sample_rate))
    outs = pipeline.synthesize(chunks, fused=False)
    # lengths (not values — seeds differ) match the join layout
    assert len(audio) == sum(len(o) for o in outs) + gap * (len(chunks) - 1)


def test_stats_latency_percentiles(pipeline):
    with DynamicBatcher(pipeline, max_wait_ms=1.0) as b:
        b.synthesize("measure me", timeout=300)
        stats = b.stats()
    lat = stats["latency_ms"]
    assert lat["p50"] is not None and lat["p50"] > 0
    assert lat["max"] >= lat["p50"]
    assert stats["healthy"] and stats["fused_overflows"] >= 0


def test_submit_rejects_oversized_request(pipeline):
    with DynamicBatcher(pipeline, max_chunks_per_request=2,
                        max_wait_ms=1.0) as b:
        with pytest.raises(ValueError, match="admission limit"):
            b.submit((SENT + " ") * 20)
        assert np.isfinite(b.synthesize("fine", timeout=300)).all()


def test_bad_arguments_fail_in_caller_not_device_thread(pipeline):
    with DynamicBatcher(pipeline, max_wait_ms=1.0) as b:
        with pytest.raises((TypeError, ValueError)):
            b.submit("boom", temperature=[1.0])
        assert b.healthy()
        assert np.isfinite(b.synthesize("alive", timeout=300)).all()


def test_batch_sizes_are_bucketed(pipeline):
    """Dispatch slices pad to power-of-two buckets (warmed shapes only)."""
    b = DynamicBatcher(pipeline, max_batch=8, max_wait_ms=200.0)
    with b:
        b.synthesize("warm", timeout=300)
        futs = [b.submit(f"number {i}") for i in range(3)]
        [f.result(timeout=300) for f in futs]
    hist = b.stats()["batch_size_hist"]
    assert set(hist) <= {1, 2, 4, 8} and 4 in hist, hist


def test_seeded_requests_dispatch_alone(pipeline):
    """The same (text, seed) yields the same audio whatever traffic shares
    the queue."""
    with DynamicBatcher(pipeline, max_wait_ms=200.0) as b:
        b.synthesize("warm", timeout=300)
        quiet = b.synthesize("repeat me", seed=42, timeout=300)
        futs = [b.submit(f"noise {i}") for i in range(4)]
        busy_fut = b.submit("repeat me", seed=42)
        [f.result(timeout=300) for f in futs]
        busy = busy_fut.result(timeout=300)
    np.testing.assert_array_equal(quiet, busy)
    np.testing.assert_array_equal(
        quiet, pipeline.synthesize("repeat me", seed=42, fused=True))


def test_device_thread_runs_in_inference_mode(pipeline, monkeypatch):
    """Autograd's mode is thread-local: the device thread turns inference
    mode on for all of its work, not only inside the pipeline's decorated
    entry points (the collect is called outside them)."""
    seen = []
    inner = pipeline._batched_collect

    def spy(handle):
        seen.append((torch.is_inference_mode_enabled(),
                     handle.audio.is_inference()))
        return inner(handle)

    monkeypatch.setattr(pipeline, "_batched_collect", spy)
    b = DynamicBatcher(pipeline, max_wait_ms=50.0)
    futs = [b.submit(f"row {i}") for i in range(2)]
    with b:
        [f.result(timeout=120) for f in futs]
    assert seen == [(True, True)]


def test_pcm16_transfer_bitwise_matches_host_quantization(pipeline):
    with DynamicBatcher(pipeline, max_wait_ms=1.0,
                        pcm16_transfer=True) as b:
        got = b.synthesize("hello world", timeout=300, seed=3)
    assert got.dtype == np.int16
    want_f = pipeline.synthesize("hello world", seed=3, fused=True)
    assert _pcm16le(got) == _pcm16le(want_f)
    np.testing.assert_array_equal(got, host_pcm16(want_f))


def test_backpressure_rejects_at_queue_limit(pipeline):
    b = DynamicBatcher(pipeline, max_queue=2)  # not started: queue only fills
    b.submit("one", seed=1)
    b.submit("two", seed=2)
    with pytest.raises(ServerOverloadedError):
        b.submit("three", seed=3)
    stats = b.stats()
    assert stats["queue_depth"] == 2 and stats["rejected"] == 1
    # continuation chunks of an admitted stream bypass the limit
    b.submit("stream tail", seed=4, bypass_admission=True)
    assert b.stats()["queue_depth"] == 3 and b.stats()["rejected"] == 1
    b.start()
    b.stop(timeout=120)
    assert b.stats()["queue_depth"] == 0


def test_adaptive_batch_grows_under_queue_depth_and_decays(pipeline):
    b = DynamicBatcher(pipeline, max_batch=2, max_batch_limit=8,
                       max_wait_ms=50.0)
    assert b._batch_buckets[-1] == 8
    futs = [b.submit(f"queued utterance {i}") for i in range(12)]
    with b:
        for f in futs:
            f.result(timeout=600)
        assert b._eff_batch > 2, b.stats()
        assert b.stats()["effective_batch"] == b._eff_batch
        grown = b._eff_batch
        for i in range(4):
            b.synthesize(f"lone request {i}", timeout=600)
        assert b._eff_batch < grown
    assert max(b.stats()["batch_size_hist"]) > 2


@pytest.mark.parametrize("max_batch, limit, buckets", [
    (4, None, [1, 2, 4]),
    (2, 8, [1, 2, 4, 8]),
    (3, None, [1, 2, 3]),
    (1, None, [1]),
])
def test_batch_buckets(pipeline, max_batch, limit, buckets):
    b = DynamicBatcher(pipeline, max_batch=max_batch, max_batch_limit=limit,
                       max_wait_ms=1.0)
    assert b._max_batch_limit == (limit or max_batch)
    assert b._batch_buckets == buckets


def test_batcher_warmup_runs_every_serving_shape(pipeline):
    b = DynamicBatcher(pipeline, max_batch=2, pcm16_transfer=True)
    n_fused = len(pipeline.fused_bucket_pairs())
    # batch 1 and 2: two stage-A shapes each, stage B at p16 {32, 64, 128}
    # and p32 {32, 64, 128}
    assert b._warmup() == n_fused + 2 * (2 + 6)


def test_start_warms_up_on_the_device_thread(pipeline, monkeypatch):
    """cuDNN's execution plans are kept per thread, so the warmup has to
    run on the thread that serves: start() runs it there and returns when
    it is done."""
    threads = []
    inner = pipeline.warmup_batched

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return inner(*a, **kw)

    monkeypatch.setattr(pipeline, "warmup_batched", spy)
    b = DynamicBatcher(pipeline, max_batch=2, max_wait_ms=1.0)
    b.start()
    try:
        assert threads == ["tts-batcher"]
        assert b.n_warmed == len(pipeline.fused_bucket_pairs()) + 16
        assert b.warmup_s > 0 and b.healthy()
        assert np.isfinite(b.synthesize("hello", timeout=120)).all()
    finally:
        b.stop()


def test_failed_warmup_raises_from_start(pipeline, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no memory")

    monkeypatch.setattr(pipeline, "warmup_fused", broken)
    b = DynamicBatcher(pipeline)
    with pytest.raises(RuntimeError, match="warmup failed") as info:
        b.start()
    assert "no memory" in str(info.value.__cause__)
    b._thread.join(timeout=30)
    assert not b.healthy() and not b._thread.is_alive()
    with pytest.raises(ServerStoppedError):
        b.submit("after a failed warmup")


class _SyncOnlyPipeline:
    """The surface an ahead-of-time pipeline gives the batcher: ``warmup()``
    and ``synthesize()``, with no fused/two-stage warmups and no
    dispatch/collect split. Each row's waveform encodes its text."""

    phoneme_buckets = (16, 32)
    config = types.SimpleNamespace(
        audio=types.SimpleNamespace(sample_rate=22050),
        hifigan=types.SimpleNamespace(total_upsample=256))

    def __init__(self):
        self.warm_threads, self.calls = [], []

    def warmup(self):
        self.warm_threads.append(threading.current_thread().name)
        return 3

    def synthesize(self, text, seed=None, temperature=1.0, fused=None,
                   pcm16=False):
        texts = [text] if isinstance(text, str) else list(text)
        self.calls.append((threading.current_thread().name, len(texts),
                           fused))
        outs = [np.full(len(t), float(len(t)), np.float32) for t in texts]
        return outs[0] if isinstance(text, str) else outs

    def _chunk_long_text(self, text, max_phonemes):
        return [text]

    def join_chunks(self, outs, gap_ms=120.0):
        return np.concatenate(outs)


def test_batcher_serves_a_pipeline_with_only_warmup_and_synthesize():
    """warmup() runs on the device thread, and a batched group is
    synthesized slice by slice on the synchronous path (fused=False),
    collected at once, each request getting its own row."""
    stub = _SyncOnlyPipeline()
    b = DynamicBatcher(stub, max_batch=4, max_wait_ms=200.0)
    texts = ["a", "bb", "ccc", "dddd", "eeeee", "ffffff"]
    futs = [b.submit(t) for t in texts]
    b.start()
    try:
        assert stub.warm_threads == ["tts-batcher"] and b.n_warmed == 3
        for t, f in zip(texts, futs):
            np.testing.assert_array_equal(f.result(timeout=60),
                                          np.full(len(t), float(len(t))))
        single = b.synthesize("seeded", seed=1, timeout=60)
        assert len(single) == len("seeded")
    finally:
        b.stop()
    assert stub.calls[:2] == [("tts-batcher", 4, False),
                              ("tts-batcher", 2, False)]
    assert stub.calls[-1] == ("tts-batcher", 1, True)
    stats = b.stats()
    assert stats["requests"] == 7
    assert stats["fused_overflows"] == stats["fused_fallbacks"] == 0


# -- HTTP ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(pipeline):
    srv = TTSServer(pipeline, host="127.0.0.1", port=0, max_wait_ms=1.0)
    srv.start()
    yield srv
    srv.stop()


def _request(server, method, path, body=None):
    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _read_chunked(resp):
    """Decode a chunked-transfer body by hand, returning the chunks."""
    chunks = []
    while True:
        size = int(resp.fp.readline().strip(), 16)
        if size == 0:
            resp.fp.readline()
            break
        chunks.append(resp.fp.read(size))
        resp.fp.readline()
    return chunks


def _wav(body):
    with wave.open(io.BytesIO(body)) as w:
        return (w.getframerate(), w.getnchannels(),
                np.frombuffer(w.readframes(w.getnframes()), "<i2"))


def test_http_healthz(server):
    status, _, body = _request(server, "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"ok": True}


def test_http_synthesize_returns_wav(server, pipeline):
    status, ctype, body = _request(server, "POST", "/synthesize",
                                   {"text": "hello server", "seed": 3})
    assert status == 200 and ctype == "audio/wav"
    rate, channels, pcm = _wav(body)
    assert rate == pipeline.config.audio.sample_rate and channels == 1
    assert len(pcm) > 0 and len(pcm) % pipeline.config.audio.hop_length == 0
    np.testing.assert_array_equal(
        pcm, host_pcm16(pipeline.synthesize("hello server", seed=3)))


@pytest.mark.parametrize("method, path, body, code", [
    ("POST", "/synthesize", {"text": ""}, 400),
    ("POST", "/synthesize", {"text": 7}, 400),
    ("POST", "/synthesize", {"text": "x", "temperature": "hot"}, 400),
    ("POST", "/nope", {"text": "x"}, 404),
    ("GET", "/nope", None, 404),
    ("POST", "/synthesize_stream", {"text": ""}, 400),
])
def test_http_bad_requests(server, method, path, body, code):
    assert _request(server, method, path, body)[0] == code


def test_http_concurrent_clients_batch(server):
    results = [None] * 5

    def hit(i):
        results[i] = _request(server, "POST", "/synthesize",
                              {"text": f"client {i} speaking"})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert all(r is not None and r[0] == 200 for r in results)
    status, _, body = _request(server, "GET", "/stats")
    assert status == 200 and json.loads(body)["requests"] >= 5


def test_healthz_unhealthy_after_stop(pipeline):
    srv = TTSServer(pipeline, host="127.0.0.1", port=0, max_wait_ms=1.0)
    srv.start()
    try:
        assert _request(srv, "GET", "/healthz")[0] == 200
        srv.batcher.stop()
        status, _, body = _request(srv, "GET", "/healthz")
        assert status == 503 and json.loads(body) == {"ok": False}
        status, _, _ = _request(srv, "POST", "/synthesize", {"text": "hi"})
        assert status == 503  # draining replica: retryable
    finally:
        srv.httpd.shutdown()
        srv.httpd.server_close()


def test_http_streaming_synthesis(server, pipeline):
    """/synthesize_stream: PCM16LE chunk by chunk; the layout matches the
    chunker, with silence gaps of the documented length."""
    long_text = " ".join([SENT] * 8)
    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request("POST", "/synthesize_stream",
                 body=json.dumps({"text": long_text, "seed": 5}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("X-Audio-Format").startswith("pcm16le")
    chunks = _read_chunked(resp)
    conn.close()
    text_chunks = pipeline._chunk_long_text(long_text,
                                            pipeline.phoneme_buckets[-1])
    assert len(chunks) == 2 * len(text_chunks) - 1
    gap = int(round(0.120 * pipeline.config.audio.sample_rate))
    for i, c in enumerate(chunks):
        pcm = np.frombuffer(c, "<i2")
        if i % 2:
            assert len(pcm) == gap and not pcm.any()
        else:  # chunk i/2 with the derived seed 5 + i/2
            want = pipeline.synthesize(text_chunks[i // 2], seed=5 + i // 2,
                                       fused=True)
            np.testing.assert_array_equal(pcm, host_pcm16(want))


def test_http_streaming_standard_client_dechunks(server, pipeline):
    """HTTP/1.1, so a standard client's read() de-chunks the body."""
    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request("POST", "/synthesize_stream",
                 body=json.dumps({"text": "hello there. nice day."}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.version == 11
    body = resp.read()
    conn.close()
    assert len(body) % 2 == 0 and len(body) > 0
    pcm = np.frombuffer(body, "<i2").astype(np.float32) / 32767.0
    assert np.isfinite(pcm).all() and np.abs(pcm).max() <= 1.0
    status, _, wav_body = _request(server, "POST", "/synthesize",
                                   {"text": "hello there. nice day."})
    assert status == 200
    base = len(_wav(wav_body)[2])
    gap = int(round(0.120 * pipeline.config.audio.sample_rate))
    assert abs(len(pcm) - base) <= gap * 4


# A held chunk waits this long for the client's first read, longer than the
# client waits for that read: a stream that holds its first audio back fails
# on the client's timeout instead of hanging.
TTFA_CLIENT_WAIT_S = 60.0
TTFA_HOLD_S = 120.0


def test_streaming_ttfa_is_one_chunk_not_whole_text(server, pipeline,
                                                    monkeypatch):
    """Time to first audio of a multi-sentence stream is one chunk's
    synthesis, not the whole text's: every chunk after the first is held
    on the device thread until the client has read the first audio chunk,
    so a stream that waited for the whole text could never deliver it (the
    client's read times out). The order of events is checked, not the host
    clock; /stats reports the TTFA."""
    long_text = " ".join([SENT] * 5)
    n_chunks = len(pipeline._chunk_long_text(long_text,
                                             pipeline.phoneme_buckets[-1]))
    assert n_chunks >= 4
    seed = 9000  # chunk i of the stream synthesizes with seed + i
    first_read = threading.Event()
    held = []  # (later chunks' seeds in a dispatch, released by the read)
    dispatch = server.batcher._dispatch

    def hold_later_chunks(group):
        later = [it.seed for it in group
                 if it.seed is not None and it.seed > seed]
        if later:
            held.append((later, first_read.wait(TTFA_HOLD_S)))
        dispatch(group)

    monkeypatch.setattr(server.batcher, "_dispatch", hold_later_chunks)
    host, port = server.address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=TTFA_CLIENT_WAIT_S)
    try:
        conn.request("POST", "/synthesize_stream",
                     body=json.dumps({"text": long_text, "seed": seed}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        size = int(resp.fp.readline().strip(), 16)
        first = resp.fp.read(size)
        resp.fp.readline()
        # the first audio is here while no later chunk has been released
        assert not held, held
        first_read.set()
        rest = _read_chunked(resp)
    finally:
        first_read.set()
        conn.close()
    assert len(first) > 0
    assert len(rest) == 2 * n_chunks - 2
    # every later chunk went through a held dispatch, released by the read
    assert sorted(s for seeds, _ in held for s in seeds) == list(
        range(seed + 1, seed + n_chunks))
    assert all(released for _, released in held), held
    stats = server.batcher.stats()
    assert stats["ttfa_ms"]["p50"] is not None
    assert stats["ttfa_ms"]["p50"] <= stats["ttfa_ms"]["max"]


def test_stream_completes_under_queue_pressure(pipeline):
    """An admitted stream finishes every sentence while competing traffic
    saturates the admission limit; competitors get 200 or a clean 503."""
    srv = TTSServer(pipeline, host="127.0.0.1", port=0, max_wait_ms=1.0,
                    max_queue=1)
    srv.start()
    try:
        srv.batcher.synthesize("warm", timeout=300)
        text = " ".join([SENT] * 3)
        n_chunks = len(srv.batcher.chunk_text(text))
        assert n_chunks >= 3
        host, port = srv.address[:2]
        codes = []

        def compete():
            for _ in range(4):
                c = http.client.HTTPConnection(host, port, timeout=300)
                try:
                    c.request("POST", "/synthesize",
                              body=json.dumps({"text": "contender"}),
                              headers={"Content-Type": "application/json"})
                    r = c.getresponse()
                    r.read()
                    codes.append(r.status)
                finally:
                    c.close()

        threads = [threading.Thread(target=compete) for _ in range(4)]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request("POST", "/synthesize_stream",
                         body=json.dumps({"text": text, "seed": 1}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            for t in threads:
                t.start()
            chunks = _read_chunked(resp)
            assert len(chunks) == 2 * n_chunks - 1
            assert all(len(c) > 0 for c in chunks)
        finally:
            conn.close()
            for t in threads:
                t.join(timeout=300)
        assert codes and set(codes) <= {200, 503}
    finally:
        srv.stop()


def test_http_hostile_request_framing(server):
    """Negative Content-Length, non-object JSON and oversize bodies get a
    fast clean error, and the server keeps answering."""
    host, port = server.address[:2]
    raw = socket.create_connection((host, port), timeout=20)
    try:
        raw.sendall(
            b"POST /synthesize HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\nContent-Length: -1\r\n\r\n")
        head = raw.recv(64)
        assert b"400" in head.split(b"\r\n")[0], head
    finally:
        raw.close()
    for path, body in (("/synthesize", b"null"), ("/synthesize", b'"hello"'),
                       ("/synthesize", b"[1, 2]"), ("/synthesize", b"{bad"),
                       ("/synthesize_stream", b"[1]")):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 400, (path, body, resp.status)
        finally:
            conn.close()
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        try:
            conn.request("POST", "/synthesize", body=b"x" * (2 << 20),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 413
        except (BrokenPipeError, ConnectionResetError,
                http.client.HTTPException):
            pass  # the server closed while the body was still being sent
    finally:
        conn.close()
    assert _request(server, "GET", "/healthz")[0] == 200


def test_stats_concurrent_with_traffic(server):
    errs = []

    def poll():
        for _ in range(20):
            st, _, body = _request(server, "GET", "/stats")
            if st != 200:
                errs.append((st, body))

    t = threading.Thread(target=poll)
    t.start()
    for i in range(3):
        _request(server, "POST", "/synthesize", {"text": f"stats probe {i}"})
    t.join(timeout=120)
    assert not t.is_alive() and not errs, errs


def test_server_stop_before_start_does_not_hang(pipeline):
    srv = TTSServer(pipeline, host="127.0.0.1", port=0)
    done = threading.Event()

    def stop():
        srv.stop()
        done.set()

    threading.Thread(target=stop, daemon=True).start()
    assert done.wait(timeout=30), "stop() deadlocked without start()"


# -- parity with the JAX package through the server ----------------------------


def test_http_wav_matches_jax_synthesize():
    """A /synthesize WAV at temperature 0 decodes to the JAX pipeline's
    synthesize of the same text with the same weights, within one PCM16
    step."""
    jpipe = JPipeline.initialize(small_config(), seed=3)
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    ladders = dict(phoneme_buckets=(16, 32, 64),
                   frame_buckets=(16, 32, 64, 128, 256, 512))
    jpipe = dataclasses.replace(jpipe, **ladders)
    pipe = dataclasses.replace(TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu"),
        **ladders)
    text = "Hello world, this is a test."
    _assert_clear_of_half(jpipe, [text])
    want = jpipe.synthesize(text, temperature=0.0)
    assert float(np.abs(want).max()) > 0.05
    # one request takes the fused path: batch bucket 1 is all start() warms
    srv = TTSServer(pipe, host="127.0.0.1", port=0, max_batch=1,
                    max_wait_ms=1.0)
    srv.start()
    try:
        status, ctype, body = _request(srv, "POST", "/synthesize",
                                       {"text": text, "temperature": 0.0})
    finally:
        srv.stop()
    assert status == 200 and ctype == "audio/wav"
    pcm = _wav(body)[2]
    assert len(pcm) == len(want)
    assert int(np.abs(pcm.astype(np.int32) - host_pcm16(want)).max()) <= 1


# -- python -m iris_tts_tpu_torch.serve ----------------------------------------


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_cli_help_and_missing_source():
    r = subprocess.run([sys.executable, "-m", "iris_tts_tpu_torch.serve",
                        "--help"], cwd=REPO, env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0
    for flag in ("--pipeline", "--random_weights", "--config", "--device",
                 "--max_batch_limit", "--max_queue", "--float_transfer",
                 "--aot", "--mesh"):
        assert flag in r.stdout, flag
    r = subprocess.run([sys.executable, "-m", "iris_tts_tpu_torch.serve"],
                       cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2 and "--random_weights" in r.stderr


def test_cli_serves_a_saved_pipeline(pipeline, tmp_path):
    """The entry point loads a saved pipeline, warms every serving shape on
    the device thread, answers requests and stops cleanly on SIGINT."""
    pipeline.save(tmp_path / "pipe")
    proc = subprocess.Popen(
        [sys.executable, "-m", "iris_tts_tpu_torch.serve", "--pipeline",
         str(tmp_path / "pipe"), "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max_batch", "2"],
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
        n_shapes = len(pipeline.fused_bucket_pairs()) + 16
        assert any(f"warmup: {n_shapes} shapes (batch buckets [1, 2]) on "
                   "the device thread" in ln for ln in log), "".join(log)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/synthesize",
                     body=json.dumps({"text": "hello", "seed": 1}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 200
        np.testing.assert_array_equal(
            _wav(body)[2],
            pipeline.synthesize("hello", seed=1, fused=True, pcm16=True))
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stderr.close()
    assert rc == 0
