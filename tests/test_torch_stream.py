"""Port parity for streaming vocoding, long text, warmup and the batched
dispatch/collect split: the PyTorch TTSPipeline against the JAX one with the
same weights, on the CPU, at a small width. Waveforms are compared at
temperature 0, where the prior sample is exactly zero in both packages."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import iris_tts_tpu.config as jcfg
from iris_tts_tpu.models import hifigan as jhifigan
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.data.audio_io import read_wav
from iris_tts_tpu_torch.models import hifigan as thifigan
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from tests.test_pipeline import _small_config as jax_tiny_config
from tests.test_torch_pipeline import _assert_clear_of_half
from tests.torch_port_utils import max_abs, numpy_tree, port_config, small_config

torch.set_num_threads(2)

BUCKETS = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128, 256))
SENT = "the quick brown fox jumps over the lazy dog."
LONG = " ".join([SENT] * 4)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline.initialize(small_config(), seed=3)
    # Random HiFiGAN weights give near-silent audio at this width; scale the
    # kernels so the comparisons see order-one signal.
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **BUCKETS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    pipe = dataclasses.replace(pipe, **BUCKETS)
    return jpipe, pipe


def _mel(t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(-3.0, 2.0, size=(t, 80)).astype(np.float32)


def _rel(got, want) -> float:
    peak = float(np.abs(np.asarray(want, np.float64)).max())
    assert peak > 0.05, peak  # a real signal is compared
    return max_abs(got, want) / peak


# -- the window plan ----------------------------------------------------------


@pytest.mark.parametrize("name, make, radius", [
    ("default", lambda m: m.HiFiGANConfig(), 15),
    ("small", lambda m: small_config(m).hifigan, None),
    ("tiny", lambda m: m.HiFiGANConfig(
        in_channels=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
        resblock_dilations=((1, 3),)), 9),
])
def test_receptive_radius_matches_jax(name, make, radius):
    got = thifigan.receptive_radius_frames(make(port_cfg))
    assert got == jhifigan.receptive_radius_frames(make(jcfg))
    if radius is not None:
        assert got == radius


def test_stream_window_plan_matches_jax():
    n = 0
    for chunk in (1, 2, 7, 16, 64):
        for ctx in (0, 1, 9, 15):
            window = chunk + 2 * ctx
            for t in (window + 1, window + 2, window + chunk - 1,
                      3 * window + 5, 700):
                if t <= window:
                    continue
                got = list(thifigan.iter_stream_windows(t, chunk, ctx))
                assert got == list(jhifigan.iter_stream_windows(t, chunk, ctx))
                n += 1
    assert n > 90


# -- vocode_streaming ---------------------------------------------------------


def _stream(pipe, mel, **kw):
    return list(pipe.vocode_streaming(mel, **kw))


@pytest.mark.parametrize("t, chunk, lengths", [
    (70, 16, [16, 16, 16, 16, 6]),   # a remainder chunk
    (41, 7, [7] * 5 + [6]),          # unaligned
    (41, 1, [1] * 41),               # chunk 1
    (35, 16, [16, 16, 3]),           # one frame longer than a window
])
def test_vocode_streaming_equals_full_and_jax(pipes, t, chunk, lengths):
    jpipe, pipe = pipes
    radius = thifigan.receptive_radius_frames(pipe.config.hifigan)
    if t == 35:
        assert t == chunk + 2 * radius + 1
    mel = _mel(t, seed=t + chunk)
    chunks = _stream(pipe, mel, chunk_frames=chunk)
    hop = pipe.config.hifigan.total_upsample
    assert [len(c) for c in chunks] == [n * hop for n in lengths]
    got = np.concatenate(chunks)
    assert _rel(got, pipe.vocode(mel)) <= 1e-6
    want = np.concatenate(_stream(jpipe, mel, chunk_frames=chunk))
    assert _rel(got, want) <= 1e-5


def test_vocode_streaming_short_mel_is_one_call(pipes):
    jpipe, pipe = pipes
    mel = _mel(12, seed=2)
    chunks = _stream(pipe, mel, chunk_frames=16)
    assert len(chunks) == 1
    np.testing.assert_array_equal(chunks[0], pipe.vocode(mel))
    assert _rel(chunks[0], np.concatenate(
        _stream(jpipe, mel, chunk_frames=16))) <= 1e-5
    pcm = _stream(pipe, mel, chunk_frames=16, pcm16=True)
    assert len(pcm) == 1 and pcm[0].dtype == np.int16
    np.testing.assert_array_equal(pcm[0], host_pcm16(chunks[0]))


def test_vocode_streaming_pcm16(pipes):
    jpipe, pipe = pipes
    mel = _mel(70, seed=3)
    f32 = np.concatenate(_stream(pipe, mel, chunk_frames=16))
    i16 = np.concatenate(_stream(pipe, mel, chunk_frames=16, pcm16=True))
    assert i16.dtype == np.int16
    np.testing.assert_array_equal(i16, host_pcm16(f32))
    want = np.concatenate(_stream(jpipe, mel, chunk_frames=16, pcm16=True))
    assert int(np.abs(i16.astype(np.int32) - want).max()) <= 1


def test_vocode_streaming_reference_layout_and_tensor_in(pipes):
    _, pipe = pipes
    mel = _mel(70, seed=4)
    want = pipe.vocode(mel)
    for m in (mel.T, torch.from_numpy(np.ascontiguousarray(mel.T))):
        got = np.concatenate(_stream(pipe, m, chunk_frames=16))
        assert _rel(got, want) <= 1e-6


def test_vocode_streaming_empty_and_bad_rank(pipes):
    _, pipe = pipes
    assert _stream(pipe, np.zeros((0, 80), np.float32)) == []
    with pytest.raises(ValueError, match="one"):
        _stream(pipe, _mel(40)[None])


def test_vocode_streaming_windows_share_one_shape(pipes, monkeypatch):
    """Every chunk position (first, interior, right-clamped, remainder)
    vocodes a window of the same shape."""
    _, pipe = pipes
    shapes = []
    inner = pipe._vocode_window

    def spy(mel, start, chunk_samples, pcm16):
        shapes.append((tuple(mel.shape), chunk_samples))
        return inner(mel, start, chunk_samples, pcm16)

    monkeypatch.setattr(pipe, "_vocode_window", spy)
    _stream(pipe, _mel(200, seed=5), chunk_frames=20)
    assert len(shapes) == 10 and len(set(shapes)) == 1


# -- long text ----------------------------------------------------------------


def _chunks(pipe, text):
    return pipe._chunk_long_text(text, pipe.phoneme_buckets[-1])


def test_chunking_matches_jax(pipes):
    jpipe, pipe = pipes
    for text in (LONG, " ".join(["hello"] * 30), "supercalifragilistic" * 6,
                 "hello world", ""):
        assert _chunks(pipe, text) == _chunks(jpipe, text)
    assert len(_chunks(pipe, LONG)) >= 3


def test_synthesize_long_matches_jax(pipes):
    jpipe, pipe = pipes
    _assert_clear_of_half(jpipe, _chunks(jpipe, LONG))
    got = pipe.synthesize_long(LONG, temperature=0.0, gap_ms=50.0)
    want = jpipe.synthesize_long(LONG, temperature=0.0, gap_ms=50.0)
    assert got.dtype == np.float32 and len(got) == len(want)
    assert _rel(got, want) <= 1e-4
    # chunks + (n - 1) gaps
    outs = pipe.synthesize(_chunks(pipe, LONG), temperature=0.0, fused=False)
    gap = int(round(0.050 * pipe.config.audio.sample_rate))
    assert len(got) == sum(map(len, outs)) + gap * (len(outs) - 1)
    # one chunk takes synthesize() unchanged
    np.testing.assert_array_equal(pipe.synthesize_long(SENT, seed=7),
                                  pipe.synthesize(SENT, seed=7))
    # no sentence, no audio
    assert len(pipe.synthesize_long("")) == len(jpipe.synthesize_long("")) == 0


def test_stream_matches_jax(pipes):
    jpipe, pipe = pipes
    chunks = _chunks(pipe, LONG)
    _assert_clear_of_half(jpipe, chunks)
    got = list(pipe.stream(LONG, temperature=0.0, gap_ms=50.0))
    want = list(jpipe.stream(LONG, temperature=0.0, gap_ms=50.0))
    assert len(got) == len(want) == 2 * len(chunks) - 1
    gap = int(round(0.050 * pipe.config.audio.sample_rate))
    for i, (g, w) in enumerate(zip(got, want)):
        if i % 2:
            assert len(g) == gap and not g.any()
        else:
            assert len(g) == len(w) and _rel(g, w) <= 1e-4
    pcm = list(pipe.stream(LONG, temperature=0.0, gap_ms=50.0, pcm16=True))
    assert all(p.dtype == np.int16 for p in pcm)
    np.testing.assert_array_equal(np.concatenate(pcm),
                                  host_pcm16(np.concatenate(got)))


def test_stream_seeds_are_per_chunk(pipes):
    """Chunk i of a seeded stream is ``synthesize(chunk_i, seed=seed + i)``
    on the fused path, so it is reproducible alone."""
    _, pipe = pipes
    chunks = _chunks(pipe, LONG)
    pieces = list(pipe.stream(LONG, seed=4, gap_ms=50.0))
    for i in (0, 1, len(chunks) - 1):
        np.testing.assert_array_equal(
            pieces[2 * i], pipe.synthesize(chunks[i], seed=4 + i, fused=True))


def test_stream_vocode_chunked_matches_jax(pipes):
    """vocode_chunk_frames: each sentence arrives in fixed-size pieces
    whose concatenation is the vocoder pass over that sentence's mel."""
    jpipe, pipe = pipes
    chunks = _chunks(pipe, LONG)
    got = list(pipe.stream(LONG, temperature=0.0, gap_ms=50.0,
                           vocode_chunk_frames=8))
    assert len(got) > 2 * len(chunks) - 1
    want = list(jpipe.stream(LONG, temperature=0.0, gap_ms=50.0,
                             vocode_chunk_frames=8))
    assert [len(g) for g in got] == [len(w) for w in want]
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-4
    mel = pipe.synthesize_mel(chunks[0], temperature=0.0)
    n = len(mel) * pipe.config.hifigan.total_upsample
    assert _rel(np.concatenate(got)[:n], pipe.vocode(mel)) <= 1e-6


def test_stream_lookahead_failure_flushes_finished_chunk(pipes, monkeypatch):
    """A failing lookahead dispatch still yields the chunk whose audio is
    already computed, then raises."""
    _, pipe = pipes
    chunks = _chunks(pipe, LONG)
    inner = pipe._fused_dispatch
    calls = []

    def flaky(texts, *a, **kw):
        calls.append(texts[0])
        if len(calls) == 3:
            raise RuntimeError("lookahead failed")
        return inner(texts, *a, **kw)

    monkeypatch.setattr(pipe, "_fused_dispatch", flaky)
    got = []
    with pytest.raises(RuntimeError, match="lookahead failed"):
        for piece in pipe.stream(LONG, seed=1):
            got.append(piece)
    # chunk 0, then gap + chunk 1 (dispatched before chunk 2 failed)
    assert len(got) == 3 and calls[:2] == chunks[:2]
    np.testing.assert_array_equal(
        got[2], pipe.synthesize(chunks[1], seed=2, fused=True))


def test_synthesize_to_file_matches_jax(pipes, tmp_path):
    jpipe, pipe = pipes
    _assert_clear_of_half(jpipe, _chunks(jpipe, LONG))
    jpipe.synthesize_to_file(LONG, tmp_path / "jax.wav", seed=0)
    audio = pipe.synthesize_to_file(LONG, tmp_path / "port.wav", seed=0)
    got, sr = read_wav(tmp_path / "port.wav")
    want, _ = read_wav(tmp_path / "jax.wav")
    assert sr == pipe.config.audio.sample_rate
    assert len(got) == len(want) == len(audio)
    # seeded (not temperature 0): lengths agree, samples need not
    assert np.isfinite(got).all()


# -- warmup and the batched split ---------------------------------------------


def test_warmup_counts_match_jax():
    """The bucket pairs and the shape counts depend only on the ladders and
    the VAE's down factor, so a tiny JAX pipeline gives JAX's counts."""
    ladders = dict(phoneme_buckets=(16, 32), frame_buckets=(32, 64, 128))
    jpipe = dataclasses.replace(JPipeline.initialize(jax_tiny_config(),
                                                     seed=0), **ladders)
    pipe = dataclasses.replace(TTSPipeline.initialize(
        small_config(port_cfg), seed=0, device="cpu"), **ladders)
    assert (pipe.config.vae.down_factor == jpipe.config.vae.down_factor)
    for max_p in (None, 5, 20):
        assert pipe.fused_bucket_pairs(max_p) == jpipe.fused_bucket_pairs(
            max_p)
    assert pipe.warmup_fused() == jpipe.warmup_fused() == 4
    assert pipe.warmup_fused(batch_sizes=(1, 2), pcm16=True) == 8
    # Batch 1 on the JAX side (each shape is one compile there); the count
    # is per batch size, as the port's (1, 2) shows.
    for kw, n in ((dict(max_frames_per_phoneme=2), 5), ({}, 8)):
        assert pipe.warmup_batched((1,), **kw) == n
        assert jpipe.warmup_batched((1,), **kw) == n
        assert pipe.warmup_batched((1, 2), pcm16=True, **kw) == 2 * n


def test_batched_dispatch_collect_equals_two_stage(pipes):
    _, pipe = pipes
    texts = ["hello", "hello world how are you"]
    for pcm16 in (False, True):
        handle = pipe._batched_dispatch(texts, seed=4, pcm16=pcm16)
        assert handle.pcm16 is pcm16 and handle.n == 2
        got = pipe._batched_collect(handle)
        want = pipe.synthesize(texts, seed=4, fused=False, pcm16=pcm16)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # padded rows are synthesized and dropped by the caller's slice
    hop = pipe.config.hifigan.total_upsample
    rows = pipe._batched_collect(pipe._batched_dispatch(texts + texts[-1:],
                                                        seed=4))
    assert len(rows) == 3 and all(len(r) % hop == 0 for r in rows)
