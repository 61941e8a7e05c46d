"""Port parity of the data layer: audio IO, TextGrid parsing, the synthetic
corpus, the LJSpeech datasets and mel cache, batching and prefetch, the
training losses and the differentiable log-mel path.

Host and data modules must agree bit for bit with the JAX package (same
arrays, same corpus bytes, same TextGrid parse); losses within 1e-6
relative. Mel features (the cache, and the batches that carry it) within
1e-4 of each frame's peak, in linear mel: an f32 DFT's error scales with
the frame's energy, and in bins with no energy the log-mel sits near its
1e-5 floor where f32 rounding sets it — there the JAX package's own f32
result is 2.5e-3 (log) from a float64 evaluation, the port's 2e-4.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iris_tts_tpu.data.audio_io as jaudio
import iris_tts_tpu.data.batching as jbatching
import iris_tts_tpu.data.ljspeech as jlj
import iris_tts_tpu.data.textgrid as jtg
import iris_tts_tpu.ops.losses as jlosses
from iris_tts_tpu.config import AudioConfig as JAudioConfig
from iris_tts_tpu.data.synthetic_speech import CorpusSpec as JCorpusSpec
from iris_tts_tpu.data.synthetic_speech import generate_corpus as jax_corpus
from iris_tts_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.data import audio_io, batching, ljspeech, textgrid
from iris_tts_tpu_torch.data.synthetic_speech import (
    CorpusSpec,
    generate_corpus,
)
from iris_tts_tpu_torch.ops import losses
from iris_tts_tpu_torch.ops.stft import (
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
)

torch.set_num_threads(2)
N_UTT = 6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def assert_mel_close(got, want):
    """Log-mel [..., T, n_mels]: ≤1e-4 of each frame's peak in linear
    mel."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = np.exp(want).max(axis=-1, keepdims=True)
    assert np.max(np.abs(np.exp(got) - np.exp(want)) / peak) <= 1e-4


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same 6-utterance corpus spec generated by each package."""
    jroot = tmp_path_factory.mktemp("jax_corpus")
    troot = tmp_path_factory.mktemp("port_corpus")
    jax_corpus(jroot, JCorpusSpec(n_utterances=N_UTT, seed=7),
               progress_every=0)
    generate_corpus(troot, CorpusSpec(n_utterances=N_UTT, seed=7),
                    progress_every=0)
    return jroot, troot


@pytest.fixture(scope="module")
def vae_datasets(corpora, tmp_path_factory):
    """Train splits of the VAE dataset of each package over its own corpus,
    with val_fraction 0 so all 6 utterances are used."""
    jroot, troot = corpora
    jds = jlj.LJSpeechVAEDataset(
        jroot / "LJSpeech-1.1", jroot / "aligned", split="train",
        cache_dir=tmp_path_factory.mktemp("jcache"), audio=JAudioConfig(),
        val_fraction=0.0)
    tds = ljspeech.LJSpeechVAEDataset(
        troot / "LJSpeech-1.1", troot / "aligned", split="train",
        cache_dir=tmp_path_factory.mktemp("tcache"), audio=AudioConfig(),
        val_fraction=0.0, device="cpu")
    jds.precompute_mels()
    tds.precompute_mels()
    return jds, tds


# -- audio IO ----------------------------------------------------------------


@pytest.mark.parametrize("subtype", ["pcm16", "float32"])
def test_wav_bytes_and_read_match_jax(tmp_path, subtype):
    rng = np.random.default_rng(0)
    for shape in [(1000,), (777, 2)]:
        x = (rng.standard_normal(shape) * 0.4).astype(np.float32)
        x[:3] = [1.5, -1.5, 0.0] if x.ndim == 1 else x[:3]
        data = audio_io.wav_bytes(x, 22050, subtype)
        assert data == jaudio.wav_bytes(x, 22050, subtype)
        path = tmp_path / f"a_{subtype}_{len(shape)}.wav"
        audio_io.write_wav(path, x, 22050, subtype)
        got, sr = audio_io.read_wav(path)
        want, wsr = jaudio.read_wav(path)
        assert sr == wsr == 22050 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(audio_io.to_mono(got),
                                      jaudio.to_mono(want))


def test_load_audio_and_resample_match_jax(tmp_path):
    x = (np.sin(np.arange(4410) * 0.05) * 0.5).astype(np.float32)
    path = tmp_path / "tone.wav"
    jaudio.write_wav(path, x, 44100)
    for sr in (22050, 16000, 44100):
        np.testing.assert_array_equal(audio_io.load_audio(path, sr),
                                      jaudio.load_audio(path, sr))
    np.testing.assert_array_equal(
        audio_io.resample(x, 22050, 24000), jaudio.resample(x, 22050, 24000))
    chunks = [x[:10], x[10:30]]
    np.testing.assert_array_equal(audio_io.join_wave_chunks(chunks, 5, 1000),
                                  jaudio.join_wave_chunks(chunks, 5, 1000))


# -- TextGrid ----------------------------------------------------------------

# Praat's short format without its unquoted header words ('File type',
# '<exists>') and with a blank, not empty, silence mark: the parser (the
# same in both packages) can skip neither of those.
_SHORT_TG = '''"ooTextFile"
"TextGrid"
0
1.5
2
"IntervalTier"
"words"
0
1.5
1
0
1.5
"hello ""quoted"" world"
"IntervalTier"
"phones"
0
1.5
4
0
0.25
" "
0.25
0.6
"HH"
0.6
1.1
"AH0"
1.1
1.5
"L"
'''


def test_textgrid_parse_matches_jax(corpora, tmp_path):
    _, troot = corpora
    texts = [_SHORT_TG] + [p.read_text() for p in
                           sorted((troot / "aligned").glob("*.TextGrid"))]
    for text in texts:
        assert textgrid.parse_textgrid(text) == [
            textgrid.Tier(t.name, [textgrid.Interval(i.xmin, i.xmax, i.text)
                                   for i in t.intervals])
            for t in jtg.parse_textgrid(text)]
    path = tmp_path / "s.TextGrid"
    path.write_text(_SHORT_TG)
    phones = textgrid.load_alignment_phones(path)
    assert phones == jtg.load_alignment_phones(path)
    assert [p["phone"] for p in phones] == ["HH", "AH0", "L"]
    np.testing.assert_array_equal(textgrid.durations_to_frames(phones),
                                  jtg.durations_to_frames(phones))
    aligned = textgrid.load_alignments(troot / "aligned")
    assert aligned == jtg.load_alignments(troot / "aligned")
    textgrid.save_alignment_cache(aligned, tmp_path / "c.npz")
    assert (jtg.load_alignment_cache(tmp_path / "c.npz")
            == textgrid.load_alignment_cache(tmp_path / "c.npz"))


# -- synthetic corpus --------------------------------------------------------


def test_synthetic_corpus_is_byte_identical(corpora):
    jroot, troot = corpora
    files = sorted(p.relative_to(troot) for p in troot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                           if p.is_file())
    wavs = [f for f in files if f.suffix == ".wav"]
    assert len(wavs) == N_UTT
    for f in files:
        if f.name == "corpus_spec.json":
            continue
        assert (troot / f).read_bytes() == (jroot / f).read_bytes(), f
    spec = json.loads((troot / "LJSpeech-1.1/corpus_spec.json").read_text())
    jspec = json.loads((jroot / "LJSpeech-1.1/corpus_spec.json").read_text())
    assert spec.pop("generator").startswith("iris_tts_tpu_torch.")
    jspec.pop("generator")
    assert spec == jspec


# -- datasets and the mel cache ------------------------------------------------


def test_duration_dataset_matches_jax(corpora, tmp_path):
    jroot, troot = corpora
    kw = dict(split="train", max_phoneme_length=200, val_fraction=0.2)
    jds = jlj.LJSpeechDurationDataset(jroot / "LJSpeech-1.1",
                                      jroot / "aligned",
                                      cache_dir=tmp_path / "j", **kw)
    tds = ljspeech.LJSpeechDurationDataset(troot / "LJSpeech-1.1",
                                           troot / "aligned",
                                           cache_dir=tmp_path / "t", **kw)
    assert tds.sample_ids == jds.sample_ids and len(tds) == N_UTT - 1
    assert tds.vocab.phoneme_to_id == jds.vocab.phoneme_to_id
    assert (tmp_path / "t/phoneme_vocab.json").read_text() == (
        tmp_path / "j/phoneme_vocab.json").read_text()
    for s, js in zip(tds, jds):
        assert (s.file_id, s.text) == (js.file_id, js.text)
        np.testing.assert_array_equal(s.phoneme_ids, js.phoneme_ids)
        np.testing.assert_array_equal(s.durations, js.durations)
    val = ljspeech.LJSpeechDurationDataset(
        troot / "LJSpeech-1.1", troot / "aligned", split="val",
        cache_dir=tmp_path / "t", val_fraction=0.2)
    assert len(val) == 1


def test_mel_cache_matches_jax(vae_datasets):
    """The port's mel cache (plain version on the CPU) against the JAX
    package's; durations trimmed identically."""
    jds, tds = vae_datasets
    assert len(tds) == N_UTT
    for s, js in zip(tds, jds):
        assert s.mel.dtype == np.float32
        assert_mel_close(s.mel, js.mel)
        np.testing.assert_array_equal(s.durations, js.durations)
        assert s.mel.shape[0] == int(s.durations.sum())


def test_mel_cache_bucket_padding_is_exact(vae_datasets):
    """The 64-hop bucket padding leaves the clip's own frames unchanged."""
    _, tds = vae_datasets
    sid = tds.sample_ids[0]
    audio = audio_io.load_audio(tds.root / "wavs" / f"{sid}.wav")
    want = log_mel_spectrogram_plain(_t(audio)).numpy()
    np.testing.assert_allclose(tds._compute_mel(sid), want, atol=1e-5)


# -- batching ----------------------------------------------------------------


@pytest.mark.parametrize("with_mel", [False, True])
def test_bucketed_batcher_matches_jax(vae_datasets, with_mel):
    jds, tds = vae_datasets
    kw = dict(batch_size=4, with_mel=with_mel, phoneme_buckets=(64, 128),
              frame_buckets=(256, 512, 1024), seed=3)
    for epoch in (0, 1):
        got = list(batching.BucketedBatcher(tds, **kw).epoch(epoch))
        want = list(jbatching.BucketedBatcher(jds, **kw).epoch(epoch))
        assert len(got) == len(want) >= 2
        for b, jb in zip(got, want):
            assert set(b) == set(jb)
            for k in b:
                assert b[k].dtype == jb[k].dtype
                if k == "mel":
                    assert_mel_close(b[k], jb[k])
                else:
                    np.testing.assert_array_equal(b[k], jb[k])


def test_audio_segment_batcher_matches_jax(vae_datasets):
    from scripts.train_hifigan import AudioSegmentBatcher as JBatcher

    jds, tds = vae_datasets
    got = list(batching.AudioSegmentBatcher(tds, 2, 32, AudioConfig(),
                                            seed=5).epoch(1))
    want = list(JBatcher(jds, 2, 32, JAudioConfig(), seed=5).epoch(1))
    assert len(got) == len(want) == N_UTT // 2
    for b, jb in zip(got, want):
        assert b["audio"].shape == (2, 32 * 256)
        np.testing.assert_array_equal(b["audio"], jb["audio"])
        assert_mel_close(b["mel"], jb["mel"])


def test_split_microbatches():
    from iris_tts_tpu.train.steps import split_microbatches as jsplit
    from iris_tts_tpu_torch.train.steps import split_microbatches

    b = {"x": np.arange(24, dtype=np.float32).reshape(6, 4)}
    np.testing.assert_array_equal(split_microbatches(b, 3)["x"],
                                  np.asarray(jsplit(b, 3)["x"]))
    with pytest.raises(ValueError):
        split_microbatches(b, 4)


def test_prefetch_to_device_order_placement_and_errors():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(batching.prefetch_to_device(
        iter(batches), size=2,
        place=lambda b: batching.to_device(b, "cpu")))
    assert [int(b["x"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)

    def bad():
        yield batches[0]
        raise RuntimeError("worker failed")

    it = batching.prefetch_to_device(
        bad(), place=lambda b: batching.to_device(b, "cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="worker failed"):
        next(it)
    # Stopping early shuts the worker down.
    n_threads = threading.active_count()
    it = batching.prefetch_to_device(
        iter(batches * 10), size=1,
        place=lambda b: batching.to_device(b, "cpu"))
    next(it)
    it.close()
    assert threading.active_count() <= n_threads


# -- losses ------------------------------------------------------------------


def _rel(a, b):
    a = float(a.detach()) if isinstance(a, torch.Tensor) else float(a)
    b = float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pred, dur = f(3, 9), np.abs(f(3, 9)) * 12
    pmask = (rng.random((3, 9)) > 0.2).astype(np.float32)
    mel_a, mel_b = f(3, 16, 80), f(3, 16, 80)
    fmask = (np.arange(16)[None] < np.array([[16], [11], [5]])).astype(
        np.float32)
    mean, logvar, u = f(3, 4, 6), 0.3 * f(3, 4, 6), f(3, 4, 6)
    cases = [
        (losses.duration_huber_loss(_t(pred), _t(dur), _t(pmask), 3.0),
         jlosses.duration_huber_loss(pred, dur, pmask, 3.0)),
        (losses.duration_huber_loss(_t(pred)[..., None], _t(dur)),
         jlosses.duration_huber_loss(pred[..., None], dur)),
        (losses.masked_l1_loss(_t(mel_a), _t(mel_b), _t(fmask)),
         jlosses.masked_l1_loss(mel_a, mel_b, fmask)),
        (losses.masked_l1_loss(_t(mel_a), _t(mel_b)),
         jlosses.masked_l1_loss(mel_a, mel_b)),
        (losses.kl_divergence(_t(mean), _t(logvar), _t(fmask[:, ::4])),
         jlosses.kl_divergence(mean, logvar, fmask[:, ::4])),
        (losses.flow_prior_kl(_t(mean), _t(logvar), _t(u), _t(fmask[:, ::4])),
         jlosses.flow_prior_kl(mean, logvar, u, fmask[:, ::4])),
    ]
    for u_ in (None, u):
        got, gm = losses.vae_loss(_t(mel_a), _t(mel_b), _t(mean), _t(logvar),
                                  _t(fmask), 4, 0.01,
                                  None if u_ is None else _t(u_))
        want, wm = jlosses.vae_loss(mel_a, mel_b, mean, logvar, fmask, 4,
                                    0.01, u=u_)
        cases += [(got, want)] + [(gm[k], wm[k]) for k in wm]
    real = [f(3, 7), f(3, 5)]
    fake = [f(3, 7), f(3, 5)]
    feats_r = [[f(3, 4, 7), f(3, 2, 7)], [f(3, 6)]]
    feats_f = [[f(3, 4, 7), f(3, 2, 7)], [f(3, 6)]]
    cases += [
        (losses.lsgan_discriminator_loss([_t(x) for x in real],
                                         [_t(x) for x in fake]),
         jlosses.lsgan_discriminator_loss(real, fake)),
        (losses.lsgan_generator_loss([_t(x) for x in fake]),
         jlosses.lsgan_generator_loss(fake)),
        (losses.feature_matching_loss(
            [[_t(x) for x in r] for r in feats_r],
            [[_t(x) for x in r] for r in feats_f]),
         jlosses.feature_matching_loss(feats_r, feats_f)),
    ]
    for got, want in cases:
        assert got.dtype == torch.float32
        assert _rel(got, want) <= 1e-6, (float(got), float(want))


def test_differentiable_log_mel_matches_jax_xla_path():
    """``impl="xla"``: value and gradient of a mel loss equal the JAX
    package's XLA path; the default path on a CPU tensor is the plain
    version (the kernel is for CUDA tensors)."""
    rng = np.random.default_rng(2)
    audio = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    target = (rng.standard_normal((2, 17, 80))).astype(np.float32)
    cfg, jcfg = AudioConfig(), JAudioConfig()

    def jloss(a):
        return jnp.mean(jnp.abs(jax_log_mel(a, jcfg, impl="xla") - target))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(audio))
    a = _t(audio).requires_grad_(True)
    val = torch.mean((log_mel_spectrogram(a, cfg, impl="xla")
                      - _t(target)).abs())
    val.backward()
    assert _rel(val, jval) <= 1e-6
    g, jg = a.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    np.testing.assert_array_equal(log_mel_spectrogram(_t(audio), cfg),
                                  log_mel_spectrogram_plain(_t(audio), cfg))
    with pytest.raises(ValueError, match="impl"):
        log_mel_spectrogram(_t(audio), cfg, impl="pallas")
