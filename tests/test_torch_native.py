"""Port parity: the native WAV codec (``iris_tts_tpu_torch/data/native.py``
over its own ``data/csrc/wavio.cpp``, built with g++ at first use into
``build/iris_tts_tpu_torch/``).

The JAX package's ``tests/test_native.py`` cases, cross-checked against
the port's pure-Python reader, plus equality with the JAX package's
``iris_tts_tpu.data.native`` on the same files. Skips, as JAX's does,
where no toolchain builds the library. Tolerances are JAX's: float32
files exact to 1e-7, PCM16/24 to 1e-6, a PCM16 write round trip to 1e-4;
the two packages' readers agree bitwise.
"""

import struct

import numpy as np
import pytest

from iris_tts_tpu.data import native as jax_native
from iris_tts_tpu_torch.data import audio_io
from iris_tts_tpu_torch.data import native
from iris_tts_tpu_torch.utils import cxx


def _write(path, samples, sr, subtype):
    """``audio_io.write_wav``, plus 24-bit PCM (which it does not write)."""
    if subtype != "pcm24":
        audio_io.write_wav(path, samples, sr, subtype=subtype)
        return
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    q = np.round(np.clip(samples, -1, 1) * 8388607).astype("<i4").reshape(-1)
    raw = np.stack([q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF],
                   -1).astype(np.uint8).tobytes()
    fmt = struct.pack("<HHIIHH", 1, ch, sr, sr * ch * 3, ch * 3, 24)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(raw)) + raw)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.fixture(scope="module")
def lib():
    if not native.native_available():
        pytest.skip("no native toolchain available")
    return native.get_lib()


def test_library_builds_from_the_ports_source(lib):
    assert native.SOURCE.name == "wavio.cpp"
    assert "iris_tts_tpu_torch" in str(native.SOURCE)
    assert cxx.BUILD_DIR.name == "iris_tts_tpu_torch"
    assert any(cxx.BUILD_DIR.glob("libiriswav_*.so"))


def test_native_read_matches_python(tmp_path, rng, lib):
    samples = (0.7 * rng.standard_normal(4096)).clip(-1, 1).astype(np.float32)
    p = tmp_path / "a.wav"
    audio_io.write_wav(p, samples, 22050, subtype="float32")
    got, sr = native.read_wav_mono(p)
    assert sr == 22050
    np.testing.assert_allclose(got, samples, atol=1e-7)


@pytest.mark.parametrize("subtype", ["pcm16", "pcm24"])
def test_native_read_pcm16_and_24(tmp_path, rng, lib, subtype):
    samples = (0.5 * rng.standard_normal(1000)).clip(-1, 1).astype(
        np.float32)
    p = tmp_path / f"{subtype}.wav"
    _write(p, samples, 16000, subtype)
    got, sr = native.read_wav_mono(p)
    want, _ = audio_io.read_wav(p)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert sr == 16000


def test_native_stereo_downmix(tmp_path, rng, lib):
    st = (0.4 * rng.standard_normal((512, 2))).astype(np.float32)
    p = tmp_path / "st.wav"
    audio_io.write_wav(p, st, 22050, subtype="float32")
    got, _ = native.read_wav_mono(p)
    np.testing.assert_allclose(got, st.mean(axis=1), atol=1e-6)


def test_native_batch_read(tmp_path, rng, lib):
    paths, refs = [], []
    for i in range(6):
        s = (0.3 * rng.standard_normal(500 + 100 * i)).astype(np.float32)
        p = tmp_path / f"b{i}.wav"
        audio_io.write_wav(p, s, 22050, subtype="float32")
        paths.append(p)
        refs.append(s)
    audio, lengths, rates = native.read_wav_batch(paths, max_samples=800,
                                                  num_threads=3)
    assert audio.shape == (6, 800)
    for i, s in enumerate(refs):
        take = min(len(s), 800)
        assert lengths[i] == take and rates[i] == 22050
        np.testing.assert_allclose(audio[i, :take], s[:take], atol=1e-7)
        np.testing.assert_allclose(audio[i, take:], 0.0)


def test_native_batch_read_resamples_mixed_rates(tmp_path, lib):
    t = np.arange(44100) / 44100.0
    hi = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    lo = (0.5 * np.sin(2 * np.pi * 220 * t[::2])).astype(np.float32)[:11025]
    p_hi, p_lo = tmp_path / "hi.wav", tmp_path / "lo.wav"
    audio_io.write_wav(p_hi, hi, 44100, subtype="float32")
    audio_io.write_wav(p_lo, lo, 22050, subtype="float32")
    audio, lengths, rates = native.read_wav_batch(
        [p_hi, p_lo], max_samples=46000, expected_sample_rate=22050)
    assert list(rates) == [22050, 22050]
    assert abs(int(lengths[0]) - 22050) <= 2
    assert int(lengths[1]) == 11025
    seg = audio[0, 1000: int(lengths[0]) - 1000]
    assert 0.45 < np.abs(seg).max() < 0.55
    np.testing.assert_allclose(audio[0, int(lengths[0]):], 0.0)


def test_native_batch_read_with_missing_file(tmp_path, rng, lib):
    s = (0.3 * rng.standard_normal(256)).astype(np.float32)
    good = tmp_path / "good.wav"
    audio_io.write_wav(good, s, 22050, subtype="float32")
    audio, lengths, _ = native.read_wav_batch(
        [good, tmp_path / "missing.wav"], max_samples=300)
    assert lengths[0] == 256 and lengths[1] == 0
    np.testing.assert_allclose(audio[1], 0.0)
    with pytest.raises(ValueError, match="decode failed"):
        native.read_wav_mono(tmp_path / "missing.wav")


def test_native_write_roundtrip(tmp_path, rng, lib):
    s = (0.6 * rng.standard_normal(2048)).clip(-1, 1).astype(np.float32)
    p = tmp_path / "w.wav"
    native.write_wav_pcm16(p, s, 22050)
    got, sr = audio_io.read_wav(p)
    assert sr == 22050
    np.testing.assert_allclose(got, s, atol=1e-4)


def test_load_audio_resamples(tmp_path, lib):
    t = np.arange(16000) / 16000.0
    s = (0.5 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    p = tmp_path / "s.wav"
    audio_io.write_wav(p, s, 16000, subtype="float32")
    np.testing.assert_array_equal(native.load_audio(p, 22050),
                                  audio_io.load_audio(p, 22050))


def test_python_fallback_paths(tmp_path, rng, monkeypatch):
    """With the native lib forced off, the same API works via Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.native_available()
    s = (0.5 * rng.standard_normal(512)).clip(-1, 1).astype(np.float32)
    p = tmp_path / "f.wav"
    native.write_wav_pcm16(p, s, 22050)
    got, sr = native.read_wav_mono(p)
    assert sr == 22050
    np.testing.assert_allclose(got, s, atol=1e-4)
    audio, lengths, _ = native.read_wav_batch([p], max_samples=600)
    assert lengths[0] == 512


def test_a_failed_build_falls_back(tmp_path, monkeypatch):
    """No compiler: the library is None and nothing raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(cxx, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None
    assert not any((tmp_path / "build").glob("*.so"))


def test_native_reads_equal_jaxs(tmp_path, rng, lib):
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library does not build here")
    paths = []
    for i, (sub, ch) in enumerate([("float32", 1), ("pcm16", 1),
                                   ("pcm24", 2), ("pcm16", 2)]):
        shape = (700 + 50 * i, ch) if ch > 1 else (700 + 50 * i,)
        s = (0.4 * rng.standard_normal(shape)).clip(-1, 1).astype(np.float32)
        p = tmp_path / f"j{i}.wav"
        _write(p, s, 22050, sub)
        paths.append(p)
        got, sr = native.read_wav_mono(p)
        want, jsr = jax_native.read_wav_mono(p)
        assert sr == jsr
        np.testing.assert_array_equal(got, want)
    got = native.read_wav_batch(paths, max_samples=800, num_threads=2)
    want = jax_native.read_wav_batch(paths, max_samples=800, num_threads=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    s = (0.6 * rng.standard_normal(1000)).clip(-1, 1).astype(np.float32)
    native.write_wav_pcm16(tmp_path / "p.wav", s, 22050)
    jax_native.write_wav_pcm16(tmp_path / "j.wav", s, 22050)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
