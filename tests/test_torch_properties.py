"""Property-based tests (hypothesis) of the port's host-side contracts,
mirroring the JAX package's ``tests/test_properties.py`` with its
settings: the streaming window plan, length regulation's conservation
laws, rule normalization's idempotence and totality, the frontend's
totality on arbitrary unicode, both WAV readers and the TextGrid parser on
hostile input. Where the function is host code in both packages, the
port's result on each drawn input also equals JAX's. (The native npy
reader's property is mirrored in ``tests/test_torch_native_host.py``.)"""

import functools

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from iris_tts_tpu.data import audio_io as jaudio_io
from iris_tts_tpu.data.textgrid import parse_textgrid as jparse_textgrid
from iris_tts_tpu.models.hifigan import iter_stream_windows as jwindows
from iris_tts_tpu.text.normalize import normalize_text as jnormalize
from iris_tts_tpu_torch.models.hifigan import iter_stream_windows

SETTINGS = dict(max_examples=80, deadline=None)


@settings(**SETTINGS)
@given(
    chunk=st.integers(1, 64),
    ctx=st.integers(0, 32),
    extra=st.integers(1, 300),
)
def test_stream_window_plan_invariants(chunk, ctx, extra):
    """For every (t, chunk, ctx) with t > window: the keep-regions tile
    [0, t) exactly; every window lies inside the mel; the clamped slice
    always fits; boundary windows align to the true mel edges; and the
    plan is JAX's."""
    window = chunk + 2 * ctx
    t = window + extra
    plan = list(iter_stream_windows(t, chunk, ctx))
    assert plan == list(jwindows(t, chunk, ctx))
    assert plan[0][0] == 0 and plan[-1][1] == t
    for (a, b, w0, sf, scf) in plan:
        assert 0 < b - a <= chunk
        assert 0 <= w0 and w0 + window <= t
        assert w0 + sf == a and a + (b - a) <= w0 + window
        assert 0 <= scf <= window - chunk and sf >= scf
        if a >= ctx:
            assert w0 <= a - ctx or w0 == t - window
        if a < ctx:
            assert w0 == 0
        if t - b < ctx:
            assert w0 == t - window
    for prev, cur in zip(plan, plan[1:]):
        assert prev[1] == cur[0]


@settings(**SETTINGS)
@given(data=st.data())
def test_length_regulate_conservation(data):
    """Length regulation: with a sufficient frame budget, every phoneme
    occupies exactly its duration in frames, in order, and the frame mask
    counts the duration sum."""
    from iris_tts_tpu_torch.ops.length import length_regulate

    P, T = 6, 64
    durs = data.draw(
        st.lists(st.integers(0, 8), min_size=P, max_size=P).map(np.array)
    )
    total = int(durs.sum())
    if total == 0 or total > T:
        return
    # Encoder output rows are the phoneme indices themselves, so the
    # regulated frames reveal which phoneme produced them.
    enc = torch.arange(P, dtype=torch.float32)[None, :, None]
    d = torch.as_tensor(durs, dtype=torch.float32)[None]
    frames, mask = length_regulate(enc, d, total_frames=T)
    frames = frames.numpy()[0, :, 0]
    mask = mask.numpy()[0]
    assert mask.sum() == total
    np.testing.assert_array_equal(frames[:total],
                                  np.repeat(np.arange(P), durs))


@settings(**SETTINGS)
@given(
    text=st.text(
        alphabet=st.characters(min_codepoint=32, max_codepoint=0x24F),
        max_size=60,
    )
)
def test_normalize_text_idempotent_and_total(text):
    """normalize_text never raises on arbitrary input, is idempotent, and
    gives JAX's output."""
    from iris_tts_tpu_torch.text.normalize import normalize_text

    once = normalize_text(text)
    assert normalize_text(once) == once
    assert once == jnormalize(text)


@functools.cache
def _processors():
    from iris_tts_tpu.text.frontend import create_text_processor as jcreate
    from iris_tts_tpu.text.phonemes import PhonemeVocab as JVocab
    from iris_tts_tpu_torch.text.frontend import create_text_processor
    from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

    return (create_text_processor(), PhonemeVocab.default_arpabet(),
            jcreate(), JVocab.default_arpabet())


@settings(max_examples=60, deadline=None)
@given(
    text=st.text(
        alphabet=st.characters(min_codepoint=1, max_codepoint=0x2FFF),
        max_size=80,
    )
)
def test_frontend_total_on_arbitrary_unicode(text):
    """text_to_ids is total: any unicode input yields a non-empty id list
    within the vocab, never an exception, and JAX's ids."""
    tp, vocab, jtp, jvocab = _processors()
    ids = tp.text_to_ids(text, vocab)
    assert len(ids) >= 1
    assert all(0 <= int(i) < len(vocab) for i in ids)
    assert list(map(int, ids)) == list(map(int, jtp.text_to_ids(text,
                                                                 jvocab)))


CLEAN = (ValueError, RuntimeError, EOFError)


def _read(reader, path):
    try:
        return reader(path)
    except CLEAN:
        return None  # clean rejection


@settings(max_examples=50, deadline=None)
@given(data=st.data())
def test_wav_readers_reject_hostile_bytes(tmp_path_factory, data):
    """Truncations/mutations of a valid WAV yield a clean Python exception
    (or a successful parse) from both of the port's decoders: the native
    C++ codec in-process through ctypes (a memory bug would crash the test
    process) and the pure-Python reader, whose outcome is JAX's."""
    from iris_tts_tpu_torch.data import native as native_mod
    from iris_tts_tpu_torch.data.audio_io import read_wav, write_wav

    tmp = tmp_path_factory.mktemp("wavfuzz")
    base = tmp / "base.wav"
    write_wav(base, np.linspace(-1, 1, 256).astype(np.float32), 8000)
    raw = bytearray(base.read_bytes())
    mode = data.draw(st.sampled_from(["truncate", "mutate", "garbage"]))
    if mode == "truncate":
        raw = raw[: data.draw(st.integers(0, len(raw) - 1))]
    elif mode == "mutate":
        i = data.draw(st.integers(0, min(60, len(raw) - 1)))
        raw[i] = data.draw(st.integers(0, 255))
    else:
        raw = bytearray(
            data.draw(st.lists(st.integers(0, 255), max_size=64))
        )
    bad = tmp / "bad.wav"
    bad.write_bytes(bytes(raw))

    for reader in (read_wav, native_mod.read_wav_mono):
        out = _read(reader, bad)
        if out is None:
            continue
        audio = np.asarray(out[0])
        assert audio.dtype == np.float32
        assert np.isfinite(audio).all()
    ours, theirs = _read(read_wav, bad), _read(jaudio_io.read_wav, bad)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours[1] == theirs[1]
        np.testing.assert_array_equal(ours[0], theirs[0])


VALID_TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 0.3
tiers? <exists>
size = 1
item []:
    item [1]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 0.3
        intervals: size = 2
        intervals [1]:
            xmin = 0
            xmax = 0.1
            text = "HH"
        intervals [2]:
            xmin = 0.1
            xmax = 0.3
            text = "AH"
'''


def _tiers(parse, text):
    try:
        return [(t.name, [(iv.xmin, iv.xmax, iv.text) for iv in t.intervals])
                for t in parse(text)]
    except ValueError:
        return None  # clean rejection


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_textgrid_parser_total_on_hostile_text(data):
    """The TextGrid parser: mutations/truncations of a valid file (and
    pure garbage) parse to a well-formed tier list or raise a clean
    ValueError, never an unhandled IndexError/KeyError or a hang; the
    outcome is JAX's."""
    from iris_tts_tpu_torch.data.textgrid import parse_textgrid

    valid = VALID_TEXTGRID
    mode = data.draw(st.sampled_from(["truncate", "mutate", "garbage"]))
    if mode == "truncate":
        text = valid[: data.draw(st.integers(0, len(valid) - 1))]
    elif mode == "mutate":
        i = data.draw(st.integers(0, len(valid) - 1))
        ch = data.draw(st.characters(min_codepoint=32, max_codepoint=0x24F))
        text = valid[:i] + ch + valid[i + 1:]
    else:
        text = data.draw(st.text(max_size=200))
    tiers = _tiers(parse_textgrid, text)
    assert tiers == _tiers(jparse_textgrid, text)
    for name, intervals in tiers or []:
        assert isinstance(name, str)
        for xmin, xmax, label in intervals:
            assert isinstance(label, str)
            assert np.isfinite(xmin) and np.isfinite(xmax)
