"""The PyTorch port on the released trained weights (``release/
pipeline_artifact``), against the JAX package on the CPU.

The artifact is an orbax checkpoint (float16 params, a ``flow_prior``
VAE): JAX's ``TTSPipeline.load`` reads it once for the module, and the
port's own ``TTSPipeline.load`` reads it without JAX
(``convert/orbax.py``), its state dict bitwise ``from_jax_params`` of
JAX's load.

* f32: fused and two-stage ``synthesize`` at temperature 0 match JAX with
  ``tests/test_torch_pipeline.py``'s tolerance (max-abs ≤ 1e-3, equal
  lengths).
* bf16: trained weights put some durations near a rounding boundary,
  where one bf16 ulp in a log-duration moves a frame. So the log-durations
  are compared before rounding (each within one bf16 ulp of JAX's, and
  within 2× JAX's own bf16-vs-f32 gap), and stage B runs on JAX's integer
  frames, held to JAX's bf16 within 2× JAX's own bf16-vs-f32 gap (JAX's
  bf16 gate of small random weights does not hold for JAX itself here:
  ``test_bf16_stage_b_on_jax_frames``).

Frame totals in f32 / bf16 on these weights, JAX and port (measured on the
CPU): "The quick brown fox." 99 / 98 in JAX and 99 / 99 in the port (one
bf16 ulp apart in one log-duration); "Hello world." 65 / 64 in both;
"Good morning to you." 111 / 112 in both; "The old gardener found a
basket of apples." 216 / 216 in both. ``test_bf16_frame_flips`` holds
these.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, stage_a
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab
from tests.test_torch_pipeline import _assert_clear_of_half, _assert_same_audio
from tests.torch_port_utils import max_abs, numpy_tree, port_config

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parent.parent / "release" / \
    "pipeline_artifact"
SENTENCE = "The old gardener found a basket of apples."
FLIP = "The quick brown fox."
# (sentence, frames JAX f32, JAX bf16, port f32, port bf16)
FRAME_TOTALS = [
    (FLIP, 99, 98, 99, 99),
    ("Hello world.", 65, 64, 65, 64),
    ("Good morning to you.", 111, 112, 111, 112),
    (SENTENCE, 216, 216, 216, 216),
]


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline.load(ARTIFACT)
    pipe = TTSPipeline.load(ARTIFACT, device="cpu")
    return {"jax": (jpipe, dataclasses.replace(jpipe, dtype=jnp.bfloat16)),
            "port": (pipe, dataclasses.replace(pipe, dtype=torch.bfloat16))}


def test_port_load_equals_from_jax_params(pipes):
    """The port's ``load`` of the artifact: the state dict of
    ``from_jax_params`` on JAX's load, bitwise, and JAX's options."""
    jpipe, _ = pipes["jax"]
    pipe, _ = pipes["port"]
    ref = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu",
        vocab=PhonemeVocab.load(ARTIFACT / "vocab.json"))
    got, want = pipe.model.state_dict(), ref.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert (pipe.phoneme_buckets, pipe.frame_buckets) == (
        tuple(jpipe.phoneme_buckets), tuple(jpipe.frame_buckets))
    assert (pipe.use_postnet, pipe.upsample, pipe.seed) == (
        jpipe.use_postnet, jpipe.upsample, jpipe.seed)
    assert pipe.fused_frames_per_phoneme == jpipe.fused_frames_per_phoneme


def _jax_stage_a(jpipe, text):
    ids, lengths = jpipe._encode_texts([text])
    enc, frames, _ = jpipe._stage_a(jpipe.params, jnp.asarray(ids),
                                    jnp.asarray(lengths))
    return ids, lengths, enc, frames


def _log_durations(pipes, text):
    """{package+dtype: [P] log-durations of ``text``'s phonemes}."""
    out = {}
    for tag, jp in zip(("j32", "j16"), pipes["jax"]):
        ids, lengths = jp._encode_texts([text])
        mask = np.arange(ids.shape[1])[None] < lengths[:, None]
        enc = jp._encoder.apply({"params": jp.params["encoder"]},
                                jnp.asarray(ids),
                                padding_mask=jnp.asarray(mask))
        ld = jp._duration.apply({"params": jp.params["duration"]}, enc)
        out[tag] = np.asarray(ld, np.float32)[0, :lengths[0]]
    for tag, p in zip(("p32", "p16"), pipes["port"]):
        ids, lengths = p._encode_texts([text])
        with torch.no_grad():
            mask = torch.arange(ids.shape[1])[None] < torch.from_numpy(
                lengths)[:, None]
            enc = p.model.encoder(torch.from_numpy(ids), padding_mask=mask)
            ld = p.model.duration(enc)
        out[tag] = ld.float().numpy()[0, :lengths[0]]
    return out


def test_f32_fused_synthesize_matches_jax(pipes):
    jpipe, _ = pipes["jax"]
    pipe, _ = pipes["port"]
    _assert_clear_of_half(jpipe, [SENTENCE])
    want = jpipe.synthesize(SENTENCE, temperature=0.0)
    got = pipe.synthesize(SENTENCE, temperature=0.0)
    assert got.dtype == np.float32
    _assert_same_audio(got, want)


def test_f32_two_stage_synthesize_matches_jax(pipes):
    jpipe, _ = pipes["jax"]
    pipe, _ = pipes["port"]
    want = jpipe.synthesize([SENTENCE, "Hello world."], temperature=0.0,
                            fused=False)
    got = pipe.synthesize([SENTENCE, "Hello world."], temperature=0.0,
                          fused=False)
    for g, w in zip(got, want):
        _assert_same_audio(g, w)


def test_bf16_log_durations_match_jax_before_rounding(pipes):
    """Each bf16 log-duration within one bf16 ulp of JAX's bf16 value, and
    within 2× JAX's own bf16-vs-f32 gap; f32 within 1e-5."""
    for text, *_ in FRAME_TOTALS:
        ld = _log_durations(pipes, text)
        assert max_abs(ld["p32"], ld["j32"]) <= 1e-5, text
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ld["j16"]))) - 7)
        assert np.all(np.abs(ld["p16"] - ld["j16"]) <= ulp), text
        gap = max_abs(ld["j16"], ld["j32"])
        assert 0 < max_abs(ld["p16"], ld["j16"]) <= 2 * gap, text


def test_bf16_frame_flips(pipes):
    """The frame totals of ``FRAME_TOTALS`` in both packages and dtypes: the
    sentences bf16 moves by a frame, recorded (PERF.md, "By design")."""
    for text, j32, j16, p32, p16 in FRAME_TOTALS:
        got = []
        for jp in pipes["jax"]:
            got.append(int(np.asarray(_jax_stage_a(jp, text)[3]).sum()))
        for p in pipes["port"]:
            ids, lengths = p._encode_texts([text])
            with torch.no_grad():
                _, frames, _ = stage_a(p.model, torch.from_numpy(ids),
                                       torch.from_numpy(lengths))
            got.append(int(frames.sum()))
        assert got == [j32, j16, p32, p16], (text, got)


def _stage_b(pipe, ids, lengths, frames, jax_side):
    """Stage B of ``pipe`` on the integer ``frames`` at temperature 0 (a
    128-frame budget) → (audio [n·hop], mel [n, n_mels]) as f32 numpy. The
    encoder output is each package's own."""
    if jax_side:
        enc, _, _ = pipe._stage_a(pipe.params, jnp.asarray(ids),
                                  jnp.asarray(lengths))
        audio, mel, n = pipe._stage_b(pipe.params, enc, frames, jnp.int32(0),
                                      total_frames=128, temperature=0.0)
        n = int(np.asarray(n)[0])
        return (np.asarray(audio, np.float32)[0, :n * 256],
                np.asarray(mel, np.float32)[0, :n])
    with torch.no_grad():
        enc, _, _ = stage_a(pipe.model, torch.from_numpy(ids),
                            torch.from_numpy(lengths))
        disp = pipe._stage_b(enc, torch.from_numpy(np.array(frames)).long(),
                             128, 0, 0.0, False, 1, return_mel=True)
    audio, mels = pipe._fetch_rows(disp)
    return audio[0], mels[0]


def test_bf16_stage_b_on_jax_frames(pipes):
    """Stage B in bf16 on JAX's bf16 integer frames, for the sentence whose
    frame total bf16 moves in JAX and not in the port (98 frames).

    JAX's bf16 gate (``tests/test_pipeline.py``: mel max|Δ| < 0.05, mean
    < 0.01, audio < 1e-3 against f32) was set on small random weights; on
    these trained weights JAX's own bf16 stage B misses it against JAX's
    f32 (mel max 0.24, mean 0.022, audio 0.044 on the CPU), so the port
    cannot be held to it either. The port is held instead (1) to JAX's
    bf16 within 2× that gap, measure by measure, and (2) to f32 within the
    gap itself: the port's bf16 is no further from f32 than JAX's is."""
    j32, j16 = pipes["jax"]
    _, p16 = pipes["port"]
    ids, lengths, _, jframes = _jax_stage_a(j16, FLIP)
    assert int(np.asarray(jframes).sum()) == 98
    ref = _stage_b(j32, ids, lengths, jframes, True)
    jax16 = _stage_b(j16, ids, lengths, jframes, True)
    got = _stage_b(p16, ids, lengths, jframes, False)
    assert len(got[0]) == len(ref[0]) == 98 * 256
    assert float(np.abs(ref[0]).max()) > 0.05  # speech-like signal

    def gaps(a, b):
        d_mel = np.abs(a[1] - b[1])
        return (d_mel.max(), d_mel.mean(), np.abs(a[0] - b[0]).max())

    jax_gap = gaps(jax16, ref)
    assert not (jax_gap[0] < 0.05 and jax_gap[1] < 0.01
                and jax_gap[2] < 1e-3)  # JAX misses its own gate here
    for name, port, jax in zip(("mel max", "mel mean", "audio max"),
                               gaps(got, jax16), jax_gap):
        assert port <= 2 * jax, (name, port, jax)
    for name, port, jax in zip(("mel max", "mel mean", "audio max"),
                               gaps(got, ref), jax_gap):
        assert port <= jax, (name, port, jax)
