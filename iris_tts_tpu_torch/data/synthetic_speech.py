"""Formant-synthesized English pseudo-speech corpus generator.

The port's own copy of the JAX package's ``data/synthetic_speech.py``: the
same seeded numpy generator, so one ``CorpusSpec`` gives byte-identical wavs,
TextGrids and metadata in both packages (phone labels come from the text
frontend's default pipeline, which is the same in both). It writes a
single-"speaker" corpus of real English sentences rendered by a Klatt-style
time-varying formant synthesizer, in the exact LJSpeech + MFA-TextGrid
layout the data layer consumes (:mod:`iris_tts_tpu_torch.data.ljspeech`).

Every acoustic regularity the models must learn exists by construction:
per-phone spectral structure (vowel formants, sibilant noise, plosive
closures and bursts, nasal murmur), per-phone and contextual duration
statistics, F0 declination with phrase-final fall, coarticulated formant
tracks, and harmonic-plus-noise excitation through resonators.

Ground truth durations are exact: each phone occupies an integer number of
mel hops, and TextGrid interval times are written as ``frames * hop / sr``
so :func:`iris_tts_tpu_torch.data.textgrid.durations_to_frames`
(``max(1, round(sec*sr/hop))``) recovers them bit-for-bit.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SR = 22050
HOP = 256

# ---------------------------------------------------------------------------
# Phone inventory: acoustic targets per stress-stripped ARPABET phone
# ---------------------------------------------------------------------------
#
# kind: V=vowel/diphthong, G=glide/approximant, N=nasal, F=fricative,
#       P=plosive, A=affricate
# formants: (F1, F2, F3) Hz targets (female-range values; LJSpeech is a
#           female speaker, f0 ~ 170-220 Hz). Diphthongs carry a second
#           target reached at the end of the phone.
# voiced: glottal-pulse excitation present
# noise: (center_hz, bandwidth_hz, amplitude) of the frication component
# closure: fraction of the phone that is (near-)silent occlusion, with the
#          burst+frication squeezed into the tail (plosives/affricates)
# dur: (mean, std) of the phone duration in mel frames (1 frame = 11.6 ms)


@dataclass(frozen=True)
class PhoneSpec:
    kind: str
    formants: Tuple[float, float, float]
    formants_end: Optional[Tuple[float, float, float]] = None
    voiced: bool = True
    amp: float = 1.0
    noise: Optional[Tuple[float, float, float]] = None
    closure: float = 0.0
    dur: Tuple[float, float] = (8.0, 2.0)


def _v(f1, f2, f3, dur=(9.0, 2.5), end=None, amp=1.0):
    return PhoneSpec("V", (f1, f2, f3), formants_end=end, dur=dur, amp=amp)


PHONES: Dict[str, PhoneSpec] = {
    # -- monophthongs (Peterson/Barney-style female targets) ----------------
    "IY": _v(310, 2790, 3310),
    "IH": _v(430, 2480, 3070, dur=(7.0, 2.0)),
    "EH": _v(610, 2330, 2990, dur=(8.0, 2.0)),
    "AE": _v(860, 2050, 2850, dur=(10.0, 2.5)),
    "AA": _v(850, 1220, 2810, dur=(10.0, 2.5)),
    "AO": _v(590, 920, 2710, dur=(10.0, 2.5)),
    "UH": _v(470, 1160, 2680, dur=(6.0, 1.5)),
    "UW": _v(370, 950, 2670),
    "AH": _v(760, 1400, 2780, dur=(6.0, 1.5)),
    "ER": _v(500, 1640, 1960),
    # -- diphthongs: start → end formant glide ------------------------------
    "EY": _v(610, 2330, 2990, dur=(11.0, 2.5), end=(310, 2790, 3310)),
    "AY": _v(850, 1220, 2810, dur=(13.0, 3.0), end=(370, 2600, 3100)),
    "OY": _v(590, 920, 2710, dur=(13.0, 3.0), end=(430, 2480, 3070)),
    "AW": _v(860, 1550, 2850, dur=(13.0, 3.0), end=(430, 1000, 2680)),
    "OW": _v(590, 1000, 2710, dur=(11.0, 2.5), end=(370, 950, 2670)),
    # -- glides / approximants ----------------------------------------------
    "W": PhoneSpec("G", (290, 610, 2150), dur=(5.0, 1.5), amp=0.7),
    "Y": PhoneSpec("G", (310, 2790, 3310), dur=(5.0, 1.5), amp=0.7),
    "R": PhoneSpec("G", (310, 1060, 1380), dur=(6.0, 1.5), amp=0.7),
    "L": PhoneSpec("G", (360, 1300, 2880), dur=(6.0, 1.5), amp=0.7),
    # -- nasals: low murmur, damped upper structure -------------------------
    "M": PhoneSpec("N", (250, 900, 2200), dur=(6.0, 1.5), amp=0.45),
    "N": PhoneSpec("N", (250, 1700, 2600), dur=(6.0, 1.5), amp=0.45),
    "NG": PhoneSpec("N", (250, 2000, 2800), dur=(7.0, 1.5), amp=0.45),
    # -- unvoiced fricatives: pure shaped noise ------------------------------
    "S": PhoneSpec("F", (0, 0, 0), voiced=False, dur=(9.0, 2.0),
                   noise=(6500, 2000, 0.50)),
    "SH": PhoneSpec("F", (0, 0, 0), voiced=False, dur=(9.0, 2.0),
                    noise=(3300, 1500, 0.55)),
    "F": PhoneSpec("F", (0, 0, 0), voiced=False, dur=(8.0, 2.0),
                   noise=(4500, 4000, 0.22)),
    "TH": PhoneSpec("F", (0, 0, 0), voiced=False, dur=(7.0, 2.0),
                    noise=(5000, 4000, 0.18)),
    "HH": PhoneSpec("F", (800, 1800, 2800), voiced=False, dur=(5.0, 1.5),
                    noise=(1500, 1800, 0.25)),
    # -- voiced fricatives: murmur + noise mix -------------------------------
    "Z": PhoneSpec("F", (250, 1500, 2500), dur=(8.0, 2.0), amp=0.35,
                   noise=(6000, 2000, 0.35)),
    "ZH": PhoneSpec("F", (250, 1800, 2600), dur=(8.0, 2.0), amp=0.35,
                    noise=(3200, 1500, 0.38)),
    "V": PhoneSpec("F", (250, 1100, 2300), dur=(6.0, 1.5), amp=0.35,
                   noise=(4000, 3500, 0.14)),
    "DH": PhoneSpec("F", (250, 1300, 2500), dur=(5.0, 1.5), amp=0.35,
                    noise=(4500, 3500, 0.12)),
    # -- plosives: closure + burst (+ aspiration for unvoiced) ---------------
    "P": PhoneSpec("P", (400, 1100, 2400), voiced=False, dur=(7.0, 1.5),
                   noise=(900, 900, 0.45), closure=0.62),
    "T": PhoneSpec("P", (400, 1800, 2800), voiced=False, dur=(7.0, 1.5),
                   noise=(4200, 2500, 0.50), closure=0.62),
    "K": PhoneSpec("P", (400, 1500, 2500), voiced=False, dur=(7.0, 1.5),
                   noise=(2200, 1500, 0.50), closure=0.62),
    "B": PhoneSpec("P", (350, 1000, 2300), dur=(5.0, 1.2), amp=0.30,
                   noise=(800, 800, 0.25), closure=0.55),
    "D": PhoneSpec("P", (350, 1700, 2700), dur=(5.0, 1.2), amp=0.30,
                   noise=(3800, 2200, 0.28), closure=0.55),
    "G": PhoneSpec("P", (350, 1400, 2400), dur=(5.0, 1.2), amp=0.30,
                   noise=(2000, 1400, 0.28), closure=0.55),
    # -- affricates: plosive closure into sibilant frication -----------------
    "CH": PhoneSpec("A", (400, 1800, 2800), voiced=False, dur=(9.0, 2.0),
                    noise=(3300, 1500, 0.50), closure=0.40),
    "JH": PhoneSpec("A", (350, 1700, 2700), dur=(8.0, 2.0), amp=0.30,
                    noise=(3200, 1500, 0.40), closure=0.35),
}

_FORMANT_BW = (90.0, 120.0, 170.0)  # resonator bandwidths (Hz)


# ---------------------------------------------------------------------------
# Frame-track construction (all numpy, vectorized where it matters)
# ---------------------------------------------------------------------------


def sample_durations(
    phones: Sequence[str], rng: np.random.Generator, rate: float = 1.0,
    final_lengthen: float = 1.35,
) -> np.ndarray:
    """Integer frame durations per phone: per-phone log-ish normal stats x
    utterance speaking rate, phrase-final lengthening on the last 2 phones."""
    durs = np.empty(len(phones), np.int64)
    for i, p in enumerate(phones):
        spec = PHONES[p]
        mean, std = spec.dur
        d = rng.normal(mean, std) * rate
        if i >= len(phones) - 2:
            d *= final_lengthen
        durs[i] = max(2, int(round(d)))
    return durs


@dataclass
class FrameTracks:
    """Per-mel-frame synthesis parameters for one utterance."""

    formants: np.ndarray  # [T, 3] Hz
    voiced_amp: np.ndarray  # [T]
    noise_amp: np.ndarray  # [T]
    noise_center: np.ndarray  # [T] Hz
    noise_bw: np.ndarray  # [T] Hz
    f0: np.ndarray  # [T] Hz (of the voicing source; meaningful where voiced)

    @property
    def num_frames(self) -> int:
        return len(self.f0)


def build_tracks(
    phones: Sequence[str],
    durs: np.ndarray,
    rng: np.random.Generator,
    f0_base: float = 190.0,
) -> FrameTracks:
    """Phone sequence + integer frame durations → smooth per-frame tracks.

    Formant targets are placed at phone centers and linearly interpolated
    between neighbours (coarticulation); voiced/noise amplitudes get short
    attack/decay ramps inside each phone; F0 declines ~18% over the
    utterance with a final fall and per-frame jitter.
    """
    total = int(durs.sum())
    starts = np.concatenate([[0], np.cumsum(durs)[:-1]])
    centers = starts + durs / 2.0

    # --- formant targets at centers, interpolated across the utterance ----
    tgt_start = np.array([PHONES[p].formants for p in phones], np.float64)
    tgt_end = np.array(
        [
            PHONES[p].formants_end or PHONES[p].formants
            for p in phones
        ],
        np.float64,
    )
    # Diphthongs: two anchor points (0.25/0.85 through the phone); others
    # collapse to one center anchor.
    anchor_t, anchor_f = [], []
    for i, p in enumerate(phones):
        if PHONES[p].formants_end is not None:
            anchor_t += [starts[i] + 0.25 * durs[i], starts[i] + 0.85 * durs[i]]
            anchor_f += [tgt_start[i], tgt_end[i]]
        else:
            anchor_t.append(centers[i])
            anchor_f.append(tgt_start[i])
    anchor_t = np.asarray(anchor_t)
    anchor_f = np.asarray(anchor_f)
    t_axis = np.arange(total, dtype=np.float64)
    formants = np.stack(
        [np.interp(t_axis, anchor_t, anchor_f[:, j]) for j in range(3)],
        axis=1,
    )

    # --- amplitude envelopes (per phone, with intra-phone shape) ----------
    voiced_amp = np.zeros(total)
    noise_amp = np.zeros(total)
    noise_center = np.full(total, 3000.0)
    noise_bw = np.full(total, 2000.0)
    for i, p in enumerate(phones):
        spec = PHONES[p]
        s, d = int(starts[i]), int(durs[i])
        seg = slice(s, s + d)
        env = np.ones(d)
        ramp = max(1, d // 4)
        env[:ramp] *= np.linspace(0.3, 1.0, ramp)
        env[-ramp:] *= np.linspace(1.0, 0.5, ramp)
        v = spec.amp * env if spec.voiced or spec.amp < 1.0 else env
        if spec.kind in ("P", "A"):
            # closure: silence (unvoiced) or weak voice bar, burst at release
            n_clo = int(round(spec.closure * d))
            v = np.concatenate(
                [np.full(n_clo, 0.12 if spec.voiced else 0.0),
                 spec.amp * np.ones(d - n_clo)]
            ) * env
            if spec.noise:
                na = np.zeros(d)
                na[n_clo:] = spec.noise[2]
                noise_amp[seg] = na * env
        elif spec.noise:
            noise_amp[seg] = spec.noise[2] * env
        if spec.noise:
            noise_center[seg] = spec.noise[0]
            noise_bw[seg] = spec.noise[1]
        voiced_amp[seg] = v if spec.voiced else 0.0

    # --- F0 contour: declination + final fall + jitter ---------------------
    decl = f0_base * (1.0 - 0.18 * t_axis / max(total - 1, 1))
    fall = np.ones(total)
    # final fall spans the last TWO phones (matching the phrase-final
    # lengthening window in sample_durations)
    n_fall = min(total, int(durs[-1] + durs[max(len(durs) - 2, 0)]))
    fall[-n_fall:] = np.linspace(1.0, 0.82, n_fall)
    jitter = 1.0 + 0.02 * rng.standard_normal(total)
    # small per-phone accent bumps so F0 has word-level structure
    accent = np.ones(total)
    for i, p in enumerate(phones):
        if PHONES[p].kind == "V" and rng.random() < 0.35:
            s, d = int(starts[i]), int(durs[i])
            accent[s:s + d] *= 1.0 + 0.08 * np.hanning(d)
    f0 = decl * fall * jitter * accent

    return FrameTracks(
        formants=formants,
        voiced_amp=voiced_amp,
        noise_amp=noise_amp,
        noise_center=noise_center,
        noise_bw=noise_bw,
        f0=f0,
    )


# ---------------------------------------------------------------------------
# Waveform rendering: excitation → time-varying resonator cascade
# ---------------------------------------------------------------------------


def _resonator_coeffs(freq: np.ndarray, bw: float | np.ndarray):
    """Two-pole resonator (Klatt) coefficients for arrays of center
    frequencies: y[n] = A x[n] + B y[n-1] + C y[n-2]."""
    freq = np.clip(freq, 50.0, SR / 2 - 200.0)
    r = np.exp(-np.pi * np.asarray(bw, np.float64) / SR)
    b = 2.0 * r * np.cos(2.0 * np.pi * freq / SR)
    c = np.broadcast_to(-(r * r), b.shape)
    a = 1.0 - b - c
    return a, b, c


def _filter_frames(x: np.ndarray, freqs: np.ndarray, bws, n_sections: int):
    """Cascade of per-frame-constant resonators over a sample stream.

    ``x`` is [T*HOP]; ``freqs`` is [T, n_sections] per-frame center
    frequencies. Runs scipy's C lfilter per (frame, section) with carried
    state — ~6 small filter calls per 11.6 ms frame.
    """
    from scipy.signal import lfilter

    T = freqs.shape[0]
    y = x
    for s in range(n_sections):
        a, b, c = _resonator_coeffs(freqs[:, s], bws[s])
        out = np.empty_like(y)
        zi = np.zeros(2)
        for t in range(T):
            seg = slice(t * HOP, (t + 1) * HOP)
            # IIR: b0=a[t]; a-coeffs (1, -b[t], -c[t])
            out[seg], zi = lfilter(
                [a[t]], [1.0, -b[t], -c[t]], y[seg], zi=zi
            )
        y = out
    return y


def render_audio(tracks: FrameTracks, rng: np.random.Generator) -> np.ndarray:
    """FrameTracks → float32 waveform of exactly ``num_frames * HOP``
    samples (the frame↔sample alignment contract)."""
    T = tracks.num_frames
    n = T * HOP

    # --- voiced source: glottal pulse train ---------------------------------
    # Sample-rate F0 track → cumulative phase → impulse at each wrap; then a
    # one-pole lowpass (leaky integrator) gives the -6 dB/oct glottal slope.
    from scipy.signal import lfilter

    f0_s = np.repeat(tracks.f0, HOP)
    phase = np.cumsum(f0_s) / SR
    pulses = np.diff(np.floor(phase), prepend=0.0)
    # shimmer: per-pulse amplitude variation
    pulses *= 1.0 + 0.05 * rng.standard_normal(n)
    # leaky integrator: the -6 dB/oct glottal spectral slope
    glottal = lfilter([1.0], [1.0, -0.94], pulses)
    voiced = glottal * np.repeat(tracks.voiced_amp, HOP)
    # breathiness: a little noise wherever there is voicing
    voiced += 0.015 * rng.standard_normal(n) * np.repeat(
        tracks.voiced_amp, HOP
    )

    # formant cascade on the voiced+aspiration path
    voiced = _filter_frames(voiced, tracks.formants, _FORMANT_BW, 3)

    # --- frication source: bandpassed noise, parallel path ------------------
    namp = np.repeat(tracks.noise_amp, HOP)
    if namp.any():
        noise = rng.standard_normal(n) * namp
        fric = _filter_frames(
            noise, tracks.noise_center[:, None],
            (np.maximum(tracks.noise_bw, 500.0),), 1,
        )
    else:
        fric = 0.0

    audio = voiced + fric
    peak = np.abs(audio).max() or 1.0
    audio = (0.65 / peak) * audio
    return audio.astype(np.float32)


# ---------------------------------------------------------------------------
# Sentence generator: real English, frontend-driven
# ---------------------------------------------------------------------------

_SUBJECTS = [
    "the teacher", "a young sailor", "my brother", "the old gardener",
    "our neighbor", "the quiet librarian", "a curious child", "the pilot",
    "the famous painter", "her cousin", "the night watchman", "a stranger",
    "the merchant", "the doctor", "an old friend", "the carpenter",
]
_VERBS = [
    "watched", "remembered", "described", "painted", "followed",
    "discovered", "carried", "repaired", "measured", "collected",
    "borrowed", "finished", "studied", "delivered", "imagined", "found",
]
_OBJECTS = [
    "the silver river", "an ancient map", "the wooden bridge",
    "a basket of apples", "the broken clock", "the morning paper",
    "a field of lavender", "the distant mountains", "an empty harbor",
    "the garden wall", "a flock of geese", "the winter market",
    "the copper kettle", "a narrow staircase", "the village square",
]
_TAILS = [
    "before sunrise", "near the station", "after the storm",
    "during the festival", "in early autumn", "without a sound",
    "by the light of the moon", "on the far side of town",
    "while the rain fell", "under the oak tree", "every single morning",
    "with great care", "", "", "",
]
_NUMERIC_TAILS = [
    "for 12 years", "in 1894", "at 7 o'clock", "on March 3rd",
    "for $20", "over 300 miles", "at half past 9", "in the year 2005",
    "for 45 minutes", "with 16 men",
]


def generate_sentences(n: int, seed: int = 0) -> List[str]:
    """n unique English sentences from a template grammar; ~20% carry a
    numeric/date expression so the corpus exercises the rule normalizer
    (the pynini-equivalent path, reference text.py:69-77)."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    seen = set()
    while len(out) < n:
        s = rng.choice(_SUBJECTS)
        v = rng.choice(_VERBS)
        o = rng.choice(_OBJECTS)
        tail = (
            rng.choice(_NUMERIC_TAILS)
            if rng.random() < 0.2
            else rng.choice(_TAILS)
        )
        sent = f"{s} {v} {o}"
        if tail:
            sent += f" {tail}"
        if rng.random() < 0.3:
            s2, v2, o2 = (
                rng.choice(_SUBJECTS), rng.choice(_VERBS), rng.choice(_OBJECTS)
            )
            sent += f", and {s2} {v2} {o2}"
        sent = sent[0].upper() + sent[1:] + "."
        if sent not in seen:
            seen.add(sent)
            out.append(sent)
    return out


# ---------------------------------------------------------------------------
# Corpus writer: LJSpeech layout + MFA-style TextGrids
# ---------------------------------------------------------------------------


def _write_textgrid(path: Path, phones: Sequence[str], durs: np.ndarray,
                    text: str) -> None:
    """MFA-shaped 2-tier TextGrid with frame-quantized interval times, so
    durations_to_frames round-trips the exact integer frame counts."""
    times = [
        float(t) for t in np.concatenate([[0], np.cumsum(durs)]) * HOP / SR
    ]
    total = times[-1]
    intervals = "\n".join(
        f"""        intervals [{i + 1}]:
            xmin = {times[i]!r}
            xmax = {times[i + 1]!r}
            text = "{p}" """
        for i, p in enumerate(phones)
    )
    path.write_text(
        f"""File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = {total!r}
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = {total!r}
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = {total!r}
            text = "{text.replace('"', "'")}"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = {total!r}
        intervals: size = {len(phones)}
{intervals}
"""
    )


@dataclass
class CorpusSpec:
    n_utterances: int = 600
    seed: int = 1337
    f0_base: float = 190.0
    rate_jitter: float = 0.12  # per-utterance speaking-rate sigma
    trailing_silence_frames: Tuple[int, int] = (2, 8)  # uniform range


def generate_corpus(
    root_dir: str | Path,
    spec: CorpusSpec = CorpusSpec(),
    text_processor=None,
    progress_every: int = 200,
) -> Tuple[Path, Path]:
    """Generate the corpus under ``root_dir``: LJSpeech-1.1/{wavs,
    metadata.csv} + aligned/*.TextGrid. Returns (corpus_root, alignment_dir).

    Deterministic for a given spec (one generator seeds everything).
    """
    from iris_tts_tpu_torch.data.audio_io import write_wav
    from iris_tts_tpu_torch.text.frontend import create_text_processor

    tp = text_processor or create_text_processor()
    root = Path(root_dir) / "LJSpeech-1.1"
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    align_dir = Path(root_dir) / "aligned"
    align_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(spec.seed)
    sentences = generate_sentences(spec.n_utterances, seed=spec.seed)
    meta_lines = []
    total_sec = 0.0
    for i, text in enumerate(sentences):
        sid = f"SYN1-{i:04d}"
        phones = tp.text_to_phonemes(text).split()
        missing = [p for p in phones if p not in PHONES]
        if missing:
            # character-fallback leakage etc. — drop rather than mis-render
            logger.warning("skipping %r: unrenderable phones %s", text,
                           missing)
            continue
        rate = float(np.exp(rng.normal(0.0, spec.rate_jitter)))
        durs = sample_durations(phones, rng, rate=rate)
        tracks = build_tracks(
            phones, durs, rng,
            f0_base=spec.f0_base * (1.0 + 0.03 * rng.standard_normal()),
        )
        audio = render_audio(tracks, rng)
        # trailing silence: real recordings have it; the mel-trim-to-Σdur
        # convention (ljspeech.py:268-286) must actually trim something
        sil = rng.integers(*spec.trailing_silence_frames) * HOP
        audio = np.concatenate([audio, np.zeros(sil, np.float32)])
        write_wav(root / "wavs" / f"{sid}.wav", audio, SR)
        _write_textgrid(align_dir / f"{sid}.TextGrid", phones, durs, text)
        meta_lines.append(f"{sid}|{text}|{text}")
        total_sec += len(audio) / SR
        if progress_every and (i + 1) % progress_every == 0:
            logger.info("generated %d/%d utterances (%.1f s audio)",
                        i + 1, len(sentences), total_sec)
    (root / "metadata.csv").write_text("\n".join(meta_lines) + "\n")
    (root / "corpus_spec.json").write_text(json.dumps({
        "n_utterances": len(meta_lines),
        "seed": spec.seed,
        "total_audio_sec": round(total_sec, 2),
        "generator": __name__,
    }, indent=2))
    logger.info("corpus: %d utterances, %.1f s (%.2f h) audio",
                len(meta_lines), total_sec, total_sec / 3600)
    return root, align_dir
