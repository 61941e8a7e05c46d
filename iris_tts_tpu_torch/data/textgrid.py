"""Praat TextGrid parser (long and short text formats) + MFA alignment IO.

The port's own copy of the JAX package's ``data/textgrid.py``: a
dependency-free parser of Montreal-Forced-Aligner output (reference
alignment.py:127-174). The MFA conventions it preserves:

* MFA writes two interval tiers: ``tiers[0]`` = words, ``tiers[1]`` = phones;
  alignment loading reads the **phones** tier (alignment.py:154-156),
* empty / whitespace-only marks (silences) are skipped (alignment.py:158),
* each phone becomes ``{phone, start, end, duration}`` in seconds
  (alignment.py:159-164).

MFA itself (a Kaldi/C++ tool) remains an external offline aligner invoked by
:class:`MFAAligner`; its outputs are parsed here and cached as a compact
binary duration table for the input pipeline (SURVEY.md §2.3).
"""

from __future__ import annotations

import re
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Interval:
    xmin: float
    xmax: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]


_QUOTED = r'"((?:[^"]|"")*)"'  # Praat escapes " as ""


def _unquote(s: str) -> str:
    return s.replace('""', '"')


def parse_textgrid(text: str) -> List[Tier]:
    """Parse TextGrid file contents into interval tiers.

    Handles the long ("ooTextFile" with ``item []`` blocks) and short
    (bare values) formats; point tiers are ignored (MFA emits interval
    tiers only).
    """
    if "IntervalTier" not in text and "TextTier" not in text:
        raise ValueError("not a TextGrid: no tier class markers found")
    if "item" in text and "=" in text:
        return _parse_long(text)
    return _parse_short(text)


def _parse_long(text: str) -> List[Tier]:
    tiers: List[Tier] = []
    # Split on tier headers.
    chunks = re.split(r'class\s*=\s*"(IntervalTier|TextTier)"', text)
    # chunks = [prefix, class1, body1, class2, body2, ...]
    for i in range(1, len(chunks) - 1, 2):
        klass, body = chunks[i], chunks[i + 1]
        if klass != "IntervalTier":
            continue
        name_m = re.search(rf'name\s*=\s*{_QUOTED}', body)
        name = _unquote(name_m.group(1)) if name_m else ""
        intervals = []
        for m in re.finditer(
            rf'xmin\s*=\s*([\d.eE+-]+)\s*\n\s*xmax\s*=\s*([\d.eE+-]+)'
            rf'\s*\n\s*text\s*=\s*{_QUOTED}',
            body,
        ):
            intervals.append(
                Interval(float(m.group(1)), float(m.group(2)),
                         _unquote(m.group(3)))
            )
        tiers.append(Tier(name=name, intervals=intervals))
    return tiers


def _parse_short(text: str) -> List[Tier]:
    # Short format: sequential tokens; strings quoted, numbers bare.
    tokens = re.findall(rf'{_QUOTED}|([-\d.eE+]+)', text)
    vals = [(_unquote(a) if a else None, b) for a, b in tokens]
    pos = 0

    def next_str():
        nonlocal pos
        while pos < len(vals) and vals[pos][0] is None:
            pos += 1
        s = vals[pos][0]
        pos += 1
        return s

    def next_num():
        nonlocal pos
        while pos < len(vals) and vals[pos][1] in (None, ""):
            pos += 1
        n = float(vals[pos][1])
        pos += 1
        return n

    next_str()  # "ooTextFile"
    next_str()  # "TextGrid"
    next_num()  # global xmin
    next_num()  # global xmax
    n_tiers = int(next_num())
    tiers = []
    for _ in range(n_tiers):
        klass = next_str()
        name = next_str()
        next_num()  # tier xmin
        next_num()  # tier xmax
        n_int = int(next_num())
        intervals = []
        for _ in range(n_int):
            if klass == "IntervalTier":
                xmin, xmax = next_num(), next_num()
                mark = next_str()
                intervals.append(Interval(xmin, xmax, mark))
            else:  # point tier: number + mark
                next_num()
                next_str()
        if klass == "IntervalTier":
            tiers.append(Tier(name=name, intervals=intervals))
    return tiers


def load_textgrid(path: str | Path) -> List[Tier]:
    raw = Path(path).read_bytes()
    for enc in ("utf-8", "utf-16", "latin-1"):
        try:
            return parse_textgrid(raw.decode(enc))
        except (UnicodeDecodeError, ValueError):
            continue
    raise ValueError(f"{path}: could not parse as TextGrid")


# ---------------------------------------------------------------------------
# MFA alignment loading (phones tier → duration dicts / cached table)
# ---------------------------------------------------------------------------


def load_alignment_phones(path: str | Path) -> List[Dict]:
    """One TextGrid → list of {phone, start, end, duration} (reference
    contract: alignment.py:148-167). Prefers the tier named 'phones',
    falling back to tier index 1."""
    tiers = load_textgrid(path)
    phone_tier: Optional[Tier] = None
    for t in tiers:
        if t.name.lower() == "phones":
            phone_tier = t
            break
    if phone_tier is None and len(tiers) > 1:
        phone_tier = tiers[1]
    if phone_tier is None:
        return []
    phones = []
    for iv in phone_tier.intervals:
        mark = iv.text.strip()
        if not mark:  # skip silences/empties
            continue
        phones.append(
            {
                "phone": mark,
                "start": iv.xmin,
                "end": iv.xmax,
                "duration": iv.xmax - iv.xmin,
            }
        )
    return phones


def load_alignments(output_dir: str | Path) -> Dict[str, List[Dict]]:
    """All ``*.TextGrid`` in a directory → {file_id: phones}
    (reference: alignment.py:127-174)."""
    out: Dict[str, List[Dict]] = {}
    for tg in sorted(Path(output_dir).glob("**/*.TextGrid")):
        out[tg.stem] = load_alignment_phones(tg)
    return out


def durations_to_frames(
    phones: List[Dict], sample_rate: int = 22050, hop_length: int = 256
) -> np.ndarray:
    """Seconds → integer frames: ``max(1, round(sec * sr / hop))``
    (reference: datasets.py:363-367)."""
    out = np.array(
        [
            max(1, int(round(p["duration"] * sample_rate / hop_length)))
            for p in phones
        ],
        dtype=np.int32,
    )
    return out


def save_alignment_cache(
    alignments: Dict[str, List[Dict]], path: str | Path
) -> None:
    """Persist parsed alignments as one compressed npz (phones as a string
    array, times as float32) — the 'cached binary duration table' of
    SURVEY.md §2.3, replacing per-epoch TextGrid reparsing."""
    keys = sorted(alignments)
    payload = {}
    for k in keys:
        ph = alignments[k]
        payload[f"{k}__phones"] = np.array(
            [p["phone"] for p in ph], dtype=np.str_
        )
        payload[f"{k}__times"] = np.array(
            [[p["start"], p["end"]] for p in ph], dtype=np.float32
        ).reshape(-1, 2)
    np.savez_compressed(path, __ids__=np.array(keys, dtype=np.str_), **payload)


def load_alignment_cache(path: str | Path) -> Dict[str, List[Dict]]:
    data = np.load(path, allow_pickle=False)
    out: Dict[str, List[Dict]] = {}
    for k in data["__ids__"]:
        phones = data[f"{k}__phones"]
        times = data[f"{k}__times"]
        out[str(k)] = [
            {
                "phone": str(p),
                "start": float(t[0]),
                "end": float(t[1]),
                "duration": float(t[1] - t[0]),
            }
            for p, t in zip(phones, times)
        ]
    return out


# ---------------------------------------------------------------------------
# MFA wrapper (external offline tool; parity with alignment.py:13-120)
# ---------------------------------------------------------------------------


class MFAAligner:
    """Thin wrapper around the external ``mfa`` CLI (Kaldi). The aligner
    stays an offline data-prep tool (SURVEY.md §2.3); this class only shells
    out and parses results."""

    def __init__(
        self,
        acoustic_model: str = "english_us_arpa",
        dictionary: str = "english_us_arpa",
    ):
        self.acoustic_model = acoustic_model
        self.dictionary = dictionary

    def download_models(self) -> None:
        subprocess.run(
            ["mfa", "model", "download", "acoustic", self.acoustic_model],
            check=True,
        )
        subprocess.run(
            ["mfa", "model", "download", "dictionary", self.dictionary],
            check=True,
        )

    def align(
        self,
        corpus_dir: str | Path,
        output_dir: str | Path,
        num_jobs: int = 4,
        clean: bool = True,
    ) -> None:
        cmd = [
            "mfa", "align",
            str(corpus_dir), self.dictionary, self.acoustic_model,
            str(output_dir), "-j", str(num_jobs),
        ]
        if clean:
            cmd.append("--clean")
        subprocess.run(cmd, check=True)

    @staticmethod
    def load_alignments(output_dir: str | Path) -> Dict[str, List[Dict]]:
        return load_alignments(output_dir)
