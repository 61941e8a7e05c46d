"""ARPABET pronunciation lexicon (CMUdict-format loader + built-in core).

The reference loads CMUdict through nltk (reference src/iris/text.py:
83-92) and also ships a raw ``data/cmu_dict.txt``. Here the lexicon is a plain
host-side hash table built from any CMUdict-format file (``WORD  PH1 PH2 ...``
with ``WORD(2)`` variants and ``;;;`` comments), plus a small built-in core
vocabulary so the frontend works out of the box without external downloads.
Out-of-lexicon words fall back to :mod:`iris_tts_tpu_torch.text.g2p`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

_STRESS_RE = re.compile(r"[0-2]")

# The 39 ARPABET phonemes (stress-stripped CMUdict symbol set).
ARPABET = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]

# Small built-in core lexicon (hand-written entries for very common words and
# the demo sentences) so the system runs with zero external data files.
_BUILTIN_ENTRIES = """
a AH
an AE N
and AE N D
are AA R
as AE Z
at AE T
be B IY
but B AH T
by B AY
can K AE N
do D UW
for F AO R
from F R AH M
had HH AE D
has HH AE Z
have HH AE V
he HH IY
hello HH AH L OW
her HH ER
his HH IH Z
how HH AW
i AY
if IH F
in IH N
is IH Z
it IH T
me M IY
my M AY
no N OW
not N AA T
of AH V
on AA N
one W AH N
or AO R
our AW ER
she SH IY
so S OW
speech S P IY CH
test T EH S T
text T EH K S T
that DH AE T
the DH AH
this DH IH S
to T UW
was W AA Z
we W IY
were W ER
what W AH T
when W EH N
which W IH CH
who HH UW
will W IH L
with W IH DH
world W ER L D
you Y UW
your Y AO R
"""


def strip_stress(phoneme: str) -> str:
    """Remove stress digits ('AH0' → 'AH'); reference text.py:196-198."""
    return _STRESS_RE.sub("", phoneme)


# Vendored full CMU Pronouncing Dictionary (public-domain data; the reference
# ships the same table at data/cmu_dict.txt and loads it via nltk at
# text.py:83-92). ~126k words; loaded by default so arbitrary English text
# gets dictionary pronunciations rather than rule-G2P guesses.
_VENDORED_CMUDICT = Path(__file__).resolve().parent / "data" / "cmu_dict.txt"

# Module-level cache of the parsed default table (stress-stripped). Parsing
# 135k lines costs a few hundred ms; instances copy the cached dict instead.
_DEFAULT_TABLE: Optional[Dict[str, List[str]]] = None


def _parse_cmudict_lines(
    raw: str, table: Dict[str, List[str]], keep_stress: bool
) -> None:
    """Parse CMUdict-format text into ``table`` (first pronunciation wins).

    Lines look like ``WORD  P1 P2 ...`` or ``WORD(2)  P1 ...`` for alternate
    pronunciations (skipped — the reference takes ``cmudict[word][0]``,
    text.py:177-183). Comment lines start with ``;;;`` or ``##``.
    """
    for line in raw.splitlines():
        line = line.strip()
        if not line or line.startswith(";;;") or line.startswith("##"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        word = parts[0].lower()
        if "(" in word:  # alternate pronunciation — first one wins
            continue
        phones = parts[1:]
        if not keep_stress:
            phones = [strip_stress(p) for p in phones]
        # Keep only plausible ARPABET symbols.
        if all(strip_stress(p) in _ARPABET_SET for p in phones):
            table.setdefault(word, phones)


def _default_table() -> Dict[str, List[str]]:
    """Built-in core + vendored CMUdict (if present), cached per process."""
    global _DEFAULT_TABLE
    if _DEFAULT_TABLE is None:
        table: Dict[str, List[str]] = {}
        # Dictionary first so its pronunciations win (reference-identical);
        # the built-in core only fills gaps when the data file is absent.
        if _VENDORED_CMUDICT.exists():
            _parse_cmudict_lines(
                _VENDORED_CMUDICT.read_text(encoding="latin-1"),
                table,
                keep_stress=False,
            )
        for line in _BUILTIN_ENTRIES.strip().splitlines():
            parts = line.split()
            table.setdefault(parts[0], parts[1:])
        _DEFAULT_TABLE = table
    return _DEFAULT_TABLE


class Lexicon:
    """Word → ARPABET pronunciation table.

    By default includes the full vendored CMUdict (126k+ words) plus the
    built-in core entries. Pass ``load_cmudict=False`` for the tiny built-in
    core only (useful for testing the G2P fallback).
    """

    def __init__(
        self,
        entries: Optional[Dict[str, List[str]]] = None,
        load_cmudict: bool = True,
    ):
        if load_cmudict:
            self._table: Dict[str, List[str]] = dict(_default_table())
        else:
            self._table = {}
            for line in _BUILTIN_ENTRIES.strip().splitlines():
                parts = line.split()
                self._table[parts[0]] = parts[1:]
        if entries:
            self._table.update(entries)

    @classmethod
    def from_cmudict_file(
        cls, path: str | Path, keep_stress: bool = False
    ) -> "Lexicon":
        """Parse a CMUdict-format file on top of the built-in core only
        (the explicit file fully defines the dictionary contents)."""
        lex = cls(load_cmudict=False)
        _parse_cmudict_lines(
            Path(path).read_text(encoding="latin-1"), lex._table, keep_stress
        )
        return lex

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._table.get(word.lower())

    def add(self, word: str, phones: List[str]) -> None:
        self._table[word.lower()] = list(phones)

    def __contains__(self, word: str) -> bool:
        return word.lower() in self._table

    def __len__(self) -> int:
        return len(self._table)


_ARPABET_SET = frozenset(ARPABET)
