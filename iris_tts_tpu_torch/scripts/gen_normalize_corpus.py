"""Generate the corpus-scale normalization golden.

The port's counterpart of the JAX package's
``scripts/gen_normalize_corpus.py``: templates × seeded random values for
every normalization class (cardinals, ordinals, decimals, years, times,
dates written and ISO, currency, percents, fractions, mixed numbers,
ranges, roman numerals, units, phone numbers, abbreviations), through the
port's own ``text/normalize.normalize_text``.

Property checks run on every case at generation time: a digit that
survives normalization, or an output that a second pass changes, aborts
the run (exit 1). ``--audit N`` prints N random cases a class for review;
``--freeze`` writes the ``input || output`` pairs, class by class, to
``--output`` in the layout of ``tests/data/normalize_corpus_golden.txt``
(the frozen corpus the tests replay; its header is kept as it was frozen,
so at the default seed the two files are equal byte for byte).

Usage:
    python -m iris_tts_tpu_torch.scripts.gen_normalize_corpus \
        [--seed 20260819] [--audit N] [--freeze] \
        [--output outputs/normalize_corpus_golden.txt]
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

from iris_tts_tpu_torch.text.normalize import normalize_text

MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
UNITS = ["km", "kg", "mph", "GB", "cm", "lb", "oz", "ft", "mins", "hrs"]
CURR = ["$", "£", "€"]
ROMAN_TITLES = ["Henry", "Louis", "George", "Edward", "Charles"]
ROMAN = ["II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X",
         "XI", "XIV", "XVI"]


def gen_cases(rng: random.Random):
    """Yield (class_name, input_sentence) pairs."""
    for _ in range(60):
        n = rng.choice([rng.randint(0, 99), rng.randint(100, 9999),
                        rng.randint(10000, 999999), rng.randint(10**6, 10**9)])
        yield "cardinal", f"The station logged {n} events."
    for _ in range(40):
        n = rng.randint(1, 1000)
        yield "ordinal", f"She finished in {n}th place." if n % 10 not in (
            1, 2, 3) or n % 100 in (11, 12, 13) else (
            "ordinal",
            f"She finished in {n}{'st' if n % 10 == 1 else 'nd' if n % 10 == 2 else 'rd'} place.",
        )[1]
    for _ in range(40):
        y = rng.randint(1066, 2099)
        yield "year", f"The church was built in {y}."
    for _ in range(40):
        h, m = rng.randint(1, 12), rng.randint(0, 59)
        ap = rng.choice(["am", "pm", "AM", "P.M.", ""])
        sep = f"{h}:{m:02d}"
        yield "time", f"We meet at {sep} {ap}".strip() + "."
    for _ in range(40):
        mth = rng.choice(MONTHS)
        d = rng.randint(1, 28)
        y = rng.randint(1800, 2030)
        style = rng.random()
        if style < 0.5:
            yield "date", f"He arrived on {mth} {d}, {y}."
        else:
            yield "date", f"The letter was dated {d} {mth} {y}."
    for _ in range(30):
        y, mo, d = rng.randint(1900, 2099), rng.randint(1, 12), rng.randint(1, 28)
        yield "iso_date", f"Backup completed on {y}-{mo:02d}-{d:02d}."
    for _ in range(40):
        c = rng.choice(CURR)
        if rng.random() < 0.5:
            amount = f"{rng.randint(1, 999)}"
        else:
            amount = f"{rng.randint(0, 999)}.{rng.randint(0, 99):02d}"
        yield "currency", f"The ticket costs {c}{amount} today."
    for _ in range(30):
        v = f"{rng.randint(0, 99)}.{rng.randint(0, 9)}"
        yield "decimal", f"The sensor read {v} degrees."
    for _ in range(30):
        p = rng.choice([f"{rng.randint(1, 99)}",
                        f"{rng.randint(0, 99)}.{rng.randint(0, 9)}"])
        yield "percent", f"Support rose to {p}% this quarter."
    for _ in range(30):
        num, den = rng.choice([(1, 2), (1, 3), (2, 3), (1, 4), (3, 4),
                               (1, 8), (3, 8), (5, 8), (2, 5)])
        if rng.random() < 0.4:
            whole = rng.randint(1, 9)
            yield "mixed_number", f"Add {whole} {num}/{den} cups of flour."
        else:
            yield "fraction", f"Use {num}/{den} of the mixture."
    for _ in range(30):
        a = rng.randint(1, 400)
        b = a + rng.randint(1, 200)
        yield "range", f"Read pages {a}-{b} for homework."
    for _ in range(20):
        a = rng.randint(1900, 2015)
        b = a + rng.randint(1, 30)
        yield "year_range", f"The project ran {a}-{b} in total."
    for _ in range(25):
        name = rng.choice(ROMAN_TITLES)
        num = rng.choice(ROMAN)
        yield "roman_regnal", f"{name} {num} ruled for decades."
    for _ in range(20):
        num = rng.choice(ROMAN)
        yield "roman_cardinal", f"See Chapter {num} for details."
    for _ in range(25):
        n = rng.randint(1, 999)
        u = rng.choice(UNITS)
        yield "unit", f"It measured {n} {u} exactly."
    for _ in range(20):
        a, b, c = rng.randint(200, 999), rng.randint(200, 999), rng.randint(1000, 9999)
        yield "phone", f"Call {a}-{b}-{c} for assistance."
    surnames = ["Brown", "Clark", "Reyes", "Okafor", "Nguyen", "Patel",
                "Walsh", "Kim"]
    streets = ["Main", "Elm", "Oak", "Baker", "Union", "Maple", "Harbor"]
    saints = ["James", "Louis", "Patrick", "Helena", "Clair", "Thomas"]
    for _ in range(30):
        kind = rng.randrange(5)
        if kind == 0:  # title + surname
            abbr = rng.choice(["Dr.", "Mr.", "Mrs.", "Jr.", "Sr.", "Rev.",
                               "Capt.", "Lt."])
            who = rng.choice(surnames)
            if abbr in ("Jr.", "Sr."):
                yield "abbreviation", f"Ask {who} {abbr} about it."
            else:
                yield "abbreviation", f"Ask {abbr} {who} about it."
        elif kind == 1:  # street-sense St./Ave./Blvd./Rd.
            road = rng.choice(["St.", "Ave.", "Blvd.", "Rd."])
            name = rng.choice(streets)
            yield "abbreviation", rng.choice([
                f"They met on {name} {road} at noon.",
                f"Go down {name} {road} and turn left.",
                f"The shop on {name} {road} never closes.",
            ])
        elif kind == 2:  # saint-sense St.
            name = rng.choice(saints)
            yield "abbreviation", rng.choice([
                f"Visit St. {name} for the festival.",
                f"The church of St. {name} rang its bells.",
            ])
        elif kind == 3:  # etc./vs.
            abbr = rng.choice(["etc.", "vs."])
            if abbr == "vs.":
                a, b = rng.sample(surnames, 2)
                yield "abbreviation", f"The case of {a} vs. {b} continues."
            else:
                yield "abbreviation", "Bring maps, food, etc. as needed."
        else:  # Mt. / Fort / No.
            yield "abbreviation", rng.choice([
                f"Mt. {rng.choice(saints)} towers over the valley.",
                f"Take the No. {rng.randint(2, 99)} bus.",
                f"Ft. {rng.choice(surnames)} held out for weeks.",
            ])


def main(argv=None) -> dict:
    """Returns ``{"cases": total, "classes": n, "dropped": duplicates,
    "by_class": {class: [(input, output), ...]}, "frozen": path or
    None}``; exits 1 on a property failure."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--audit", type=int, default=0,
                    help="print N random cases per class for review")
    ap.add_argument("--freeze", action="store_true",
                    help="write the golden to --output")
    ap.add_argument("--output", type=str,
                    default="outputs/normalize_corpus_golden.txt",
                    help="where --freeze writes the golden")
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    by_class: dict[str, list[tuple[str, str]]] = {}
    problems = []
    seen: set[str] = set()
    dropped = 0
    for cls, src in gen_cases(rng):
        if src in seen:
            # Identical sentences inflate the case count without adding
            # coverage: keep the golden strictly distinct.
            dropped += 1
            continue
        seen.add(src)
        out = normalize_text(src)
        # property checks: no digits survive; idempotent
        if any(ch.isdigit() for ch in out):
            problems.append((cls, src, out, "digits survive"))
        if normalize_text(out) != out:
            problems.append((cls, src, out, "not idempotent"))
        by_class.setdefault(cls, []).append((src, out))

    total = sum(len(v) for v in by_class.values())
    print(f"{total} distinct cases in {len(by_class)} classes "
          f"({dropped} duplicates dropped)", file=sys.stderr)
    if problems:
        print(f"{len(problems)} PROPERTY FAILURES:", file=sys.stderr)
        for cls, src, out, why in problems[:20]:
            print(f"  [{cls}] {why}: {src!r} -> {out!r}", file=sys.stderr)
        sys.exit(1)

    if args.audit:
        for cls, cases in sorted(by_class.items()):
            print(f"== {cls} ({len(cases)}) ==")
            for src, out in rng.sample(cases, min(args.audit, len(cases))):
                print(f"  {src}\n    -> {out}")
    frozen = None
    if args.freeze:
        frozen = Path(args.output)
        lines = [
            "# Corpus-scale normalization golden (generated by",
            "# scripts/gen_normalize_corpus.py --freeze, seed "
            f"{args.seed}; audited per class).",
            "# input || expected",
        ]
        for cls, cases in sorted(by_class.items()):
            lines.append(f"## class: {cls}")
            lines.extend(f"{src} || {out}" for src, out in cases)
        frozen.parent.mkdir(parents=True, exist_ok=True)
        frozen.write_text("\n".join(lines) + "\n")
        print(f"froze {total} cases to {frozen}", file=sys.stderr)
    return {"cases": total, "classes": len(by_class), "dropped": dropped,
            "by_class": by_class, "frozen": frozen}


if __name__ == "__main__":
    main()
