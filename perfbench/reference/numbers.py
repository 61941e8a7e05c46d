"""Frozen copy of ``iris_tts_tpu_torch/text/numbers.py`` for the benchmark's reference (imports
adjusted; nothing of the port is imported).

Deterministic number → words expansion for text normalization.

The reference delegates number/date/currency verbalisation to NeMo's
pynini/OpenFst WFST grammars (reference src/iris/text.py:69-77,111-117),
a C++ dependency that cannot run here. This module is a deterministic
rule-based verbaliser covering the classes NeMo's English grammars handle:
cardinals, ordinals, decimals, negative numbers, currency ($, £, €), percents,
years, clock times (with am/pm), fractions and mixed numbers, numeric
ranges, roman numerals, and measurement-unit abbreviations. It is pure
host-side Python (normalization is inherently a host stage — SURVEY.md §2.3).
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    """Cardinal verbalisation of a non-negative integer."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    for value, name in _SCALE:
        if n >= value:
            major, rem = divmod(n, value)
            out = number_to_words(major) + " " + name
            if rem:
                out += " " + number_to_words(rem)
            return out
    return _ONES[0]  # unreachable


def ordinal_to_words(n: int) -> str:
    """Ordinal verbalisation ('3rd' → 'third', '21st' → 'twenty first')."""
    words = number_to_words(n)
    parts = words.split(" ")
    last = parts[-1]
    if last in _ORDINAL_SPECIAL:
        parts[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    else:
        parts[-1] = last + "th"
    return " ".join(parts)


def year_to_words(n: int) -> str:
    """Year-style reading: 1984 → 'nineteen eighty four', 2007 → 'two
    thousand seven', 1900 → 'nineteen hundred'."""
    if 1000 <= n <= 9999:
        high, low = divmod(n, 100)
        if high % 10 == 0:
            # 2000/2007-style: read as a full cardinal ("two thousand
            # seven") — checked before the "X hundred" form so 2000 is not
            # "twenty hundred".
            return number_to_words(n)
        if low == 0:
            return number_to_words(high) + " hundred"
        if low < 10:
            return number_to_words(high) + " oh " + number_to_words(low)
        return number_to_words(high) + " " + number_to_words(low)
    return number_to_words(n)


def digits_to_words(s: str) -> str:
    """Digit-by-digit reading ('007' → 'zero zero seven')."""
    return " ".join(_ONES[int(c)] for c in s if c.isdigit())


def decimal_to_words(whole: str, frac: str) -> str:
    head = number_to_words(int(whole)) if whole else "zero"
    return head + " point " + digits_to_words(frac)


def _money_words(amount: str, unit: str, cent_unit: str) -> str:
    if "." in amount:
        whole, frac = amount.split(".")
        frac = (frac + "00")[:2]
    else:
        whole, frac = amount, ""
    whole_n = int(whole.replace(",", "")) if whole else 0
    out = number_to_words(whole_n) + " " + (unit if whole_n == 1 else unit + "s")
    cents = int(frac) if frac else 0
    if cents:
        out += (
            " and "
            + number_to_words(cents)
            + " "
            + (cent_unit if cents == 1 else cent_unit + "s")
        )
    return out


def time_to_words(h: int, m: int, suffix: str = "") -> str:
    """Clock reading; ``suffix`` is the spoken am/pm tail ('ay em' /
    'pee em' — letter-name words present in CMUdict, so the G2P stage
    never guesses)."""
    if m == 0:
        out = number_to_words(h) + (" o'clock" if not suffix else "")
    elif m < 10:
        out = number_to_words(h) + " oh " + number_to_words(m)
    else:
        out = number_to_words(h) + " " + number_to_words(m)
    return out + (" " + suffix if suffix else "")


_FRACTION_SPECIAL = {2: ("half", "halves"), 4: ("quarter", "quarters")}


def fraction_to_words(num: int, den: int) -> str:
    """'3/4' → 'three quarters', '1/2' → 'one half', '2/5' → 'two fifths'."""
    if den in _FRACTION_SPECIAL:
        one, many = _FRACTION_SPECIAL[den]
        part = one if num == 1 else many
    else:
        part = ordinal_to_words(den)
        if num != 1:
            part += "s"
    return number_to_words(num) + " " + part


# Roman numerals I..MMMCMXCIX (subtractive notation).
_ROMAN_VALUES = [
    ("M", 1000), ("CM", 900), ("D", 500), ("CD", 400), ("C", 100),
    ("XC", 90), ("L", 50), ("XL", 40), ("X", 10), ("IX", 9), ("V", 5),
    ("IV", 4), ("I", 1),
]
_RE_ROMAN_VALID = re.compile(
    r"M{0,3}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})$"
)


def roman_to_int(s: str):
    """Parse an uppercase roman numeral; None if not well-formed."""
    if not s or not _RE_ROMAN_VALID.match(s):
        return None
    i, total = 0, 0
    for sym, val in _ROMAN_VALUES:
        while s.startswith(sym, i):
            total += val
            i += len(sym)
    return total if i == len(s) else None


_CURRENCIES = {"$": ("dollar", "cent"), "£": ("pound", "penny"), "€": ("euro", "cent")}

# Measurement-unit abbreviations read after a number ("5 km" → "five
# kilometers"). Only unambiguous abbreviations are listed — bare "m"/"g"/"in"
# are real words or too ambiguous, so they are left alone.
_UNITS = {
    "km/h": ("kilometer per hour", "kilometers per hour"),
    "kph": ("kilometer per hour", "kilometers per hour"),
    "mph": ("mile per hour", "miles per hour"),
    "km": ("kilometer", "kilometers"),
    "cm": ("centimeter", "centimeters"),
    "mm": ("millimeter", "millimeters"),
    "kg": ("kilogram", "kilograms"),
    "mg": ("milligram", "milligrams"),
    "lbs": ("pound", "pounds"),
    "lb": ("pound", "pounds"),
    "oz": ("ounce", "ounces"),
    "ft": ("foot", "feet"),
    "mi": ("mile", "miles"),
    "ghz": ("gigahertz", "gigahertz"),
    "mhz": ("megahertz", "megahertz"),
    "khz": ("kilohertz", "kilohertz"),
    "hz": ("hertz", "hertz"),
    "gb": ("gigabyte", "gigabytes"),
    "mb": ("megabyte", "megabytes"),
    "kb": ("kilobyte", "kilobytes"),
    "tb": ("terabyte", "terabytes"),
    "hrs": ("hour", "hours"),
    "hr": ("hour", "hours"),
    "mins": ("minute", "minutes"),
    "min": ("minute", "minutes"),
    "secs": ("second", "seconds"),
    "sec": ("second", "seconds"),
}

_RE_CURRENCY = re.compile(r"([$£€])\s?(\d[\d,]*(?:\.\d+)?)")
_RE_PERCENT = re.compile(r"(\d[\d,]*(?:\.\d+)?)\s?%")
# A trailing abbreviation dot is consumed ONLY when the sentence clearly
# continues (lowercase/digit follows): "6 ft. tall" → "six feet tall", but
# "26 mins." keeps the dot as the sentence terminator so sentence chunking
# still splits there.
# (?-i: the lookahead must stay case-sensitive even inside IGNORECASE
# patterns — a capital letter after the dot means a new sentence.)
_DOT_IF_MIDSENTENCE = r"(?:\.(?=\s+(?-i:[a-z0-9])))?"
_AMPM_PAT = r"([ap])\.?m\b" + _DOT_IF_MIDSENTENCE
# "10:30", "10:30 am", "10:30 P.M."
_RE_TIME = re.compile(
    r"\b(\d{1,2}):(\d{2})(?:\s?" + _AMPM_PAT + r")?", re.IGNORECASE
)
# "10 am" / "7 P.M." (no minutes)
_RE_TIME_BARE = re.compile(
    r"\b(\d{1,2})\s?" + _AMPM_PAT, re.IGNORECASE
)
_RE_UNIT = re.compile(
    r"\b(\d[\d,]*(?:\.\d+)?)\s?(" + "|".join(
        re.escape(u) for u in _UNITS
    ) + r")\b" + _DOT_IF_MIDSENTENCE,
    re.IGNORECASE,
)
_RE_DEGREES = re.compile(r"\b(\d[\d,]*(?:\.\d+)?)\s?°\s?([CF])?(?=\W|$)")
_RE_ORDINAL = re.compile(r"\b(\d+)(st|nd|rd|th)\b")
# "2 1/2" (mixed number) and "3/4" (plain fraction; not part of a date
# like 3/4/1999)
_RE_MIXED = re.compile(r"\b(\d+)\s+(\d{1,2})\s?/\s?(\d{1,3})\b(?!\s?/)")
_RE_FRACTION = re.compile(r"(?<![\d/])\b(\d{1,3})\s?/\s?(\d{1,3})\b(?!\s?/)")
# ISO dates ("2020-08-17") verbalize as month-day-year, matched before the
# range/year/int rules would shred them.
_RE_ISO_DATE = re.compile(
    r"\b(1[89]\d\d|20\d\d)-(0?[1-9]|1[0-2])-(0?[1-9]|[12]\d|3[01])\b(?!-)"
)
_MONTH_NAMES = (
    "january", "february", "march", "april", "may", "june", "july",
    "august", "september", "october", "november", "december",
)
# Telephone shapes ("555-1234", "212-555-1234", "212.555.1234"): NANP
# digit-by-digit reading, matched before the range rule.
_RE_PHONE = re.compile(
    r"\b(?:(\d{3})[-. ])?(\d{3})[-.](\d{4})\b(?![-.\d])"
)

# "10-20", "1914–1918": a range only when low < high (so phone-number-like
# strings fall through to plain number reading). Guarded on BOTH edges
# against digit/hyphen/slash neighbours so the "08-17" tail of an ISO date
# ("2020-08-17") or a phone fragment never reads as a range.
_RE_RANGE = re.compile(
    r"(?<![\d\-–/.:])\b(\d{1,4})\s?[-–]\s?(\d{1,4})\b(?![-–\d])"
)
_RE_DECIMAL = re.compile(r"\b(\d+)\.(\d+)\b")
_RE_YEAR = re.compile(r"\b(1[1-9]\d\d|20\d\d)s?\b")
_RE_INT = re.compile(r"\b\d[\d,]*\b")

_AMPM = {"a": "ay em", "p": "pee em"}


def _amount_words(amount: str) -> str:
    """Cardinal or decimal reading of a digit string (commas stripped)."""
    amount = amount.replace(",", "")
    if "." in amount:
        w, f = amount.split(".")
        return decimal_to_words(w, f)
    return number_to_words(int(amount))


def _is_one(amount: str) -> bool:
    """Singular test for unit/degree agreement ("1", "1.0", "1.00", ...)."""
    try:
        return float(amount.replace(",", "")) == 1.0
    except ValueError:
        return False


def _is_year(n: int) -> bool:
    return 1100 <= n <= 2099


def expand_numbers(text: str) -> str:
    """Expand all supported numeric constructs in ``text`` to words.

    Runs before lowercasing (normalize.py order), so am/pm and unit
    abbreviations match in any case.
    """

    def _currency(m: re.Match) -> str:
        unit, cent = _CURRENCIES[m.group(1)]
        return _money_words(m.group(2).replace(",", ""), unit, cent)

    def _percent(m: re.Match) -> str:
        return _amount_words(m.group(1)) + " percent"

    def _time(m: re.Match) -> str:
        h, mi = int(m.group(1)), int(m.group(2))
        if h > 23 or mi > 59:
            return m.group(0)
        suffix = _AMPM.get((m.group(3) or "").lower(), "")
        return time_to_words(h, mi, suffix)

    def _time_bare(m: re.Match) -> str:
        h = int(m.group(1))
        if not 1 <= h <= 12:
            return m.group(0)
        return time_to_words(h, 0, _AMPM[m.group(2).lower()])

    def _unit(m: re.Match) -> str:
        amount = m.group(1).replace(",", "")
        singular, plural = _UNITS[m.group(2).lower()]
        return _amount_words(amount) + " " + (
            singular if _is_one(amount) else plural
        )

    def _degrees(m: re.Match) -> str:
        amount = m.group(1).replace(",", "")
        scale = {"C": " celsius", "F": " fahrenheit"}.get(m.group(2) or "", "")
        deg = "degree" if _is_one(amount) else "degrees"
        return _amount_words(amount) + f" {deg}{scale}"

    def _ordinal(m: re.Match) -> str:
        return ordinal_to_words(int(m.group(1)))

    def _mixed(m: re.Match) -> str:
        whole, num, den = (int(m.group(i)) for i in (1, 2, 3))
        if den == 0:
            return m.group(0)
        frac = fraction_to_words(num, den)
        if num == 1 and den in _FRACTION_SPECIAL:
            frac = "a " + frac.split(" ", 1)[1]  # "2 1/2" → "two and a half"
        return number_to_words(whole) + " and " + frac

    def _fraction(m: re.Match) -> str:
        num, den = int(m.group(1)), int(m.group(2))
        if den == 0:
            return m.group(0)
        return fraction_to_words(num, den)

    def _iso_date(m: re.Match) -> str:
        month = _MONTH_NAMES[int(m.group(2)) - 1]
        return (f"{month} {ordinal_to_words(int(m.group(3)))} "
                f"{year_to_words(int(m.group(1)))}")

    def _phone(m: re.Match) -> str:
        digits = "".join(g for g in m.groups() if g)
        return " ".join(number_to_words(int(d)) for d in digits)

    def _range(m: re.Match) -> str:
        lo, hi = int(m.group(1)), int(m.group(2))
        if lo >= hi:
            return m.group(0)  # not a range; fall through to int reading
        to_words = year_to_words if _is_year(lo) and _is_year(hi) \
            else number_to_words
        return to_words(lo) + " to " + to_words(hi)

    def _decimal(m: re.Match) -> str:
        return decimal_to_words(m.group(1), m.group(2))

    def _year(m: re.Match) -> str:
        word = year_to_words(int(m.group(1)))
        if m.group(0).endswith("s"):  # decades: "1980s"
            if word.endswith("y"):
                word = word[:-1] + "ies"
            else:
                word += "s"
        return word

    def _int(m: re.Match) -> str:
        return number_to_words(int(m.group(0).replace(",", "")))

    text = _RE_CURRENCY.sub(_currency, text)
    text = _RE_PERCENT.sub(_percent, text)
    text = _RE_TIME.sub(_time, text)
    text = _RE_TIME_BARE.sub(_time_bare, text)
    text = _RE_UNIT.sub(_unit, text)
    text = _RE_DEGREES.sub(_degrees, text)
    text = _RE_ORDINAL.sub(_ordinal, text)
    text = _RE_ISO_DATE.sub(_iso_date, text)
    text = _RE_PHONE.sub(_phone, text)
    text = _RE_MIXED.sub(_mixed, text)
    text = _RE_FRACTION.sub(_fraction, text)
    text = _RE_RANGE.sub(_range, text)
    text = _RE_DECIMAL.sub(_decimal, text)
    text = _RE_YEAR.sub(_year, text)
    text = _RE_INT.sub(_int, text)
    return text
