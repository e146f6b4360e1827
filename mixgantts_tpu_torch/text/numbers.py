"""English number normalization, a copy of `mixgantts_tpu/text/numbers.py`.

Behavior-compatible with the reference pipeline (`text/numbers.py` in
MaxMax2016/MixGAN-TTS), but dependency-free: the `inflect` engine it relied on
is replaced by an in-repo number-to-words converter supporting the three call
shapes the reference uses: plain cardinals (andword=""), digit-pair grouping
for years (group=2, zero="oh"), and ordinals.
"""

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n):
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    if unit == 0:
        return _TENS[tens]
    return _TENS[tens] + "-" + _UNITS[unit]


def _three_digits(n):
    if n < 100:
        return _two_digits(n)
    hundreds, rest = divmod(n, 100)
    out = _UNITS[hundreds] + " hundred"
    if rest:
        out += " " + _two_digits(rest)
    return out


def number_to_words(n, group=0, zero="zero"):
    """Cardinal words for non-negative int `n`.

    group=2 reads the number as digit pairs (used for years): 1999 ->
    "nineteen ninety-nine"; a zero pair reads as `zero` ("oh").
    """
    n = int(n)
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        parts = []
        for i in range(0, len(digits), 2):
            pair = int(digits[i:i + 2])
            if pair == 0:
                parts.append(zero)
            elif pair < 10 and digits[i] == "0":
                parts.append(zero + " " + _UNITS[pair])
            else:
                parts.append(_two_digits(pair))
        return " ".join(parts)

    if n == 0:
        return zero
    parts = []
    for scale_value, scale_name in _SCALES:
        if n >= scale_value:
            count, n = divmod(n, scale_value)
            parts.append(number_to_words(count) + " " + scale_name)
    if n:
        parts.append(_three_digits(n))
    return " ".join(parts)


def ordinal_to_words(n):
    words = number_to_words(int(n))
    head, _, last = words.rpartition(" ")
    pre, _, hyph_last = last.rpartition("-")
    if hyph_last in _ORDINAL_IRREGULAR:
        last = (pre + "-" if pre else "") + _ORDINAL_IRREGULAR[hyph_last]
    elif hyph_last.endswith("y"):
        last = (pre + "-" if pre else "") + hyph_last[:-1] + "ieth"
    elif hyph_last.endswith("t"):
        last = (pre + "-" if pre else "") + hyph_last + "h"
    else:
        last = (pre + "-" if pre else "") + hyph_last + "th"
    return (head + " " if head else "") + last


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (dollars, dollar_unit, cents, cent_unit)
    elif dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    elif cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(m.group(0)[:-2])


def _expand_number(m):
    num = int(m.group(0))
    # Year-style reading for 1000 < n < 3000 (matches the reference).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, group=2, zero="oh")
    return number_to_words(num)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
