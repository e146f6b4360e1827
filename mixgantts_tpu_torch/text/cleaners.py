"""Text cleaners (behavior-compatible with the reference `text/cleaners.py`),
a copy of `mixgantts_tpu/text/cleaners.py`.

`unidecode` is replaced with an in-repo NFKD-based ASCII transliterator that
covers the Latin-script accents appearing in LJSpeech-style corpora.
"""

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

# A few common characters NFKD alone does not map to useful ASCII.
_TRANSLIT_EXTRA = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "þ": "th", "Þ": "Th",
    "ð": "d", "Ð": "D", "ł": "l", "Ł": "L",
    "“": '"', "”": '"', "‘": "'", "’": "'", "—": "-", "–": "-",
    "…": "...", "«": '"', "»": '"',
}


def convert_to_ascii(text):
    text = "".join(_TRANSLIT_EXTRA.get(ch, ch) for ch in text)
    text = unicodedata.normalize("NFKD", text)
    return text.encode("ascii", "ignore").decode("ascii")


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def basic_cleaners(text):
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text):
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text):
    """English pipeline: ASCII, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
