"""Inference text frontend (`mixgantts_tpu/frontend.py`): grapheme to
phoneme with word boundaries.

English: lexicon lookup, with the in-repo letter-to-sound rules
(`text/lts.py`) for words the lexicon lacks.  Mandarin: raw hanzi through
the in-repo table (`text/hanzi.py`) or TONE3 pinyin tokens, then the
lexicon or the rule-based syllable decomposition (`text/pinyin.py`).
Punctuation becomes "sp"; `word_boundaries` counts phones per word,
optionally subdivided at `max_phoneme_num`.  Plain Python and numpy.
"""

import os
import re
from string import punctuation

import numpy as np

from .text import text_to_sequence
from .text.lts import letter_to_sound  # noqa: F401  (re-exported)
from .utils.tools import word_level_subdivision

_lexicon_cache = {}


def read_lexicon(lex_path):
    """word -> phone list (first pronunciation wins)."""
    lex_path = os.path.abspath(lex_path)
    if lex_path in _lexicon_cache:
        return _lexicon_cache[lex_path]
    lexicon = {}
    with open(lex_path, encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\s+", line.strip("\n"))
            if not parts or not parts[0]:
                continue
            word, phones = parts[0], parts[1:]
            if word.lower() not in lexicon:
                lexicon[word.lower()] = phones
    _lexicon_cache[lex_path] = lexicon
    return lexicon


def _finish(phone_str, word_boundaries, text, preprocess_config, verbose):
    text_cfg = preprocess_config["preprocessing"]["text"]
    if text_cfg["sub_divide_word"]:
        word_boundaries = word_level_subdivision(word_boundaries, text_cfg["max_phoneme_num"])
    if verbose:
        print(f"Raw Text Sequence: {text}")
        print(f"Phoneme Sequence: {phone_str}")
    sequence = np.array(text_to_sequence(phone_str, text_cfg["text_cleaners"]))
    return sequence, np.array(word_boundaries)


def preprocess_english(text, preprocess_config, verbose=True):
    """Raw English text -> (phone ids, phones per word)."""
    text = text.rstrip(punctuation)
    lex_path = preprocess_config["path"]["lexicon_path"]
    lexicon = read_lexicon(lex_path) if os.path.isfile(lex_path) else {}

    phones, word_boundaries = [], []
    for w in re.split(r"([,;.\-\?\!\s+])", text):
        if w.lower() in lexicon:
            phone_list = lexicon[w.lower()]
        elif re.search(r"[A-Za-z]", w):
            phone_list = letter_to_sound(w)
        else:
            phone_list = list(w.strip())
        if phone_list:
            phones += phone_list
            word_boundaries.append(len(phone_list))
    phone_str = "{" + "}{".join(phones) + "}"
    phone_str = re.sub(r"\{[^\w\s]?\}", "{sp}", phone_str)
    phone_str = phone_str.replace("}{", " ")
    return _finish(phone_str, word_boundaries, text, preprocess_config, verbose)


_PINYIN_RE = re.compile(r"^[a-z]+[1-5]$")


def preprocess_mandarin(text, preprocess_config, verbose=True):
    """Raw hanzi or TONE3 pinyin tokens -> (phone ids, phones per word)."""
    from .text.hanzi import contains_hanzi, hanzi_to_pinyin
    from .text.pinyin import pinyin_to_phones

    lex_path = preprocess_config["path"]["lexicon_path"]
    lexicon = read_lexicon(lex_path) if os.path.isfile(lex_path) else {}

    if contains_hanzi(text):
        # punctuation and unknown characters pass through and miss the
        # lexicon below, so they become "sp"
        tokens = hanzi_to_pinyin(text)
    else:
        tokens = text.strip().split()
        if not all(_PINYIN_RE.match(t) or not t for t in tokens):
            raise ValueError(
                "Mandarin input must be hanzi or TONE3 pinyin tokens "
                "(e.g. '你好' or 'ni3 hao3')")
    phones, word_boundaries = [], []
    for p in tokens:
        phone_list = lexicon.get(p) or pinyin_to_phones(p) or ["sp"]
        phones += phone_list
        word_boundaries.append(len(phone_list))
    phone_str = "{" + " ".join(phones) + "}"
    return _finish(phone_str, word_boundaries, text, preprocess_config, verbose)
