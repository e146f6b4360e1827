"""The port's text frontend against the JAX package's, which it copies:
every case must give exactly the same output (symbols, ids, phones, word
boundaries), so that the port's CLI feeds its model what the JAX CLI
feeds its own."""

import importlib
import os
import re

import numpy as np
import pytest

from mixgantts_tpu import frontend as jfront
from mixgantts_tpu import text as jtext
from mixgantts_tpu.text import cleaners as jcleaners
from mixgantts_tpu.text import cmudict as jcmudict
from mixgantts_tpu.utils import tools as jtools
from mixgantts_tpu_torch import frontend as tfront
from mixgantts_tpu_torch import text as ttext
from mixgantts_tpu_torch.text import cleaners as tcleaners
from mixgantts_tpu_torch.text import cmudict as tcmudict
from mixgantts_tpu_torch.utils import tools as ttools

HERE = os.path.dirname(os.path.abspath(__file__))
# the packages' __init__ binds `symbols` to the table, so import the modules
jsymbols = importlib.import_module("mixgantts_tpu.text.symbols")
tsymbols = importlib.import_module("mixgantts_tpu_torch.text.symbols")

SENTENCES = [
    "Hello world.",
    "Dr. Smith paid $3.50 for 2 apples on the 21st of May, 1999!",
    "Mr. and Mrs. Jones live at 10 St. James St.; the co. is Ltd.",
    "It cost 1,234,567 dollars -- or 0.5% of the budget?",
    "Café naïve façade, Æsop's “fables” — déjà vu…",
    "The zorblatt quixotically flummoxed its xylophone in 1066.",
    "   Spaces   and\ttabs\nand newlines   ",
    "I'll say it's 9:30 a.m. (or so).",
]


@pytest.mark.parametrize("name", [
    "symbols", "silence_symbols", "arpabet_symbols", "pinyin_initials",
    "pinyin_finals", "pinyin_symbols", "_PINYIN_FINAL_BASES",
])
def test_symbol_tables_equal(name):
    assert getattr(tsymbols, name) == getattr(jsymbols, name)


@pytest.mark.parametrize("cleaner", [
    "english_cleaners", "basic_cleaners", "transliteration_cleaners",
    "expand_numbers", "expand_abbreviations", "convert_to_ascii",
])
def test_cleaners_equal(cleaner):
    for s in SENTENCES:
        assert getattr(tcleaners, cleaner)(s) == getattr(jcleaners, cleaner)(s), s


@pytest.mark.parametrize("cleaners", [["english_cleaners"], ["basic_cleaners"], []])
def test_text_to_sequence_and_back_equal(cleaners):
    texts = SENTENCES + ["{HH AH0 L OW1} world {W ER1 L D}", "{n i3 h ao3 sp}",
                         "mixed {AH0} and {sp} braces, {spn}."]
    for s in texts:
        got = ttext.text_to_sequence(s, cleaners)
        assert got == jtext.text_to_sequence(s, cleaners), s
        assert ttext.sequence_to_text(got) == jtext.sequence_to_text(got), s
    assert ttext.sil_phonemes_ids() == jtext.sil_phonemes_ids()
    with pytest.raises(ValueError, match="Unknown cleaner"):
        ttext.text_to_sequence("x", ["no_such_cleaner"])


def g2p_words():
    """Every word that tests/test_g2p.py spells out, plus the edge cases."""
    with open(os.path.join(HERE, "test_g2p.py"), encoding="utf-8") as f:
        words = set(re.findall(r'"([a-z][a-z\']*)"', f.read()))
    return sorted(words) + ["", "12345", "Hello", "flumbo", "wouldn't"]


G2P_CHUNKS = 8


@pytest.mark.parametrize("chunk", range(G2P_CHUNKS))
def test_letter_to_sound_equal(chunk):
    words = g2p_words()
    assert len(words) > 200
    for w in words[chunk::G2P_CHUNKS]:
        assert tfront.letter_to_sound(w) == jfront.letter_to_sound(w), w


CMUDICT_TEXT = """;;; comment line
HELLO  HH AH0 L OW1
HELLO(1)  HH EH0 L OW1
WORLD  W ER1 L D
'TIS  T IH1 Z
READ  R EH1 D
READ(1)  R IY1 D
BOGUS  B OW1 G XX1 S
lower  L OW1 ER0
NOSEP HH
"""


@pytest.mark.parametrize("keep_ambiguous", [True, False])
def test_cmudict_equal(tmp_path, keep_ambiguous):
    path = tmp_path / "cmudict.txt"
    path.write_text(CMUDICT_TEXT, encoding="latin-1")
    got = tcmudict.CMUDict(str(path), keep_ambiguous=keep_ambiguous)
    want = jcmudict.CMUDict(str(path), keep_ambiguous=keep_ambiguous)
    assert len(got) == len(want) > 0
    for word in ("hello", "World", "'tis", "read", "bogus", "lower", "nosep", "absent"):
        assert got.lookup(word) == want.lookup(word), word
    with open(path, encoding="latin-1") as f:
        from_file = tcmudict.CMUDict(f, keep_ambiguous=keep_ambiguous)
    assert from_file.lookup("hello") == want.lookup("hello")
    assert tcmudict.valid_symbols == jcmudict.valid_symbols


def en_config(tmp_path, lexicon, sub_divide, cleaners=("english_cleaners",)):
    lex = tmp_path / "lexicon.txt"
    if lexicon:
        lex.write_text("hello HH AH0 L OW1\nHello HH EH0 L OW1\nworld W ER1 L D\n"
                       "dr D AA1 K T ER0\nthe DH AH0\n")
    return {"path": {"lexicon_path": str(lex)},
            "preprocessing": {"text": {"text_cleaners": list(cleaners), "language": "en",
                                       "sub_divide_word": sub_divide,
                                       "max_phoneme_num": 3}}}


@pytest.mark.parametrize("lexicon,sub_divide", [(True, False), (True, True),
                                                (False, False), (False, True)])
def test_preprocess_english_equal(tmp_path, lexicon, sub_divide):
    cfg = en_config(tmp_path, lexicon, sub_divide)
    for s in SENTENCES + ["hello, world", "abcdefgh", "hello-world?!"]:
        got = tfront.preprocess_english(s, cfg, verbose=False)
        want = jfront.preprocess_english(s, cfg, verbose=False)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, s
            np.testing.assert_array_equal(g, w, err_msg=s)


def zh_config(tmp_path, lexicon):
    lex = tmp_path / "pinyin-lexicon.txt"
    if lexicon:
        lex.write_text("ni3 n i3\nhao3 h ao3\nshi4 sh iii4\n")
    return {"path": {"lexicon_path": str(lex)},
            "preprocessing": {"text": {"text_cleaners": [], "language": "zh",
                                       "sub_divide_word": True, "max_phoneme_num": 2}}}


@pytest.mark.parametrize("text", [
    "你好", "今天天气真不错，我们一起去公园散步吧。", "我买了一部iPhone手机",
    "ni3 hao3", "zhong1 guo2 ren2 min2 er2 huar4 r5", "  shi4  lv4 yue4 nv3 ",
])
@pytest.mark.parametrize("lexicon", [True, False])
def test_preprocess_mandarin_equal(tmp_path, text, lexicon):
    cfg = zh_config(tmp_path, lexicon)
    got = tfront.preprocess_mandarin(text, cfg, verbose=False)
    want = jfront.preprocess_mandarin(text, cfg, verbose=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_preprocess_mandarin_rejects_what_jax_rejects(tmp_path):
    cfg = zh_config(tmp_path, False)
    for fn in (tfront.preprocess_mandarin, jfront.preprocess_mandarin):
        with pytest.raises(ValueError, match="hanzi or TONE3"):
            fn("not pinyin!!", cfg, verbose=False)


def test_host_helpers_equal():
    for words, cap in (([1, 5, 7, 3, 12], 3), ([2, 2], 4), ([9], 9)):
        assert ttools.word_level_subdivision(words, cap) == \
            jtools.word_level_subdivision(words, cap)
    rows = [np.arange(3), np.arange(5), np.arange(1)]
    np.testing.assert_array_equal(ttools.pad_1d(rows), jtools.pad_1d(rows))
    np.testing.assert_array_equal(ttools.pad_1d(rows, 8, pad_value=-1),
                                  jtools.pad_1d(rows, 8, pad_value=-1))
    mats = [np.ones((2, 3)), np.ones((4, 3))]
    np.testing.assert_array_equal(ttools.pad_2d(mats), jtools.pad_2d(mats))
    np.testing.assert_array_equal(ttools.pad_2d(mats, 6), jtools.pad_2d(mats, 6))
