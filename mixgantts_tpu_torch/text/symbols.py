"""Symbol inventory of the text frontend, copied from
`mixgantts_tpu/text/symbols.py` so that the port imports nothing of the JAX
package.  The ids index the encoder's embedding table, which has
`len(symbols) + 1` rows.

Order (compatible with the original MixGAN-TTS `text/symbols.py`): pad,
special, punctuation, letters, @ARPAbet, @pinyin, silences.  ARPAbet: 39
base phones in alphabetical order, each vowel with its stress variants (84
symbols).  Pinyin: 23 initials, 37 finals x tones 1-5, then "rr" (209).
"""

# --- ARPAbet ----------------------------------------------------------------

_ARPA_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
    "OW", "OY", "UH", "UW",
]
_ARPA_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

arpabet_symbols = []
for _base in sorted(_ARPA_VOWELS + _ARPA_CONSONANTS):
    if _base in _ARPA_VOWELS:
        arpabet_symbols += [_base, _base + "0", _base + "1", _base + "2"]
    else:
        arpabet_symbols.append(_base)

# --- Pinyin -----------------------------------------------------------------

pinyin_initials = [
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "q",
    "r", "s", "sh", "t", "w", "x", "y", "z", "zh",
]
_PINYIN_FINAL_BASES = [
    "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er", "i", "ia",
    "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing", "iong", "iou",
    "o", "ong", "ou", "u", "ua", "uai", "uan", "uang", "uei", "uen", "uo",
    "v", "van", "ve", "vn",
]
pinyin_finals = [b + str(t) for b in _PINYIN_FINAL_BASES for t in range(1, 6)]
pinyin_symbols = pinyin_initials + pinyin_finals + ["rr"]

# --- Full table -------------------------------------------------------------

_pad = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_silences = ["@sp", "@spn", "@sil"]

# "@" prefix keeps phone symbols distinct from bare letters.
_arpabet = ["@" + s for s in arpabet_symbols]
_pinyin = ["@" + s for s in pinyin_symbols]

symbols = (
    [_pad]
    + list(_special)
    + list(_punctuation)
    + list(_letters)
    + _arpabet
    + _pinyin
    + _silences
)

silence_symbols = list(_silences)
