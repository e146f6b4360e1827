"""CMU Pronouncing Dictionary file parser, a copy of
`mixgantts_tpu/text/cmudict.py`.

API-compatible with the reference's `text/cmudict.py:95-140` (a
keithito/tacotron vestige that is dead at runtime there — no live path
constructs a `CMUDict`; the inference lexicon is read by
`read_lexicon` instead).  Provided so users porting scripts that DID use
it (custom frontends, dictionary audits) find the same surface:

- `valid_symbols`: the 84-entry ARPAbet inventory (stress-variant
  expansion of the 39 base phones) — re-exported from the generated
  table in `symbols.py`, same order as the reference literal.
- `CMUDict(file_or_path, keep_ambiguous=True)` with `.lookup(word)`
  returning a list of space-joined pronunciation strings (one per
  alternate), `len()` = entry count.

Format rules honoured (cmudict-0.7b conventions): latin-1 encoding;
entry lines start with A-Z or an apostrophe; word and pronunciation are
separated by two spaces; alternates are marked `WORD(1)` and merge into
the base word's list; pronunciations containing any symbol outside
`valid_symbols` are discarded.
"""

import re

from .symbols import arpabet_symbols as valid_symbols

_VALID = frozenset(valid_symbols)
_ALT_MARK = re.compile(r"\(\d+\)")


def _parse(lines):
    entries = {}
    for line in lines:
        if not line or not (line[0] == "'" or "A" <= line[0] <= "Z"):
            continue
        head, sep, tail = line.partition("  ")
        if not sep:
            continue
        word = _ALT_MARK.sub("", head)
        phones = tail.strip().split(" ")
        if any(p not in _VALID for p in phones):
            continue
        entries.setdefault(word, []).append(" ".join(phones))
    return entries


class CMUDict:
    """Reads a cmudict-format file (path or open file object)."""

    def __init__(self, file_or_path, keep_ambiguous=True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """List of ARPAbet pronunciation strings for `word`, or None."""
        return self._entries.get(word.upper())
