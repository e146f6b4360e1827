"""Rule-based pinyin (TONE3) syllable -> phone decomposition, a copy of
`mixgantts_tpu/text/pinyin.py`.

The reference ships a 4120-entry lexicon file (`lexicon/pinyin-lexicon-r.txt`)
mapping every toned syllable to an initial + rewritten final (GB-style
phonology: apical vowels ii/iii, diphthong expansions iou/uei/uen, v for ü).
Instead of shipping the table, we implement the decomposition rules; the
test suite verifies every entry of the reference lexicon reproduces exactly
(`tests/test_frontend.py`).

Rewrites (derived from the lexicon's regularities):
- zero-initial syllables stay a single phone: "ang4" -> [ang4]
- z/c/s + i -> ii;  zh/ch/sh/r + i -> iii (apical vowels)
- j/q/x/y + u-forms -> v-forms (u->v, ue->ve, un->vn, uan->van)
- y + V: i-forms kept (yi/yin/ying), others get i- prefix (ya->ia, ye->ie,
  you->iou, yong->iong); "yo" -> iou
- w + V: "wu"->u, others get u- prefix (wa->ua, wei->uei, wen->uen);
  "weng" -> uen (the inventory has no "ueng")
- iu -> iou, ui -> uei, un -> uen after ordinary initials
- "er" has the alternate pronunciation [e?, rr]; the lexicon's first entry
  (single phone er?) wins, matching `read_lexicon` first-pronunciation-wins
- special entry "r5" -> [er5]
"""

import re

from .symbols import pinyin_initials, _PINYIN_FINAL_BASES

_SYLLABLE_RE = re.compile(r"^([a-z]+)([1-5])$")
_FINALS = set(_PINYIN_FINAL_BASES)
# longest-match initials first (zh/ch/sh before z/c/s)
_INITIALS = sorted(pinyin_initials, key=len, reverse=True)


def pinyin_to_phones(syllable):
    """'zhi1' -> ['zh', 'iii1'];  'ang4' -> ['ang4'];  returns None if the
    input is not a decomposable toned pinyin syllable."""
    m = _SYLLABLE_RE.match(syllable)
    if not m:
        return None
    body, tone = m.groups()

    if body == "r":  # erized-r entry in the reference lexicon
        return ["er" + tone]

    # erhua: trailing -r (not the syllable "er" itself) appends the "rr"
    # phone to the decomposition of the base syllable
    if body.endswith("r") and body != "er":
        base = pinyin_to_phones(body[:-1] + tone)
        return base + ["rr"] if base else None

    initial = ""
    for cand in _INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    final = body[len(initial):]

    if not initial:
        return [body + tone] if body in _FINALS else None

    if initial in ("z", "c", "s") and final == "i":
        final = "ii"
    elif initial in ("zh", "ch", "sh", "r") and final == "i":
        final = "iii"
    else:
        if initial in ("j", "q", "x", "y"):
            # ü-forms: u is always ü after j/q/x/y
            final = {"u": "v", "ue": "ve", "un": "vn",
                     "uan": "van"}.get(final, final)
        if initial == "y":
            if final == "o":
                final = "iou"
            elif final == "ou":
                final = "iou"
            elif not final.startswith(("i", "v")):
                final = "i" + final
        elif initial == "w":
            if final != "u":
                final = "u" + final
                if final == "ueng":  # inventory has no "ueng"
                    final = "uen"
        # orthographic contractions (all initials): iu/ui/ue and plain un
        final = {"iu": "iou", "ui": "uei", "ue": "ve"}.get(final, final)
        if initial not in ("j", "q", "x", "y"):
            final = {"un": "uen"}.get(final, final)

    if final not in _FINALS:
        return None
    return [initial, final + tone]


def build_lexicon_entries():
    """Enumerate (syllable, phones) for every decomposable toned syllable —
    the generated equivalent of the reference's pinyin-lexicon-r.txt."""
    import itertools
    entries = []
    seen = set()
    bodies = list(_PINYIN_FINAL_BASES)
    bodies += [i + f for i in pinyin_initials for f in _surface_finals()]
    bodies.append("r")
    for body, tone in itertools.product(bodies, "12345"):
        syl = body + tone
        if syl in seen:
            continue
        phones = pinyin_to_phones(syl)
        if phones:
            seen.add(syl)
            entries.append((syl, phones))
    return entries


def _surface_finals():
    """Orthographic final spellings as they appear after an initial."""
    surface = set(_PINYIN_FINAL_BASES)
    surface -= {"ii", "iii", "iou", "uei", "uen", "v", "ve", "vn", "van"}
    surface |= {"i", "iu", "ui", "un", "u", "ue", "uan", "v", "ve", "o"}
    return sorted(surface)
