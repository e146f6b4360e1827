"""(A copy of `mixgantts_tpu/data/textgrid.py`.) Minimal Praat TextGrid reader
(replaces the `tgt` dependency used at `preprocessor/preprocessor.py:271`).
Handles the long ("ooTextFile") format that the Montreal Forced Aligner
emits, including quoted text with escaped quotes; exposes interval tiers as
simple (start, end, text) tuples."""

import re
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class IntervalTier:
    name: str
    intervals: List[Tuple[float, float, str]]  # (xmin, xmax, text)


@dataclass
class TextGrid:
    tiers: List[IntervalTier]

    def get_tier_by_name(self, name):
        for tier in self.tiers:
            if tier.name == name:
                return tier
        raise KeyError(f"no tier named {name!r}")


_NUM_RE = re.compile(r"(?:xmin|xmax|number)\s*=\s*([-\d.eE+]+)")
_TEXT_RE = re.compile(r'(?:text|mark)\s*=\s*"((?:[^"]|"")*)"')
_NAME_RE = re.compile(r'name\s*=\s*"((?:[^"]|"")*)"')
_CLASS_RE = re.compile(r'class\s*=\s*"((?:[^"]|"")*)"')


def read_textgrid(path):
    with open(path, encoding="utf-8") as f:
        content = f.read()
    # split into tier chunks: "item [k]:" sections (skip the header item [])
    chunks = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    tiers = []
    for chunk in chunks:
        cls = _CLASS_RE.search(chunk)
        name = _NAME_RE.search(chunk)
        if cls is None or "IntervalTier" not in cls.group(1):
            continue
        intervals = []
        for iv in re.split(r"intervals\s*\[\d+\]\s*:", chunk)[1:]:
            nums = _NUM_RE.findall(iv)
            text = _TEXT_RE.search(iv)
            if len(nums) >= 2:
                intervals.append((
                    float(nums[0]), float(nums[1]),
                    text.group(1).replace('""', '"') if text else "",
                ))
        tiers.append(IntervalTier(
            name=name.group(1) if name else "", intervals=intervals))
    return TextGrid(tiers=tiers)


def write_textgrid(path, tiers, xmin=0.0, xmax=None):
    """Write interval tiers in long format (used by the test fixtures)."""
    if xmax is None:
        xmax = max(iv[1] for t in tiers for iv in t.intervals)
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        f"xmin = {xmin}", f"xmax = {xmax}",
        "tiers? <exists>", f"size = {len(tiers)}", "item []:",
    ]
    for k, tier in enumerate(tiers, 1):
        lines += [
            f"    item [{k}]:",
            '        class = "IntervalTier"',
            f'        name = "{tier.name}"',
            f"        xmin = {xmin}", f"        xmax = {xmax}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for i, (s, e, t) in enumerate(tier.intervals, 1):
            lines += [
                f"        intervals [{i}]:",
                f"            xmin = {s}", f"            xmax = {e}",
                f'            text = "{t}"',
            ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
