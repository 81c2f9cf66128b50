"""TTSD dialogue text utilities: CJK/EN normalization, speaker-tag handling.

Behavior parity with the reference TTSD app
(clis/moss_ttsd_app.py:125-227,236-244): punctuation folding, laughter
mapping, speaker-tag validation/merge, prompt-text prefixing.

The port's own verbatim copy of ``mosstts_tpu/serve/text_norm.py``: the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import re
from itertools import groupby
from typing import Dict, List, Optional, Tuple

# --- speaker-tag grammar ----------------------------------------------------
_BARE_NUM_TAG = re.compile(r"\[(\d+)\]")  # [2] -> [S2]
_TAG_BOUNDARY = re.compile(r"(?=\[S\d+\])")
_TAG_PREFIX = re.compile(r"^(\[S\d+\])\s*(.*)")

# --- per-segment cleanup tables ---------------------------------------------
# decorative brackets/quotes/underscores vanish entirely
_DROP_TABLE = {ord(c): None for c in '【】《》（）『』「」"-_“”～~‘’'}
# mid-sentence separators fold to the comma of their script
_SEPARATOR_TABLE = str.maketrans({"；": "，", ";": ",", "：": "，", ":": ",", "、": "，"})
# every long-dash / ellipsis variant reads as a breath pause
_PAUSE_MARKS = re.compile("——|……|\\.\\.\\.|⸺|―|—|…")
_LAUGH_ZH = re.compile(r"哈{2,}")
_LAUGH_EN = re.compile(r"\b(ha(\s*ha)+)\b", re.IGNORECASE)
_PUNCT_RUN = re.compile(r"([，。？！,.?!])[，。？！,.?!]+")


def _settle_sentence_ends(content: str) -> str:
    """Keep one sentence-final mark: interior full stops become commas, and a
    trailing comma is promoted to a full stop (both scripts)."""
    if len(content) <= 1:
        return content
    final = {"，": "。", ",": "."}.get(content[-1], content[-1])
    return content[:-1].replace("。", "，") + final


# Ordered cleanup pipeline applied to each speaker segment's content.
_CONTENT_PIPELINE = (
    lambda s: s.translate(_DROP_TABLE),
    lambda s: _LAUGH_ZH.sub("[笑]", s),
    lambda s: _LAUGH_EN.sub("[laugh]", s),
    lambda s: _PAUSE_MARKS.sub("，", s),
    lambda s: s.translate(_SEPARATOR_TABLE),
    str.strip,
    lambda s: _PUNCT_RUN.sub(r"\1", s),
    _settle_sentence_ends,
)


def _split_tagged(text: str) -> List[Tuple[str, str]]:
    """Split on [Sn] boundaries into (tag, body) pairs; untagged prefixes get
    an empty tag."""
    pairs = []
    for seg in _TAG_BOUNDARY.split(text):
        seg = seg.strip()
        if not seg:
            continue
        m = _TAG_PREFIX.match(seg)
        pairs.append(m.groups() if m else ("", seg))
    return pairs


def normalize_text(text: str) -> str:
    """Normalize TTSD dialogue text (behavioral contract pinned by the golden
    vectors in tests/test_text_norm.py, from the reference TTSD app's
    normalization, clis/moss_ttsd_app.py:125-182)."""
    text = _BARE_NUM_TAG.sub(r"[S\1]", text).replace("\n", " ")

    cleaned: List[Tuple[str, str]] = []
    for tag, body in _split_tagged(text):
        for step in _CONTENT_PIPELINE:
            body = step(body)
        cleaned.append((tag, body))

    # consecutive segments of the same (non-empty) speaker concatenate
    lines: List[str] = []
    for tag, group in groupby(cleaned, key=lambda tb: tb[0]):
        bodies = [b for _, b in group]
        if tag:
            lines.append((tag + "".join(bodies)).strip())
        else:
            lines.extend(b.strip() for b in bodies)
    return "".join(lines).replace("‘", "'").replace("’", "'")


def validate_dialogue_text(dialogue_text: str, speaker_count: int) -> str:
    text = (dialogue_text or "").strip()
    if not text:
        raise ValueError("Please enter dialogue text.")
    tags = re.findall(r"\[S(\d+)\]", text)
    if not tags:
        raise ValueError("Dialogue must include speaker tags like [S1], [S2], ...")
    max_tag = max(int(t) for t in tags)
    if max_tag > speaker_count:
        raise ValueError(
            f"Dialogue contains [S{max_tag}], but speaker count is set to {speaker_count}."
        )
    return text


def merge_consecutive_speaker_tags(text: str) -> str:
    segments = re.split(r"(?=\[S\d+\])", text)
    parts: List[str] = []
    cur_tag: Optional[str] = None
    for seg in segments:
        seg = seg.strip()
        if not seg:
            continue
        matched = re.match(r"^(\[S\d+\])\s*(.*)", seg, re.DOTALL)
        if not matched:
            parts.append(seg)
            continue
        tag, content = matched.groups()
        if tag == cur_tag:
            parts.append(content)
        else:
            cur_tag = tag
            parts.append(f"{tag}{content}")
    return "".join(parts)


def normalize_prompt_text(prompt_text: str, speaker_id: int) -> str:
    text = (prompt_text or "").strip()
    if not text:
        raise ValueError(f"S{speaker_id} prompt text is empty.")
    expected = f"[S{speaker_id}]"
    if not text.lstrip().startswith(expected):
        text = f"{expected} {text}"
    return text


def build_prefixed_text(dialogue_text: str, prompt_text_map: Dict[int, str],
                        cloned_speakers: List[int]) -> str:
    prefix = "".join(prompt_text_map[s] for s in cloned_speakers)
    return merge_consecutive_speaker_tags(prefix + dialogue_text)


# ---- duration estimation (clis/moss_tts_app.py:31-32,145-165) -------------
ZH_TOKENS_PER_CHAR = 3.098411951313033
EN_TOKENS_PER_CHAR = 0.8673376262755219
TOKENS_PER_SECOND = 12.5


def detect_text_language(text: str) -> str:
    zh = len(re.findall(r"[一-鿿]", text))
    en = len(re.findall(r"[A-Za-z]", text))
    if zh == 0 and en == 0:
        return "en"
    return "zh" if zh >= en else "en"


def estimate_duration_tokens(text: str):
    normalized = text or ""
    n = max(len(normalized), 1)
    lang = detect_text_language(normalized)
    factor = ZH_TOKENS_PER_CHAR if lang == "zh" else EN_TOKENS_PER_CHAR
    default_tokens = max(1, int(n * factor))
    min_tokens = max(1, int(default_tokens * 0.5))
    max_tokens = max(min_tokens, int(default_tokens * 1.5))
    return lang, default_tokens, min_tokens, max_tokens
