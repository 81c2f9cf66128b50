"""The Qwen2 / Qwen3 text tokenizer, read from a checkpoint's ``tokenizer.json``.

``Qwen2BPETokenizer`` gives the ids, decodes and token/id conversions that
``transformers``' ``Qwen2TokenizerFast`` gives over the same directory, with
the standard library and numpy (``json``, ``re``, ``unicodedata``): the
port depends on no ``transformers``, ``tokenizers`` or ``regex``, and
tokenizes the same wherever it runs.

It reads the components Qwen2 and Qwen3 use and raises ``ValueError``,
naming the component, on any other type or flag value:

- added tokens (``added_tokens``), split out of the raw text first,
  leftmost-longest, with ``lstrip``, ``rstrip``, ``single_word`` and
  ``normalized`` false;
- the ``NFC`` normalizer (or none), on the text between added tokens;
- the pre-tokenizer ``Sequence[Split(Regex, "Isolated", invert=false),
  ByteLevel(add_prefix_space=false, use_regex=false)]``. The file's own
  pattern is translated for Python's ``re``: ``\\p{L}``, ``\\p{N}``,
  ``\\s`` and ``\\S`` become explicit code-point classes (Python's ``\\s``
  also takes U+001C-U+001F, which the Oniguruma engine of ``tokenizers``
  does not), any other class escape raises;
- the ``BPE`` model (merges as ``"a b"`` strings or ``[a, b]`` pairs) with
  ``dropout``, ``byte_fallback``, ``fuse_unk`` and ``ignore_merges`` off
  and no subword prefix or suffix; every pre-token's ids are cached, as
  ``tokenizers`` does (``TextDeltaTokenizer`` re-encodes a whole reply on
  every delta);
- the ``ByteLevel`` decoder and post-processor (which adds no BOS).

``tokenizer_config.json`` supplies ``unk_token`` (``convert_tokens_to_ids``
of an unknown token) and ``clean_up_tokenization_spaces``; the special
tokens it names must be special added tokens of ``tokenizer.json``.
"""
from __future__ import annotations

import itertools
import json
import numbers
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_CACHE_ENTRIES = 10_000  # pre-tokens whose ids are kept, as tokenizers' BPE cache
_CACHE_CHARS = 256  # longer pre-tokens are not cached (tokenizers' MAX_LENGTH)
# Python's re tests a class's BMP part in one table lookup but its other
# ranges one by one, so the pattern's classes hold the BMP alone, and each
# character above U+FFFF is matched as a BMP stand-in of its class (letter,
# number, white space, other), which the pattern must not name
_STAND_IN = {"L": "\u4e00", "N": "\u0660", "s": "\u2000", "o": "\ue000"}
_KIND = {c: c[0] if c[0] in "LN" else "s" if c in ("Zs", "Zl", "Zp") else "o"
         for c in ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd",
                   "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc",
                   "Cf", "Cs", "Co", "Cn")}
# built once per process: the class bodies of \p{L}, \p{N}, \s over the
# BMP, and each code point's stand-in (itself below U+10000)
_TABLES: Dict[str, object] = {}


def _kinds(lo: int, hi: int) -> str:
    """One character per code point in [lo, hi): its class in ``_STAND_IN``."""
    return "".join(map(_KIND.__getitem__, map(unicodedata.category, map(chr, range(lo, hi)))))


def _fold_astral(text: str) -> str:
    """``text`` with every character above U+FFFF replaced by its stand-in."""
    table = _TABLES.get("fold")
    if table is None:
        lut = np.zeros(128, np.uint16)
        for k, c in _STAND_IN.items():
            lut[ord(k)] = ord(c)
        kinds = np.frombuffer(_kinds(0x10000, 0x110000).encode("ascii"), np.uint8)
        table = _TABLES["fold"] = np.concatenate([np.arange(0x10000, dtype=np.uint16),
                                                  lut[kinds]])
    codes = np.frombuffer(text.encode("utf-32-le", "surrogatepass"), np.uint32)
    return table[codes].astype(np.uint32).tobytes().decode("utf-32-le", "surrogatepass")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of the ByteLevel components."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _class_body(name: str) -> str:
    """The ``re`` character-class body (ranges, no brackets) of ``\\p{L}``,
    ``\\p{N}`` or ``\\s`` below U+10000, as Oniguruma's Unicode tables
    define them: the letters, the numbers (general categories L*, N*), and
    the white space U+0009-U+000D, U+0085 and the Zs, Zl, Zp categories."""
    if name not in _TABLES:
        kinds = _kinds(0, 0x10000)
        kinds = kinds[:9] + "s" * 5 + kinds[14:0x85] + "s" + kinds[0x86:]
        for k in "LNs":
            _TABLES[k] = "".join(
                f"\\u{m.start():04x}" if m.end() - m.start() == 1
                else f"\\u{m.start():04x}-\\u{m.end() - 1:04x}"
                for m in re.finditer(f"{k}+", kinds))
    return _TABLES[name]


_PROPERTY = re.compile(r"\\p\{(\w+)\}")
_GROUPS = ("(?:", "(?i:", "(?!", "(?=")
_SIMPLE_ESCAPES = set("rnt") | set("\\.^$|?*+()[]{}-/'\" ")


def translate_pattern(pattern: str) -> str:
    """A ``tokenizers`` Split regex (Oniguruma syntax) as a Python ``re``
    pattern that matches the same text once every character above U+FFFF
    is replaced by its class's stand-in (``_STAND_IN``). Raises
    ``ValueError`` on a construct whose meaning the two engines may not
    share."""
    if max(pattern, default="") >= "\U00010000" or any(c in pattern for c in _STAND_IN.values()):
        raise ValueError(f"tokenizer.json: a pre-tokenizer pattern that names a character "
                         f"above U+FFFF or a stand-in of one: {pattern!r}")
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            m = _PROPERTY.match(pattern, i)
            if m:
                if m.group(1) not in ("L", "N"):
                    raise ValueError(f"tokenizer.json: unsupported class \\p{{{m.group(1)}}} in "
                                     f"the pre-tokenizer pattern {pattern!r}")
                body = _class_body(m.group(1))
                out.append(body if in_class else f"[{body}]")
                i = m.end()
                continue
            nxt = pattern[i + 1:i + 2]
            space = _class_body("s")
            if nxt == "s":
                out.append(space if in_class else f"[{space}]")
            elif nxt == "S" and not in_class:
                out.append(f"[^{space}]")
            elif nxt in _SIMPLE_ESCAPES and nxt:
                out.append("\\" + nxt)
            else:
                raise ValueError(f"tokenizer.json: unsupported escape \\{nxt} in the "
                                 f"pre-tokenizer pattern {pattern!r}")
            i += 2
            continue
        if in_class:
            if ch == "[" or pattern.startswith("&&", i):
                raise ValueError(f"tokenizer.json: nested class or class operation in the "
                                 f"pre-tokenizer pattern {pattern!r}")
            if ch == "]":
                in_class = False
            out.append(ch)
        elif ch == "[":
            in_class = True
            out.append(ch)
            if pattern.startswith("[^", i):
                out.append("^")
                i += 1
        elif ch == "(" and pattern.startswith("(?", i):
            group = next((g for g in _GROUPS if pattern.startswith(g, i)), None)
            if group is None:
                raise ValueError(f"tokenizer.json: unsupported group {pattern[i:i + 4]!r} in "
                                 f"the pre-tokenizer pattern {pattern!r}")
            out.append(group)
            i += len(group)
            continue
        elif ch == "(":
            out.append("(?:")  # no capturing group: only whole matches are pre-tokens
        elif ch in ".^$":
            raise ValueError(f"tokenizer.json: unsupported {ch!r} in the pre-tokenizer "
                             f"pattern {pattern!r}")
        else:
            out.append(ch)
        i += 1
    if in_class:
        raise ValueError(f"tokenizer.json: unterminated class in {pattern!r}")
    return "".join(out)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"tokenizer.json: unsupported {what}")


def _flag_off(d: dict, key: str, off=(None, False, "")) -> None:
    _require(d.get(key) in off, f"{d.get('type', 'component')} {key}={d.get(key)!r}")


def _token_content(tok) -> Optional[str]:
    """A special token as ``tokenizer_config.json`` writes it: a string, an
    ``AddedToken`` dict or null."""
    return tok.get("content") if isinstance(tok, dict) else tok


_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
             (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


class Qwen2BPETokenizer:
    """A byte-level BPE tokenizer built from ``tokenizer.json`` (parsed) and
    ``tokenizer_config.json`` (parsed); ``from_dir`` reads both."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = dict(config or {})
        cls = config.get("tokenizer_class")
        _require(cls in (None, "Qwen2Tokenizer", "Qwen2TokenizerFast"),
                 f"tokenizer_class {cls!r} (reads Qwen2Tokenizer)")
        self._check_components(spec)
        model = spec["model"]
        self._vocab: Dict[str, int] = dict(model["vocab"])
        missing = [c for c in _BYTE_CHAR.values() if c not in self._vocab]
        _require(not missing, f"BPE vocabulary without the byte-level characters {missing[:8]}")
        self._ranks: Dict[tuple, int] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            _require(a + b in self._vocab, f"merge {a!r} + {b!r} whose result is not in the vocab")
            self._ranks.setdefault((a, b), rank)
        self._added: Dict[str, int] = {}
        self._special: set = set()
        for t in spec.get("added_tokens") or []:
            for flag in ("single_word", "lstrip", "rstrip", "normalized"):
                _require(not t.get(flag), f"added token {t['content']!r} with {flag}=true")
            self._added[t["content"]] = t["id"]
            if t.get("special"):
                self._special.add(t["content"])
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        self._len = len(set(self._vocab) | set(self._added))
        self._check_config(config)
        self.unk_token_id = None
        unk = _token_content(config.get("unk_token", "<|endoftext|>"))
        self.unk_token_id = None if unk is None else self.convert_tokens_to_ids(unk)
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        split = spec["pre_tokenizer"]["pretokenizers"][0]
        self._split = re.compile(translate_pattern(split["pattern"]["Regex"]))
        contents = sorted(self._added, key=len, reverse=True)
        self._added_re = (re.compile("|".join(map(re.escape, contents))) if contents else None)
        self._nfc = spec.get("normalizer") is not None
        self._cache: Dict[str, tuple] = {}
        self._bytes: Dict[int, bytes] = {}

    @classmethod
    def from_dir(cls, path) -> "Qwen2BPETokenizer":
        path = Path(path)
        with open(path / "tokenizer.json", encoding="utf-8") as f:
            spec = json.load(f)
        config_path = path / "tokenizer_config.json"
        if not config_path.is_file():
            raise FileNotFoundError(f"{path}: tokenizer.json without tokenizer_config.json")
        with open(config_path, encoding="utf-8") as f:
            config = json.load(f)
        return cls(spec, config)

    # ------------------------------------------------------------- checks
    @staticmethod
    def _check_components(spec: dict) -> None:
        norm = spec.get("normalizer")
        _require(norm is None or norm.get("type") == "NFC",
                 f"normalizer {norm and norm.get('type')!r} (reads NFC or none)")
        pre = spec.get("pre_tokenizer") or {}
        subs = pre.get("pretokenizers") or []
        _require(pre.get("type") == "Sequence" and [p.get("type") for p in subs] == [
            "Split", "ByteLevel"], "pre_tokenizer (reads Sequence[Split, ByteLevel]): "
            f"{pre.get('type')!r} {[p.get('type') for p in subs]}")
        split, byte_level = subs
        _require(split.get("behavior") == "Isolated",
                 f"Split behavior {split.get('behavior')!r} (reads Isolated)")
        _flag_off(split, "invert")
        _require("Regex" in (split.get("pattern") or {}), f"Split pattern {split.get('pattern')!r}")
        for key in ("add_prefix_space", "use_regex"):  # both default to true
            _require(byte_level.get(key) is False, f"ByteLevel {key}={byte_level.get(key)!r}")
        model = spec.get("model") or {}
        _require(model.get("type") == "BPE", f"model {model.get('type')!r} (reads BPE)")
        for key in ("dropout", "byte_fallback", "fuse_unk", "ignore_merges",
                    "continuing_subword_prefix", "end_of_word_suffix"):
            _flag_off(model, key)
        dec = spec.get("decoder") or {}
        _require(dec.get("type") == "ByteLevel", f"decoder {dec.get('type')!r} (reads ByteLevel)")
        post = spec.get("post_processor")
        _require(post is None or post.get("type") == "ByteLevel",
                 f"post_processor {post and post.get('type')!r} (reads ByteLevel or none)")

    def _check_config(self, config: dict) -> None:
        for i, tok in (config.get("added_tokens_decoder") or {}).items():
            content = tok.get("content")
            _require(self._added.get(content) == int(i)
                     and bool(tok.get("special")) == (content in self._special),
                     f"tokenizer_config.json added token {i}: {tok} (not as in tokenizer.json)")
        named = [config.get(k) for k in ("bos_token", "eos_token", "unk_token", "pad_token")]
        for tok in named + list(config.get("additional_special_tokens") or []):
            content = _token_content(tok)
            _require(content is None or content in self._special,
                     f"tokenizer_config.json special token {content!r} that is not a special "
                     "added token of tokenizer.json")

    # ------------------------------------------------------------- encode
    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def __len__(self) -> int:
        return self._len

    def _bpe(self, piece: str) -> tuple:
        """The ids of one pre-token: its UTF-8 bytes as byte-level
        characters, merged pair by pair, the lowest rank first (the leftmost
        of equal ranks), as ``tokenizers``' BPE does."""
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        word = list(piece.encode("utf-8").decode("latin-1").translate(_BYTE_CHAR))
        ranks = self._ranks
        while len(word) > 1:
            best, at = None, -1
            for i in range(len(word) - 1):
                r = ranks.get((word[i], word[i + 1]))
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            word[at:at + 2] = [word[at] + word[at + 1]]
        ids = tuple(self._vocab[t] for t in word)
        if len(self._cache) < _CACHE_ENTRIES and len(piece) <= _CACHE_CHARS:
            self._cache[piece] = ids
        return ids

    def pre_tokenize(self, text: str) -> List[str]:
        """The Split pre-tokenizer's pieces of ``text`` (normalized already).
        Qwen2's pattern matches every character; a pattern that leaves text
        between its matches, or matches the empty string, raises."""
        folded = _fold_astral(text) if max(text, default="") >= "\U00010000" else text
        pieces = self._split.findall(folded)
        if sum(map(len, pieces)) != len(text) or "" in pieces:
            raise ValueError(f"tokenizer.json: the pre-tokenizer pattern does not split "
                             f"{text!r} into non-empty pieces that cover it")
        if folded is text:
            return pieces
        ends = list(itertools.accumulate(map(len, pieces)))
        return [text[i:j] for i, j in zip([0] + ends, ends)]

    def _encode_text(self, text: str, out: List[int]) -> None:
        """The ids of text between added tokens: NFC, pre-tokens, BPE."""
        if self._nfc:
            text = unicodedata.normalize("NFC", text)
        cache = self._cache
        for piece in self.pre_tokenize(text):
            ids = cache.get(piece)
            out.extend(ids if ids is not None else self._bpe(piece))

    def encode(self, text: str, add_special_tokens: bool = True, **kw) -> List[int]:
        """Ids of ``text``. The ByteLevel post-processor adds no token, so
        ``add_special_tokens`` changes nothing, as in ``Qwen2TokenizerFast``."""
        ids: List[int] = []
        start = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > start:
                    self._encode_text(text[start:m.start()], ids)
                ids.append(self._added[m.group()])
                start = m.end()
        if start < len(text):
            self._encode_text(text[start:], ids)
        return ids

    def __call__(self, text: str, **kw) -> dict:
        ids = self.encode(text, **kw)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    # ------------------------------------------------------------- decode
    def _token_bytes(self, token_id: int, token: str) -> bytes:
        """The ByteLevel decoder's bytes of one token: its characters mapped
        back to bytes, or its own UTF-8 when one is outside the map."""
        b = self._bytes.get(token_id)
        if b is None:
            if all(c in _CHAR_BYTE for c in token):
                b = bytes(_CHAR_BYTE[c] for c in token)
            else:
                b = token.encode("utf-8")
            self._bytes[token_id] = b
        return b

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None, **kw) -> str:
        """The text of ``ids``: unknown ids are dropped, special added tokens
        too under ``skip_special_tokens``, and the bytes are read as UTF-8
        with U+FFFD for each bad sequence (a prefix may cut a character)."""
        if isinstance(ids, numbers.Integral):
            ids = [ids]
        buf = bytearray()
        for i in ids:
            i = _u32(i)
            token = self._id_to_token.get(i)
            if token is None or (skip_special_tokens and token in self._special):
                continue
            buf += self._token_bytes(i, token)
        text = buf.decode("utf-8", errors="replace")
        if clean_up_tokenization_spaces is None:
            clean_up_tokenization_spaces = self.clean_up_tokenization_spaces
        if clean_up_tokenization_spaces:
            for a, b in _CLEAN_UP:
                text = text.replace(a, b)
        return text

    # --------------------------------------------------------- conversions
    def convert_tokens_to_ids(self, tokens):
        """The id of a token (or a list of ids): an added token, else a
        vocabulary entry, else ``unk_token_id`` (None when unset)."""
        if isinstance(tokens, str):
            i = self._added.get(tokens, self._vocab.get(tokens))
            return self.unk_token_id if i is None else i
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        """The token of an id (or a list of tokens); None for an unknown id."""
        if isinstance(ids, numbers.Integral):
            return self._id_to_token.get(_u32(ids))
        return [self._id_to_token.get(_u32(i)) for i in ids]


def _u32(i) -> int:
    """An id as ``tokenizers`` takes it: an unsigned 32-bit integer."""
    i = int(i)
    if not 0 <= i < 1 << 32:
        raise OverflowError(f"token id {i} is not an unsigned 32-bit integer")
    return i
