"""The port's Qwen2 BPE tokenizer (``processing/bpe.py``) against the JAX
package's ``load_tokenizer`` (``transformers``' ``Qwen2TokenizerFast``) on
the committed fixture directory (``tools/tokenizer_fixture.py``), and
against ``tokenizers``' own pre-tokenizer and normalizer.

- ids and decodes: 400 seeded mixed texts (``torch_tokenizer_data``) and
  ``hypothesis`` texts with the added tokens mixed in; ``encode`` with and
  without special tokens, ``decode`` with and without skipping them,
  prefixes cut mid-character included, random id lists, and the token/id
  conversions on known and unknown inputs: all equal exactly;
- exhaustive: every non-surrogate code point in the contexts ``a{c}b``,
  `` {c}``, ``'{c}``, ``{c}\\n``, ``1{c}``, pre-tokenized by the port and by
  ``tokenizers`` (whose Oniguruma tables are of a newer Unicode than
  Python 3.12's 15.0); NFC over every code point in order. Any code point
  on which they differ must be unassigned in Python's Unicode 15.0;
- the JAX and port ``DelayProcessor``, ``RealtimeProcessor`` and
  ``TextDeltaTokenizer`` over the fixture give equal grids and released ids;
- the committed expected ids of ``chip_smoke.py`` are what the JAX package
  gives today;
- the loader's rules: ``tokenizer.json`` -> ``Qwen2BPETokenizer``; no
  tokenizer files -> the byte fallback; ``vocab.json``/``merges.txt`` alone
  -> ``FileNotFoundError``; unsupported components -> ``ValueError``.

The JAX package's tokenizer loads once per module (~12 s, most of it the
``transformers`` import).
"""
import copy
import json
import unicodedata

import numpy as np
import pytest

pytest.importorskip("transformers")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import Tokenizer, models, normalizers  # noqa: E402

from mosstts_tpu.core import config as jconfig  # noqa: E402
from mosstts_tpu.engine.streaming import TextDeltaTokenizer as JTextDelta  # noqa: E402
from mosstts_tpu.processing.delay_processor import DelayProcessor as JDelayProcessor  # noqa: E402
from mosstts_tpu.processing.realtime_processor import (  # noqa: E402
    RealtimeProcessor as JRTProcessor)
from mosstts_tpu.processing.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from mosstts_tpu_torch.core import config as tconfig  # noqa: E402
from mosstts_tpu_torch.engine.streaming import TextDeltaTokenizer  # noqa: E402
from mosstts_tpu_torch.processing.bpe import Qwen2BPETokenizer  # noqa: E402
from mosstts_tpu_torch.processing.delay_processor import DelayProcessor  # noqa: E402
from mosstts_tpu_torch.processing.realtime_processor import RealtimeProcessor  # noqa: E402
from mosstts_tpu_torch.processing.tokenizer import (SPECIAL_TOKENS,  # noqa: E402
                                                    ByteFallbackTokenizer, load_tokenizer)
from mosstts_tpu_torch.tools import tokenizer_fixture as fx  # noqa: E402
from tests.test_torch_processing import _CodesAsWave  # noqa: E402
from torch_tokenizer_data import build_expected, mixed_texts  # noqa: E402

ADDED = [t["content"] for t in fx.added_tokens()]
CONTEXTS = ("a{}b", " {}", "'{}", "{}\n", "1{}")
CHUNK = 1024  # code points a batched string holds


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    return fx.write_tokenizer_dir(tmp_path_factory.mktemp("tokenizer"))


@pytest.fixture(scope="module")
def toks(tok_dir):
    """(JAX's tokenizer, the port's) over the fixture directory."""
    return jax_load_tokenizer(str(tok_dir)), load_tokenizer(str(tok_dir))


def _same_decodes(jt, tt, ids):
    for kw in ({}, {"skip_special_tokens": True}, {"clean_up_tokenization_spaces": True}):
        assert tt.decode(ids, **kw) == jt.decode(ids, **kw), (ids, kw)


def test_load_tokenizer_reads_the_checkpoint_bpe(toks):
    jt, tt = toks
    assert type(jt).__name__ == "Qwen2TokenizerFast"
    assert type(tt) is Qwen2BPETokenizer
    assert tt.vocab_size == jt.vocab_size == 151643
    assert len(tt) == len(jt) == 151669
    for name, i in SPECIAL_TOKENS.items():
        assert tt.convert_tokens_to_ids(name) == jt.convert_tokens_to_ids(name) == i


@pytest.mark.parametrize("add_special_tokens", [True, False])
def test_seeded_texts_ids_and_decodes_equal_jax(toks, add_special_tokens):
    jt, tt = toks
    for text in mixed_texts(1, 400):
        ids = jt.encode(text, add_special_tokens=add_special_tokens)
        assert tt.encode(text, add_special_tokens=add_special_tokens) == ids, text
        assert tt(text)["input_ids"] == jt(text)["input_ids"]
        for k in range(len(ids) + 1):  # every prefix: cut characters decode as U+FFFD
            _same_decodes(jt, tt, ids[:k])


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(parts=st.lists(st.one_of(st.text(), st.sampled_from(ADDED)), max_size=8),
       cut=st.integers(0, 64))
def test_hypothesis_texts_equal_jax(toks, parts, cut):
    jt, tt = toks
    text = "".join(parts)
    ids = jt.encode(text, add_special_tokens=False)
    assert tt.encode(text, add_special_tokens=False) == ids
    assert tt.encode(text) == jt.encode(text)
    _same_decodes(jt, tt, ids)
    _same_decodes(jt, tt, ids[:cut])


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(ids=st.lists(st.one_of(st.integers(0, 3100), st.integers(151600, 151700)), max_size=24))
def test_hypothesis_id_lists_decode_as_jax(toks, ids):
    """Core tokens, fillers, added tokens and unknown ids past the end."""
    _same_decodes(*toks, ids)


def test_token_id_conversions_equal_jax(toks):
    jt, tt = toks
    rng = np.random.default_rng(2)
    ids = [0, 255, 256, 2999, 3000, 151642, 151643, 151668, 151669, 10 ** 6]
    ids += rng.integers(0, 151700, 200).tolist()
    for i in ids:
        assert tt.convert_ids_to_tokens(i) == jt.convert_ids_to_tokens(i), i
    assert tt.convert_ids_to_tokens(ids) == jt.convert_ids_to_tokens(ids)
    assert tt.convert_ids_to_tokens(np.int64(151652)) == jt.convert_ids_to_tokens(151652)
    tokens = [jt.convert_ids_to_tokens(i) for i in ids if i < 151669]
    tokens += ADDED + ["nope", "", "<|im_start", "im_start|>", "<fill3000>", "Ġ", "the",
                       "<|AUDIO_START|>", "ſ"]
    for t in tokens:
        assert tt.convert_tokens_to_ids(t) == jt.convert_tokens_to_ids(t), t
    assert tt.convert_tokens_to_ids(tokens) == jt.convert_tokens_to_ids(tokens)
    assert tt.convert_tokens_to_ids("nope") is None
    assert tt.convert_ids_to_tokens(151669) is None
    for bad in (-1, 1 << 32):  # no unsigned 32-bit id: both raise
        for fn in (lambda t: t.decode([5, bad]), lambda t: t.convert_ids_to_tokens(bad)):
            for t in (jt, tt):
                with pytest.raises(OverflowError):
                    fn(t)


def _code_points() -> np.ndarray:
    return np.array([c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF], np.uint32)


def _in_contexts(cps: np.ndarray) -> str:
    """Each code point in each of ``CONTEXTS``, one after another."""
    cols = []
    for ctx in CONTEXTS:
        for ch in ctx.replace("{}", "\0"):
            cols.append(cps if ch == "\0" else np.full_like(cps, ord(ch)))
    return np.stack(cols, 1).tobytes().decode("utf-32-le")


def _assigned_in_python(cps) -> list:
    return [hex(c) for c in sorted(cps) if unicodedata.category(chr(c)) != "Cn"]


def test_pre_tokenizer_equals_tokenizers_on_every_code_point(tok_dir, toks):
    """Piece boundaries of the port's ``pre_tokenize`` against a WordLevel
    tokenizer with the fixture's own pre-tokenizer (one token a piece, its
    offsets the piece's), batched ``CHUNK`` code points a string; a string
    that differs is redone context by context to name its code points."""
    tt = toks[1]
    ref = Tokenizer(models.WordLevel({"[UNK]": 0}, unk_token="[UNK]"))
    ref.pre_tokenizer = Tokenizer.from_file(str(tok_dir / "tokenizer.json")).pre_tokenizer

    def ends(pieces):
        return np.cumsum(list(map(len, pieces)))

    cps = _code_points()
    chunks = [cps[k:k + CHUNK] for k in range(0, len(cps), CHUNK)]
    texts = [_in_contexts(c) for c in chunks]
    differ = set()
    for chunk, text, enc in zip(chunks, texts, ref.encode_batch(texts, add_special_tokens=False)):
        if np.array_equal(ends(tt.pre_tokenize(text)), np.array(enc.offsets)[:, 1]):
            continue
        one = [ctx.format(chr(c)) for c in chunk for ctx in CONTEXTS]
        for c, s, e in zip(np.repeat(chunk, len(CONTEXTS)), one,
                           ref.encode_batch(one, add_special_tokens=False)):
            if list(ends(tt.pre_tokenize(s))) != [b for _, b in e.offsets]:
                differ.add(int(c))
    # tokenizers' tables are Unicode 16's: the letters and numbers it added
    # (e.g. Garay, Kirat Rai) are unassigned in Python 3.12's Unicode 15.0
    assert not _assigned_in_python(differ), _assigned_in_python(differ)


def test_nfc_equals_tokenizers_on_every_code_point():
    ref = normalizers.NFC()
    cps = _code_points()
    differ = set()
    for k in range(0, len(cps), 1 << 16):
        chunk = cps[k:k + (1 << 16)]
        text = chunk.tobytes().decode("utf-32-le")
        if unicodedata.normalize("NFC", text) != ref.normalize_str(text):
            differ |= {int(c) for c in chunk
                       if unicodedata.normalize("NFC", chr(c)) != ref.normalize_str(chr(c))}
    assert not _assigned_in_python(differ), _assigned_in_python(differ)


def _delay_processors(jt, tt):
    return (JDelayProcessor(jt, _CodesAsWave(), jconfig.DelayConfig(
                language_config=jconfig.tiny_qwen3(), n_vq=4)),
            DelayProcessor(tt, _CodesAsWave(), tconfig.DelayConfig(
                language_config=tconfig.tiny_qwen3(), n_vq=4)))


def _conversations(proc, texts, rng):
    convs = {"generation": [], "continuation": []}
    for i, text in enumerate(texts):
        codes = rng.integers(0, 1024, size=(int(rng.integers(3, 9)), 4))
        ref = [codes] if i % 2 else None
        convs["generation"].append([proc.build_user_message(text=text, reference=ref)])
        convs["continuation"].append([proc.build_user_message(text=text, reference=ref),
                                      proc.build_assistant_message([codes])])
    return convs


def test_processors_and_delta_tokenizer_equal_jax(toks):
    jt, tt = toks
    # the texts keep their added tokens but those that mark audio blocks
    texts = [t.replace("<|audio_start|>", "").replace("<|audio_end|>", "")
             for t in mixed_texts(3, 12)]
    jproc, tproc = _delay_processors(jt, tt)
    jconvs = _conversations(jproc, texts, np.random.default_rng(4))
    tconvs = _conversations(tproc, texts, np.random.default_rng(4))
    for mode in ("generation", "continuation"):
        for b in range(0, len(texts), 4):  # left-padded batches of 4
            jb = jproc(jconvs[mode][b:b + 4], mode=mode)
            tb = tproc(tconvs[mode][b:b + 4], mode=mode)
            for key in jb:
                np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]))

    # decode: generated text ids (a multi-byte character cut between the
    # prompt and the reply included), then an audio block
    c = jconfig.DelayConfig(n_vq=4)
    rng = np.random.default_rng(5)
    outputs = []
    for text in texts[:4]:
        ids = jt.encode(text + " 语音")
        gen = np.full((len(ids) + 12, 5), c.audio_pad_code, np.int64)
        gen[:len(ids), 0] = ids
        gen[len(ids), 0] = c.audio_start_token_id
        gen[len(ids) + 1:len(ids) + 8, 0] = c.audio_assistant_gen_slot_token_id
        gen[len(ids) + 1:len(ids) + 8, 1:] = rng.integers(0, 1024, size=(7, 4))
        gen[len(ids) + 8:-1, 0] = c.audio_assistant_delay_slot_token_id
        gen[-1, 0] = c.audio_end_token_id
        outputs.append((max(1, len(ids) // 2), gen))
    for a, b in zip(jproc.decode(outputs), tproc.decode(outputs)):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.content == a.content and b.content

    rcfg = jconfig.RealtimeConfig(language_config=jconfig.tiny_qwen3())
    jr, tr = JRTProcessor(jt, channels=rcfg.rvq), RealtimeProcessor(tt, channels=rcfg.rvq)
    assert (tr.audio_pad_token_id, tr.text_pad_token_id) == (jr.audio_pad_token_id,
                                                            jr.text_pad_token_id)
    prompt = rng.integers(0, 1024, size=(6, rcfg.rvq))
    np.testing.assert_array_equal(tr.make_ensemble(prompt), jr.make_ensemble(prompt))
    np.testing.assert_array_equal(tr.make_ensemble(None), jr.make_ensemble(None))
    for text in texts:
        audio = rng.integers(0, 1024, size=(int(rng.integers(2, 20)), rcfg.rvq))
        np.testing.assert_array_equal(tr.make_user_prompt(text, audio),
                                      jr.make_user_prompt(text, audio))

    for text in texts:
        cuts = np.sort(rng.integers(0, len(text) + 1, 6))  # random-length deltas
        pieces = [text[i:j] for i, j in zip([0, *cuts], [*cuts, None])]
        for deltas in (fx.delta_words(text), pieces):
            jd, td = JTextDelta(jt), TextDeltaTokenizer(tt)
            assert [td.push_delta(d) for d in deltas] == [jd.push_delta(d) for d in deltas]
            assert td.flush() == jd.flush() and td.token_ids == jd.token_ids


def test_committed_smoke_expectations_are_jax_s(tok_dir):
    """``chip_smoke.py`` checks the port against ``tokenizer_fixture_expected.json``;
    the JAX package gives the same today."""
    assert build_expected(tok_dir) == fx.load_expected()


def _spec(tok_dir) -> dict:
    with open(tok_dir / "tokenizer.json", encoding="utf-8") as f:
        return json.load(f)


def _config(tok_dir) -> dict:
    with open(tok_dir / "tokenizer_config.json", encoding="utf-8") as f:
        return json.load(f)


def test_merges_written_as_pairs_read_the_same(tok_dir, toks):
    spec = _spec(tok_dir)
    spec["model"]["merges"] = [m.split(" ", 1) for m in spec["model"]["merges"]]
    tt = Qwen2BPETokenizer(spec, _config(tok_dir))
    ref = Tokenizer.from_str(json.dumps(spec))
    for text in mixed_texts(6, 50):
        assert tt.encode(text) == toks[1].encode(text) == ref.encode(text).ids


BAD = {
    "normalizer": lambda s: s.update(normalizer={"type": "NFKC"}),
    "pre_tokenizer": lambda s: s["pre_tokenizer"]["pretokenizers"].pop(0),
    "Split behavior": lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(behavior="Removed"),
    "invert": lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(invert=True),
    "\\p{Lu}": lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(
        pattern={"Regex": r"\p{Lu}+|\s+|."}),
    "escape \\d": lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(
        pattern={"Regex": r"\d+|\s+"}),
    "add_prefix_space": lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(
        add_prefix_space=True),
    "use_regex": lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(use_regex=True),
    "model": lambda s: s["model"].update(type="WordPiece"),
    "dropout": lambda s: s["model"].update(dropout=0.1),
    "byte_fallback": lambda s: s["model"].update(byte_fallback=True),
    "fuse_unk": lambda s: s["model"].update(fuse_unk=True),
    "ignore_merges": lambda s: s["model"].update(ignore_merges=True),
    "continuing_subword_prefix": lambda s: s["model"].update(continuing_subword_prefix="##"),
    "end_of_word_suffix": lambda s: s["model"].update(end_of_word_suffix="</w>"),
    "decoder": lambda s: s.update(decoder={"type": "WordPiece"}),
    "post_processor": lambda s: s.update(post_processor={"type": "TemplateProcessing"}),
    "lstrip": lambda s: s["added_tokens"][0].update(lstrip=True),
    "rstrip": lambda s: s["added_tokens"][1].update(rstrip=True),
    "single_word": lambda s: s["added_tokens"][2].update(single_word=True),
    "normalized": lambda s: s["added_tokens"][3].update(normalized=True),
    "merge": lambda s: s["model"]["merges"].append("Ġ zzzz"),
    "byte-level": lambda s: s["model"]["vocab"].pop("Ġ"),
}


@pytest.mark.parametrize("what", list(BAD))
def test_unsupported_components_raise(tok_dir, what):
    spec = _spec(tok_dir)
    BAD[what](spec)
    with pytest.raises(ValueError, match="tokenizer.json"):
        Qwen2BPETokenizer(spec, _config(tok_dir))


def test_config_that_disagrees_with_the_file_raises(tok_dir):
    spec, config = _spec(tok_dir), _config(tok_dir)
    for change in (lambda c: c.update(tokenizer_class="LlamaTokenizer"),
                   lambda c: c["added_tokens_decoder"]["151667"].update(special=True),
                   lambda c: c.update(eos_token="<think>"),
                   lambda c: c["additional_special_tokens"].append("hello")):
        bad = copy.deepcopy(config)
        change(bad)
        with pytest.raises(ValueError, match="tokenizer"):
            Qwen2BPETokenizer(spec, bad)


def test_loader_rules(tmp_path, tok_dir):
    assert type(load_tokenizer(None)) is ByteFallbackTokenizer
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text("{}")
    assert type(load_tokenizer(str(empty))) is ByteFallbackTokenizer
    old = tmp_path / "old"
    old.mkdir()
    (old / "vocab.json").write_text("{}")
    (old / "merges.txt").write_text("#version: 0.2\n")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        load_tokenizer(str(old))
    no_config = tmp_path / "no-config"
    no_config.mkdir()
    (no_config / "tokenizer.json").write_text((tok_dir / "tokenizer.json").read_text())
    with pytest.raises(FileNotFoundError, match="tokenizer_config.json"):
        load_tokenizer(str(no_config))
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "no-such-dir"))
    bad = tmp_path / "bad"
    fx.write_tokenizer_dir(bad)
    spec = _spec(bad)
    spec["model"]["type"] = "Unigram"
    (bad / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="Unigram"):  # never the byte fallback
        load_tokenizer(str(bad))
