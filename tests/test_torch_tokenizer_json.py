"""The port's ``tokenizer.json`` reader (``dynamo_tpu_torch/llm/bpe_model.py``
behind ``llm/tokenizer.py``) against the JAX package's
``HuggingFaceTokenizer``, which runs the ``tokenizers`` package, over
files trained here with the package's own trainer:

- GPT-2's ByteLevel BPE (``tests/fixtures.build_tiny_tokenizer``);
- Llama-3's Split + regex-less ByteLevel, with and without
  ``ignore_merges``, with pair-form and string-form merges;
- Qwen2's NFC + Split (single digits);
- DeepSeek-V2's Sequence of Splits;
- a SentencePiece-style BPE with ``byte_fallback`` (Prepend / Replace
  normalizers; Replace, ByteFallback, Fuse and Strip decoders), and one
  with a Metaspace pre-tokenizer and an lstrip / rstrip / single_word
  added token;
- the Llama-3-form file that ``chip_smoke.py`` phase 7 writes.

Ids, tokens, decoded text (with and without the special tokens), the id
and token maps and the vocabulary size are exact matches. A component the
reader does not implement raises ``ValueError``.
"""

import json
import os
import sys

import pytest
from hypothesis import given, settings, strategies as st
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                        normalizers, pre_tokenizers, processors, trainers)

from dynamo_tpu.llm.tokenizer import HuggingFaceTokenizer as JaxTokenizer
from dynamo_tpu_torch.llm import bpe_model
from dynamo_tpu_torch.llm.tokenizer import HuggingFaceTokenizer
from tests.fixtures import CORPUS, build_tiny_tokenizer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>"]
LLAMA3 = chip_smoke.LLAMA3_SPLIT
QWEN2 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
         r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
TRAIN = CORPUS + [
    "it's 2024, we'll see 1234567 cats\r\n\tand 3.14159 dogs",
    "Ünïcödé ΑΒΓ αβγ добрый день 한국어 中文字符 😀👍🏽 🎉",
]
# CJK, emoji, digit runs, contractions, \r\n, U+001C-U+001F (not White_Space
# for the package's regex engine), U+0085, U+00A0, U+3000, special tokens
# inside the text
TEXTS = [
    "",
    "hello world",
    "the quick brown fox jumps over the lazy dog",
    "日本語のテキストも少し含める 中文字符 한국어",
    "emoji 😀👍🏽🎉 and ZWJ 👨‍👩‍👧",
    "digits 1 12 123 1234 12345678901 3.14159",
    "it's we'll they've I'M don't 'S",
    "line one\r\nline two\n\n\tindented  \r\n",
    "a\x1c\x1cb c\x1d\x1ed\x1f e",
    "nel\x85nbsp\xa0ideographic　space",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi"
    "<|eot_id|>",
    "text<|eot_id|>more <|end_of_text|> tail",
    "señor açaí naïve café résumé über straße",
    "   leading and trailing spaces   ",
]


def _trainer(vocab: int, specials, alphabet=True):
    return trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=list(specials),
        initial_alphabet=(pre_tokenizers.ByteLevel.alphabet() if alphabet
                          else []))


def _byte_level_split(pattern: str, normalizer=None) -> Tokenizer:
    tok = Tokenizer(models.BPE(unk_token=None))
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            special_tokens=[("<|begin_of_text|>", 0)])])
    tok.train_from_iterator(TRAIN * 4, _trainer(700, SPECIALS))
    return tok


def _deepseek() -> Tokenizer:
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(r"[\r\n]"), "isolated"),
        pre_tokenizers.Split(Regex(r"\s?[A-Za-zµÀ-ÖØ-öø-ƺ]+"), "isolated"),
        pre_tokenizers.Split(Regex(r"\s?[!-/:-~！-／：-～‘-‟　-。]+"),
                             "isolated"),
        pre_tokenizers.Split(Regex(r"\s+$"), "isolated"),
        pre_tokenizers.Split(Regex(r"[一-龥ࠀ-一가-퟿]+"), "isolated"),
        pre_tokenizers.Split(Regex(r"\p{N}+"), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TRAIN * 4, _trainer(700, SPECIALS))
    return tok


def _sentencepiece_bpe() -> Tokenizer:
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    bytes_ = [f"<0x{b:02X}>" for b in range(256)]
    tok.train_from_iterator(TRAIN * 4, _trainer(
        500, ["<unk>", "<s>", "</s>"] + bytes_, alphabet=False))
    tok.add_special_tokens(["<|end|>", "<|user|>"])
    return tok


def _metaspace() -> Tokenizer:
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True))
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Metaspace(prepend_scheme="first")
    bytes_ = [f"<0x{b:02X}>" for b in range(256)]
    tok.train_from_iterator(TRAIN * 4, _trainer(
        500, ["<unk>", "<s>"] + bytes_, alphabet=False))
    tok.add_tokens([AddedToken("wörld", single_word=True, lstrip=True,
                               rstrip=True, normalized=False),
                    AddedToken("fox", normalized=True)])
    return tok


def _with(tok: Tokenizer, **model) -> dict:
    spec = json.loads(tok.to_str())
    spec["model"].update(model)
    return spec


def _string_merges(tok: Tokenizer) -> dict:
    spec = json.loads(tok.to_str())
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    return spec


def _specs() -> dict:
    gpt2 = json.loads(build_tiny_tokenizer().to_str())
    llama3 = _byte_level_split(LLAMA3)
    return {
        "gpt2_byte_level": gpt2,
        "llama3": json.loads(llama3.to_str()),
        "llama3_ignore_merges": _with(llama3, ignore_merges=True),
        "llama3_string_merges": _string_merges(llama3),
        "qwen2_nfc": json.loads(_byte_level_split(
            QWEN2, normalizers.NFC()).to_str()),
        "deepseek_splits": json.loads(_deepseek().to_str()),
        "sentencepiece_byte_fallback": json.loads(
            _sentencepiece_bpe().to_str()),
        "metaspace_added_tokens": json.loads(_metaspace().to_str()),
    }


SPECS = _specs()


@pytest.fixture(scope="module")
def chat_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama3-chat") / "tokenizer.json"
    path.write_text(json.dumps(chip_smoke.llama3_tokenizer_json(),
                               ensure_ascii=False), encoding="utf-8")
    return str(path)


def _pair(spec: dict, tmp_path) -> tuple:
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    return (HuggingFaceTokenizer.from_file(str(path)),
            JaxTokenizer.from_file(str(path)))


def _check_text(port, ref, text: str) -> None:
    for special in (False, True):
        want = ref.encode(text, add_special_tokens=special)
        got = port.encode(text, add_special_tokens=special)
        assert got.ids == want.ids, (text, special)
        assert got.tokens == want.tokens, (text, special)
        for skip in (False, True):
            assert (port.decode(want.ids, skip_special_tokens=skip)
                    == ref.decode(want.ids, skip_special_tokens=skip)), (
                        text, special, skip)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_corpus_matches_tokenizers(name, tmp_path):
    port, ref = _pair(SPECS[name], tmp_path)
    assert port.vocab_size == ref.vocab_size
    for text in TEXTS + TRAIN:
        _check_text(port, ref, text)
    # every id decodes alone as the package decodes it, and maps back
    for i in range(ref.vocab_size + 2):
        assert port.id_to_token(i) == ref.id_to_token(i), i
        tok = ref.id_to_token(i)
        if tok is not None:
            assert port.token_to_id(tok) == ref.token_to_id(tok), tok
            assert port.decode([i], False) == ref.decode([i], False), i


def test_chip_smoke_file_matches_tokenizers(chat_file):
    port = HuggingFaceTokenizer.from_file(chat_file)
    ref = JaxTokenizer.from_file(chat_file)
    assert port.vocab_size == ref.vocab_size == 128256
    for text in TEXTS + [chip_smoke.CHAT_PROMPT,
                         " ".join(chip_smoke.WORDS * 3)]:
        _check_text(port, ref, text)
    ids = port.encode(chip_smoke.CHAT_PROMPT).ids
    assert ids[:2] == [chip_smoke.LLAMA3_BOS, 128006]
    assert port.decode(ids, skip_special_tokens=False) == \
        chip_smoke.CHAT_PROMPT
    for tid, content in chip_smoke.LLAMA3_SPECIALS.items():
        assert port.token_to_id(content) == 128000 + tid


# arbitrary text, surrogates left out (they do not encode to UTF-8)
_TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=40)


@pytest.mark.parametrize("name", ["llama3_ignore_merges", "qwen2_nfc",
                                  "sentencepiece_byte_fallback"])
def test_arbitrary_text_matches_tokenizers(name, tmp_path):
    port, ref = _pair(SPECS[name], tmp_path)

    @settings(max_examples=150, deadline=None, database=None)
    @given(_TEXT, st.sampled_from(["", "<|eot_id|>", "<s>", "\r\n"]))
    def prop(text, special):
        _check_text(port, ref, text + special + text[::-1])
    prop()


@pytest.mark.parametrize("name", ["gpt2_byte_level",
                                  "sentencepiece_byte_fallback"])
def test_decode_stream_across_multibyte_characters(name, tmp_path):
    """DecodeStream holds a partial UTF-8 character back, on both
    tokenizers alike, for text whose characters span several tokens."""
    port, ref = _pair(SPECS[name], tmp_path)
    text = "naïve 日本語 😀👍🏽 straße 한국어 🎉 end"
    ids = ref.encode(text).ids
    assert len(ids) > len(text.split())
    for skip in (False, True):
        a, b = port.decode_stream(skip), ref.decode_stream(skip)
        got = [a.step(i) for i in ids]
        assert got == [b.step(i) for i in ids]
        assert "".join(x for x in got if x) == ref.decode(ids, skip)


@pytest.mark.parametrize("where,component", [
    ("normalizer", {"type": "Lowercase"}),
    ("normalizer", {"type": "Sequence",
                    "normalizers": [{"type": "NFC"}, {"type": "NFD"}]}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                       "behavior": "Isolated", "invert": False}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 2],
                        "cls": ["<s>", 0]}),
    ("model", {"type": "WordPiece", "vocab": {"a": 0},
               "unk_token": "a"}),
    ("model", {"type": "BPE", "dropout": 0.1, "vocab": {"a": 0},
               "merges": []}),
    ("truncation", {"max_length": 8, "strategy": "LongestFirst",
                    "stride": 0, "direction": "Right"}),
])
def test_unsupported_component_raises(where, component):
    spec = json.loads(json.dumps(SPECS["gpt2_byte_level"]))
    spec[where] = component
    with pytest.raises(ValueError, match="unsupported|tokenizer.json"):
        bpe_model.BpeTokenizer(spec)


def test_white_space_is_the_package_s():
    """Python's \\s counts U+001C-U+001F; the translated class does not,
    and U+0085, U+00A0 and U+3000 stay whitespace, as in the package."""
    rx = bpe_model.translate_regex(r"\s+")
    for c in "\x1c\x1d\x1e\x1f":
        assert rx.fullmatch(c) is None
    for c in "\t\n\r \x85\xa0　 ":
        assert rx.fullmatch(c) is not None
