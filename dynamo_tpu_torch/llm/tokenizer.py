"""Tokenizer wrapper + incremental detokenization (a copy of
``dynamo_tpu.llm.tokenizer``). The HF kind imports ``tokenizers`` only when
one is built, since the GPU machine may lack the package; the
SentencePiece kind runs on the native engine (``sp_model.py``).

Reference: lib/llm/src/tokenizers.rs (570 LoC) and tokenizers/hf.rs — a thin
facade over HF `tokenizers` exposing `encode`, `decode`, and a stateful
`DecodeStream` that emits UTF-8-safe text increments token by token. The
incremental decoder mirrors the reference's prefix-offset algorithm: decode a
sliding window, only surface text once it no longer ends in a replacement
character (incomplete UTF-8 / byte-fallback sequence).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

_REPLACEMENT = "�"


@dataclasses.dataclass
class Encoding:
    """Reference `Encoding` (tokenizers.rs): ids + offsets view."""

    ids: List[int]
    tokens: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.ids)


class HuggingFaceTokenizer:
    """Wraps a `tokenizer.json` (HF tokenizers). Reference tokenizers/hf.rs."""

    def __init__(self, tokenizer):
        self._tk = tokenizer

    @classmethod
    def from_file(cls, path: str) -> "HuggingFaceTokenizer":
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise RuntimeError(
                f"{path}: a tokenizer.json needs the 'tokenizers' package, "
                f"which is not installed; use a SentencePiece "
                f"tokenizer.model instead") from e
        return cls(Tokenizer.from_file(path))

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "HuggingFaceTokenizer":
        path = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(path):
            return cls.from_file(path)
        raise FileNotFoundError(f"no tokenizer.json under {model_dir}")

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        enc = self._tk.encode(text, add_special_tokens=add_special_tokens)
        return Encoding(ids=list(enc.ids), tokens=list(enc.tokens))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def id_to_token(self, token_id: int) -> Optional[str]:
        return self._tk.id_to_token(token_id)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tk.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size()

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


class DecodeStream:
    """Stateful incremental detokenizer.

    Reference `DecodeStream` (tokenizers.rs): feed one token id at a time,
    receive the new UTF-8-complete text (or None if the token only partially
    completes a multi-byte character, e.g. byte-fallback tokens).
    """

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self._tk = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_offset = 0  # start of the context window
        self._read_offset = 0    # everything before this has been emitted

    def step(self, token_id: int) -> Optional[str]:
        self._ids.append(token_id)
        prefix_text = self._tk.decode(
            self._ids[self._prefix_offset:self._read_offset],
            skip_special_tokens=self._skip_special)
        new_text = self._tk.decode(
            self._ids[self._prefix_offset:],
            skip_special_tokens=self._skip_special)
        if new_text.endswith(_REPLACEMENT):
            # Incomplete UTF-8 sequence — hold until more tokens arrive.
            return None
        if len(new_text) <= len(prefix_text):
            # Special token skipped or no visible text yet.
            self._read_offset = len(self._ids)
            return None
        delta = new_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta


class SentencePieceTokenizer:
    """SentencePiece-model tokenizer behind the same interface as
    HuggingFaceTokenizer (reference lib/llm/src/tokenizers/sp.rs — the
    second tokenizer kind the model card can declare). The native unigram
    engine (llm/sp_model.py) reads the .model file, so the kind needs no
    `sentencepiece` package."""

    def __init__(self, processor):
        self._sp = processor

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        from .sp_model import NativeSentencePiece
        return cls(NativeSentencePiece.load(path))

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        ids = self._sp.EncodeAsIds(text)
        if add_special_tokens and self._sp.bos_id() >= 0:
            ids = [self._sp.bos_id()] + ids
        return Encoding(ids=list(ids))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        if skip_special_tokens:
            control = {i for i in (self._sp.bos_id(), self._sp.eos_id(),
                                   self._sp.pad_id()) if i >= 0}
            ids = [i for i in ids if i not in control]
        return self._sp.DecodeIds(list(ids))

    def id_to_token(self, token_id: int) -> Optional[str]:
        try:
            return self._sp.IdToPiece(int(token_id))
        except Exception:  # noqa: BLE001 — out-of-range ids
            return None

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._sp.PieceToId(token)
        return tid if tid >= 0 else None

    @property
    def vocab_size(self) -> int:
        return int(self._sp.GetPieceSize())

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


def load_tokenizer(model_dir_or_file: str):
    """Load from a tokenizer.json / .model path or an HF-style model
    directory; HF tokenizer.json is preferred, sentencepiece
    tokenizer.model is the fallback kind (reference model_card tokenizer
    detection, model_card/create.rs)."""
    if os.path.isdir(model_dir_or_file):
        sp_path = os.path.join(model_dir_or_file, "tokenizer.model")
        if (not os.path.exists(os.path.join(model_dir_or_file,
                                            "tokenizer.json"))
                and os.path.exists(sp_path)):
            return SentencePieceTokenizer.from_file(sp_path)
        return HuggingFaceTokenizer.from_pretrained_dir(model_dir_or_file)
    if model_dir_or_file.endswith(".model"):
        return SentencePieceTokenizer.from_file(model_dir_or_file)
    return HuggingFaceTokenizer.from_file(model_dir_or_file)


def read_special_token_ids(model_dir: str, tokenizer: HuggingFaceTokenizer) -> dict:
    """Pull eos/bos ids out of HF config files (reference model_card/create.rs
    extracts the same from config.json / generation_config.json /
    tokenizer_config.json)."""
    out: dict = {"eos_token_ids": [], "bos_token_id": None}

    def _as_list(v) -> List[int]:
        if v is None:
            return []
        return list(v) if isinstance(v, list) else [v]

    for name in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                cfg = json.load(f)
            eos = _as_list(cfg.get("eos_token_id"))
            if eos and not out["eos_token_ids"]:
                out["eos_token_ids"] = eos
            if out["bos_token_id"] is None and cfg.get("bos_token_id") is not None:
                out["bos_token_id"] = cfg["bos_token_id"]
    tk_cfg = os.path.join(model_dir, "tokenizer_config.json")
    if not out["eos_token_ids"] and os.path.exists(tk_cfg):
        with open(tk_cfg) as f:
            cfg = json.load(f)
        tok = cfg.get("eos_token")
        if isinstance(tok, dict):
            tok = tok.get("content")
        if tok is not None:
            tid = tokenizer.token_to_id(tok)
            if tid is not None:
                out["eos_token_ids"] = [tid]
    return out
