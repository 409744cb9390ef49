"""Native SentencePiece inference engine (no `sentencepiece` dependency).

The reference ships a real SentencePiece tokenizer kind
(lib/llm/src/tokenizers/sp.rs:1-109, via the sentencepiece crate); this
package depends on no `sentencepiece` package (the GPU machine has none).
This module is a copy of the JAX package's clean-room implementation of
the INFERENCE side of a unigram SentencePiece model:

- a minimal protobuf wire-format reader/writer for the subset of
  `sentencepiece_model.proto` inference needs (ModelProto.pieces with
  piece/score/type; TrainerSpec unk/bos/eos/pad ids + byte_fallback;
  NormalizerSpec.add_dummy_prefix) — field numbers match the public
  .proto, so real sentencepiece-produced models load here and models
  written here load in real sentencepiece;
- Viterbi (max-score) unigram segmentation with byte-fallback for
  out-of-vocab characters;
- decode with byte-piece reassembly (incomplete UTF-8 surfaces as the
  replacement character, which is exactly what the incremental
  DecodeStream's hold-until-complete logic keys on).

Training is out of scope (the serving framework only loads models).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["NativeSentencePiece", "write_model_proto"]

# sentencepiece_model.proto piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "▁"          # ▁ — SP's escaped whitespace


# --------------------------------------------------------------- proto wire

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _signed(v: int) -> int:
    """int32/int64 fields ride varints as two's complement 64-bit."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message's bytes."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _emit_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_field(field: int, wt: int, payload: bytes) -> bytes:
    return _emit_varint((field << 3) | wt) + payload


def write_model_proto(pieces: List[Tuple[str, float, int]], *,
                      unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                      pad_id: int = -1, byte_fallback: bool = True,
                      add_dummy_prefix: bool = True) -> bytes:
    """Serialize a loadable .model (ModelProto). Field numbers follow the
    public sentencepiece_model.proto so real sentencepiece reads the
    output; used by the committed fixture generator and the roundtrip
    tests."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = (_emit_field(1, 2, _emit_varint(len(piece.encode()))
                            + piece.encode())
                + _emit_field(2, 5, struct.pack("<f", score))
                + _emit_field(3, 0, _emit_varint(ptype)))
        out += _emit_field(1, 2, _emit_varint(len(body)) + body)
    trainer = (_emit_field(35, 0, _emit_varint(int(byte_fallback)))
               + _emit_field(40, 0, _emit_varint(unk_id))
               + _emit_field(41, 0, _emit_varint(bos_id))
               + _emit_field(42, 0, _emit_varint(eos_id))
               + _emit_field(43, 0, _emit_varint(pad_id)))
    out += _emit_field(2, 2, _emit_varint(len(trainer)) + trainer)
    norm = _emit_field(3, 0, _emit_varint(int(add_dummy_prefix)))
    out += _emit_field(3, 2, _emit_varint(len(norm)) + norm)
    return bytes(out)


# ----------------------------------------------------------------- engine

class NativeSentencePiece:
    """Drop-in for the `sentencepiece.SentencePieceProcessor` surface the
    framework uses (EncodeAsIds/DecodeIds/IdToPiece/PieceToId/
    GetPieceSize/bos_id/eos_id/pad_id)."""

    def __init__(self, pieces: List[Tuple[str, float, int]], *,
                 unk_id: int, bos_id: int, eos_id: int, pad_id: int,
                 byte_fallback: bool, add_dummy_prefix: bool):
        self._pieces = pieces
        self._unk, self._bos, self._eos, self._pad = (unk_id, bos_id,
                                                      eos_id, pad_id)
        self._byte_fallback = byte_fallback
        self._dummy_prefix = add_dummy_prefix
        self._by_piece: Dict[str, int] = {
            p: i for i, (p, _, t) in enumerate(pieces) if t != UNUSED}
        self._byte_ids: Dict[int, int] = {}
        for i, (p, _, t) in enumerate(pieces):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        self._max_piece = max((len(p) for p, _, t in pieces
                               if t in (NORMAL, USER_DEFINED)), default=1)
        scores = [s for _, s, t in pieces if t in (NORMAL, USER_DEFINED)]
        # real SP scores unknowns below every vocab piece
        self._unk_score = (min(scores) if scores else 0.0) - 10.0

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path: str) -> "NativeSentencePiece":
        with open(path, "rb") as f:
            buf = f.read()
        pieces: List[Tuple[str, float, int]] = []
        unk_id, bos_id, eos_id, pad_id = 0, 1, 2, -1
        byte_fallback = False
        add_dummy_prefix = True
        for field, wt, v in _fields(buf):
            if field == 1 and wt == 2:                 # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, wt2, v2 in _fields(v):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wt == 2:               # TrainerSpec
                for f2, _wt2, v2 in _fields(v):
                    if f2 == 35:
                        byte_fallback = bool(v2)
                    elif f2 == 40:
                        unk_id = _signed(v2)
                    elif f2 == 41:
                        bos_id = _signed(v2)
                    elif f2 == 42:
                        eos_id = _signed(v2)
                    elif f2 == 43:
                        pad_id = _signed(v2)
            elif field == 3 and wt == 2:               # NormalizerSpec
                for f2, _wt2, v2 in _fields(v):
                    if f2 == 3:
                        add_dummy_prefix = bool(v2)
        if not pieces:
            raise ValueError(f"no pieces in sentencepiece model {path!r}")
        return cls(pieces, unk_id=unk_id, bos_id=bos_id, eos_id=eos_id,
                   pad_id=pad_id, byte_fallback=byte_fallback,
                   add_dummy_prefix=add_dummy_prefix)

    # ------------------------------------------------------------ encoding
    def _normalize(self, text: str) -> str:
        if self._dummy_prefix:
            text = " " + text
        return text.replace(" ", _SPACE)

    def EncodeAsIds(self, text: str) -> List[int]:  # noqa: N802 — spm API
        s = self._normalize(text)
        n = len(s)
        # Viterbi over character positions: best[i] = (score, back, ids)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, List[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            matched = False
            for ln in range(1, min(self._max_piece, n - i) + 1):
                pid = self._by_piece.get(s[i:i + ln])
                if pid is None:
                    continue
                _, score, ptype = self._pieces[pid]
                if ptype not in (NORMAL, USER_DEFINED):
                    continue
                matched = True
                cand = best[i] + score
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = (i, [pid])
            if not matched or best[i + 1] == NEG:
                # out-of-vocab char: byte fallback, else <unk>
                ch = s[i]
                if self._byte_fallback and self._byte_ids:
                    ids = [self._byte_ids[b] for b in ch.encode("utf-8")]
                    score = sum(self._pieces[j][1] for j in ids)
                else:
                    ids = [self._unk]
                    score = self._unk_score
                cand = best[i] + score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, ids)
        ids: List[int] = []
        i = n
        while i > 0:
            prev, seg = back[i]
            ids[:0] = seg
            i = prev
        return ids

    # ------------------------------------------------------------ decoding
    def DecodeIds(self, ids: Sequence[int]) -> str:  # noqa: N802
        out = bytearray()
        for tid in ids:
            if not 0 <= tid < len(self._pieces):
                continue
            piece, _, ptype = self._pieces[tid]
            if ptype in (CONTROL, UNUSED):
                continue
            if ptype == BYTE:
                out.append(int(piece[3:5], 16))
            elif ptype == UNKNOWN:
                out += " ⁇ ".encode()     # SP's default unk surface
            else:
                out += piece.encode("utf-8")
        text = out.decode("utf-8", errors="replace").replace(_SPACE, " ")
        if self._dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def IdToPiece(self, token_id: int) -> str:  # noqa: N802
        if not 0 <= token_id < len(self._pieces):
            raise IndexError(token_id)
        return self._pieces[token_id][0]

    def PieceToId(self, piece: str) -> int:  # noqa: N802
        return self._by_piece.get(piece, self._unk)

    def GetPieceSize(self) -> int:  # noqa: N802
        return len(self._pieces)

    def bos_id(self) -> int:
        return self._bos

    def eos_id(self) -> int:
        return self._eos

    def pad_id(self) -> int:
        return self._pad
