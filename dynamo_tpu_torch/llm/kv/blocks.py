"""Token-block hashing: the identity scheme for KV reuse.

Counterpart of ``dynamo_tpu.llm.kv.blocks`` with the same API and the same
hash values: per-block ``block_hash = xxh3_64(tokens)`` over little-endian
u32 ids and chained ``sequence_hash = xxh3_64([parent, block_hash])``, both
with seed 1337. XXH3-64 is implemented here in pure Python (``xxh3_64``)
because the GPU machine has no ``xxhash`` package; a test holds it against
``xxhash.xxh3_64_intdigest`` for inputs of 0 to 512 bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

HASH_SEED = 1337

# ---------------------------------------------------------------------------
# XXH3-64 (xxHash 0.8 specification), scalar form
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P32_1, _P32_2, _P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_P64_1, _P64_2, _P64_3 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9)
_P64_4, _P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_PMX1, _PMX2 = 0x165667919E3779F9, 0x9FB21C651E98DF25

# the default 192-byte secret (kSecret)
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_STRIPE = 64
_SECRET_CONSUME = 8


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _fold(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl(h, 49) ^ _rotl(h, 24)
    h = (h * _PMX2) & _M64
    h ^= ((h >> 35) + length) & _M64
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, i: int, secret: bytes, s: int, seed: int) -> int:
    return _fold(_r64(data, i) ^ ((_r64(secret, s) + seed) & _M64),
                 _r64(data, i + 8) ^ ((_r64(secret, s + 8) - seed) & _M64))


def _accumulate_512(acc: List[int], data: bytes, i: int, secret: bytes,
                    s: int) -> None:
    for j in range(8):
        val = _r64(data, i + 8 * j)
        key = val ^ _r64(secret, s + 8 * j)
        acc[j ^ 1] = (acc[j ^ 1] + val) & _M64
        acc[j] = (acc[j] + (key & 0xFFFFFFFF) * (key >> 32)) & _M64


def _scramble(acc: List[int], secret: bytes, s: int) -> None:
    for j in range(8):
        a = acc[j]
        a ^= a >> 47
        a ^= _r64(secret, s + 8 * j)
        acc[j] = (a * _P32_1) & _M64


def _hash_long(data: bytes, seed: int) -> int:
    secret = bytearray(len(_SECRET))
    for i in range(len(_SECRET) // 16):   # XXH3_initCustomSecret
        secret[16 * i:16 * i + 8] = ((_r64(_SECRET, 16 * i) + seed)
                                     & _M64).to_bytes(8, "little")
        secret[16 * i + 8:16 * i + 16] = ((_r64(_SECRET, 16 * i + 8) - seed)
                                          & _M64).to_bytes(8, "little")
    secret = bytes(secret)
    n = len(data)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    stripes_per_block = (len(secret) - _STRIPE) // _SECRET_CONSUME
    block_len = _STRIPE * stripes_per_block
    nb_blocks = (n - 1) // block_len
    for blk in range(nb_blocks):
        for st in range(stripes_per_block):
            _accumulate_512(acc, data, blk * block_len + st * _STRIPE,
                            secret, st * _SECRET_CONSUME)
        _scramble(acc, secret, len(secret) - _STRIPE)
    nb_stripes = ((n - 1) - block_len * nb_blocks) // _STRIPE
    for st in range(nb_stripes):
        _accumulate_512(acc, data, nb_blocks * block_len + st * _STRIPE,
                        secret, st * _SECRET_CONSUME)
    _accumulate_512(acc, data, n - _STRIPE, secret,
                    len(secret) - _STRIPE - 7)
    result = (n * _P64_1) & _M64
    for j in range(4):
        result = (result + _fold(acc[2 * j] ^ _r64(secret, 11 + 16 * j),
                                 acc[2 * j + 1]
                                 ^ _r64(secret, 11 + 16 * j + 8))) & _M64
    return _avalanche(result)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3 64-bit hash of ``data`` (equals ``xxhash.xxh3_64_intdigest``)."""
    n = len(data)
    seed &= _M64
    sec = _SECRET
    if n == 0:
        return _xxh64_avalanche(seed ^ _r64(sec, 56) ^ _r64(sec, 64))
    if n <= 3:
        c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
        combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
        bitflip = ((_r32(sec, 0) ^ _r32(sec, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    if n <= 8:
        s = seed ^ (int.from_bytes((seed & 0xFFFFFFFF).to_bytes(4, "little"),
                                   "big") << 32)
        in1, in2 = _r32(data, 0), _r32(data, n - 4)
        bitflip = ((_r64(sec, 8) ^ _r64(sec, 16)) - s) & _M64
        return _rrmxmx(((in2 + (in1 << 32)) & _M64) ^ bitflip, n)
    if n <= 16:
        bf1 = ((_r64(sec, 24) ^ _r64(sec, 32)) + seed) & _M64
        bf2 = ((_r64(sec, 40) ^ _r64(sec, 48)) - seed) & _M64
        lo = _r64(data, 0) ^ bf1
        hi = _r64(data, n - 8) ^ bf2
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _fold(lo, hi)) & _M64)
    if n <= 128:
        acc = (n * _P64_1) & _M64
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, sec, 96, seed)
                    acc += _mix16(data, n - 64, sec, 112, seed)
                acc += _mix16(data, 32, sec, 64, seed)
                acc += _mix16(data, n - 48, sec, 80, seed)
            acc += _mix16(data, 16, sec, 32, seed)
            acc += _mix16(data, n - 32, sec, 48, seed)
        acc += _mix16(data, 0, sec, 0, seed)
        acc += _mix16(data, n - 16, sec, 16, seed)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = (n * _P64_1) & _M64
        for i in range(8):
            acc += _mix16(data, 16 * i, sec, 16 * i, seed)
        acc_end = _mix16(data, n - 16, sec, 136 - 17, seed)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            acc_end += _mix16(data, 16 * i, sec, 16 * (i - 8) + 3, seed)
        return _avalanche((acc + acc_end) & _M64)
    return _hash_long(data, seed)


# ---------------------------------------------------------------------------
# Block hashing
# ---------------------------------------------------------------------------


def hash_tokens(tokens: Sequence[int]) -> int:
    """Local block hash: xxh3_64 over the little-endian u32 token ids."""
    return xxh3_64(struct.pack(f"<{len(tokens)}I", *tokens), HASH_SEED)


def chain_hash(parent_seq_hash: Optional[int], block_hash: int) -> int:
    """sequence_hash = xxh3([parent_seq_hash, block_hash])."""
    if parent_seq_hash is None:
        buf = struct.pack("<Q", block_hash)
    else:
        buf = struct.pack("<QQ", parent_seq_hash, block_hash)
    return xxh3_64(buf, HASH_SEED)


class TokenBlockSequence:
    """Splits a token stream into fixed-size blocks with chained hashes.

    Incremental: ``extend``/``append`` hash each block as it fills, so the
    decode loop can register blocks as they complete.
    """

    def __init__(self, block_size: int,
                 tokens: Optional[Sequence[int]] = None):
        self.block_size = block_size
        self.tokens: List[int] = []
        self.block_hashes: List[int] = []      # local hash per full block
        self.sequence_hashes: List[int] = []   # chained hash per full block
        if tokens:
            self.extend(tokens)

    def extend(self, tokens: Sequence[int]) -> None:
        self.tokens.extend(int(t) for t in tokens)
        self._absorb()

    def append(self, token: int) -> None:
        self.tokens.append(int(token))
        self._absorb()

    def _absorb(self) -> None:
        bs = self.block_size
        while len(self.block_hashes) < len(self.tokens) // bs:
            i = len(self.block_hashes)
            bh = hash_tokens(self.tokens[i * bs:(i + 1) * bs])
            parent = self.sequence_hashes[-1] if self.sequence_hashes else None
            self.block_hashes.append(bh)
            self.sequence_hashes.append(chain_hash(parent, bh))

    @property
    def num_full_blocks(self) -> int:
        return len(self.block_hashes)


def compute_block_hashes(tokens: Sequence[int], block_size: int
                         ) -> List[int]:
    """Chained sequence hashes for every full block of ``tokens``."""
    return TokenBlockSequence(block_size, tokens).sequence_hashes
