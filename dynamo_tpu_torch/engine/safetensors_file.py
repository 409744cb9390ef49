"""The safetensors file format, read and written with the standard library.

Stands in for the ``safetensors`` package, which the JAX package's
``engine/weights.py`` imports and the card's machine does not have. A file
is an 8-byte little-endian header length N, N bytes of JSON (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` ``[begin, end)``
counted from the end of the header, and an optional ``__metadata__`` of
strings), then the tensors' bytes, little-endian and C-ordered.

``SafetensorsFile`` parses a header and reads one tensor at a time with
``readinto`` into a byte buffer the caller may own (``read_into``, the
loader's one pinned staging buffer) or a fresh one (``get_tensor``).
BF16 is read straight into ``torch.bfloat16``. ``write_file`` writes
tensors one at a time, each produced only when its turn comes, so a tree
on the device is never held whole on the host; ``save_file`` writes a
mapping of tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

# safetensors dtype tag -> on-disk bytes per element
_ST_ITEMSIZE = {"F64": 8, "I64": 8, "U64": 8, "F32": 4, "I32": 4,
                "U32": 4, "F16": 2, "BF16": 2, "I16": 2, "U16": 2,
                "I8": 1, "U8": 1, "BOOL": 1, "F8_E4M3": 1, "F8_E5M2": 1}

# the tags the engine loads, as torch dtypes (F8_*, BOOL and the wide
# unsigned ints are read by no model family of the port)
DTYPES = {"F64": torch.float64, "F32": torch.float32,
          "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8}
TAGS = {v: k for k, v in DTYPES.items()}

# the largest header the format allows (the Rust reader's limit)
MAX_HEADER_BYTES = 100 << 20


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """One tensor of a file: its tag, shape and absolute byte range."""

    name: str
    dtype: str
    shape: Tuple[int, ...]
    begin: int
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.begin


def _writable(t: torch.Tensor) -> memoryview:
    """The bytes of a contiguous CPU tensor as a writable memoryview."""
    n = t.numel() * t.element_size()
    if n == 0:
        return memoryview(bytearray())
    return memoryview((ctypes.c_char * n).from_address(t.data_ptr())
                      ).cast("B")


class SafetensorsFile:
    """A parsed header; ``tensors`` in data order, ``metadata`` the
    ``__metadata__`` strings (empty when absent)."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: shorter than a safetensors "
                                 f"header length")
            n = int.from_bytes(head, "little")
            if n > min(size - 8, MAX_HEADER_BYTES):
                raise ValueError(f"{path}: header length {n} does not fit "
                                 f"the file ({size} bytes)")
            header = json.loads(f.read(n))
        base = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        infos = []
        for name, h in header.items():
            tag, shape = h["dtype"], tuple(int(d) for d in h["shape"])
            if tag not in _ST_ITEMSIZE:
                raise ValueError(f"{path}: tensor {name!r} has unknown "
                                 f"dtype {tag!r}")
            b, e = (int(x) for x in h["data_offsets"])
            want = math.prod(shape) * _ST_ITEMSIZE[tag]
            if e - b != want or b < 0 or base + e > size:
                raise ValueError(
                    f"{path}: tensor {name!r} has byte range [{b}, {e}) "
                    f"for shape {list(shape)} x {_ST_ITEMSIZE[tag]} bytes "
                    f"({want}) in {size - base} data bytes")
            infos.append(TensorInfo(name, tag, shape, base + b, base + e))
        infos.sort(key=lambda i: i.begin)
        self.tensors: Dict[str, TensorInfo] = {i.name: i for i in infos}

    def keys(self) -> List[str]:
        """Tensor names, sorted (as ``safetensors.safe_open`` lists them)."""
        return sorted(self.tensors)

    def read_into(self, info: TensorInfo, buf: torch.Tensor) -> torch.Tensor:
        """Read ``info``'s bytes into the front of ``buf`` (contiguous CPU
        uint8, at least ``info.nbytes`` long) and return them viewed as the
        tensor. A dtype the engine does not load raises with the name."""
        dtype = DTYPES.get(info.dtype)
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {info.name!r} has dtype "
                             f"{info.dtype}, which the engine does not load")
        raw = buf[:info.nbytes]
        view = _writable(raw)
        with open(self.path, "rb", buffering=0) as f:
            f.seek(info.begin)
            got = 0
            while got < info.nbytes:
                k = f.readinto(view[got:])
                if not k:
                    raise ValueError(f"{self.path}: tensor {info.name!r} "
                                     f"ends early, at byte {got}")
                got += k
        return raw.view(dtype).reshape(info.shape)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A fresh CPU tensor holding ``name``."""
        info = self.tensors[name]
        return self.read_into(info, torch.empty(info.nbytes,
                                                dtype=torch.uint8))


# one tensor to write: name, dtype, shape, and what produces it (called
# once, when its bytes are due)
Entry = Tuple[str, torch.dtype, Tuple[int, ...], Callable[[], torch.Tensor]]


def write_file(path: str, entries: Iterable[Entry],
               metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``entries`` to ``path`` in their order, producing each tensor
    only when its bytes are due and copying it to the host alone. The
    header is padded with spaces to a multiple of 8 bytes, as the
    ``safetensors`` package pads it. Returns the bytes written."""
    entries = list(entries)
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in
                                  metadata.items()}
    off = 0
    for name, dtype, shape, _ in entries:
        if dtype not in TAGS:
            raise ValueError(f"tensor {name!r}: dtype {dtype} has no "
                             f"safetensors tag the engine loads")
        n = math.prod(shape) * _ST_ITEMSIZE[TAGS[dtype]]
        header[name] = {"dtype": TAGS[dtype], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name, dtype, shape, make in entries:
            t = make()
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(
                    f"tensor {name!r}: produced {t.dtype} "
                    f"{tuple(t.shape)}, declared {dtype} {tuple(shape)}")
            # laid out on its own device, then copied to the host
            t = t.detach().contiguous().cpu()
            f.write(_writable(t.reshape(-1).view(torch.uint8)))
            del t
    return 8 + len(blob) + off


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write a mapping of tensors, each in its own dtype."""
    return write_file(path, [(k, t.dtype, tuple(t.shape),
                              (lambda t=t: t)) for k, t in tensors.items()],
                      metadata)
