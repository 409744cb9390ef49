"""Host C++ library loader: builds a source under ``dynamo_tpu_torch/csrc/host/``
into a shared library under ``build/dynamo_tpu_torch/`` on first use, and
memoizes the loaded library.

Modelled on ``dynamo_tpu.utils.native`` without its sanitizer modes. The
library's name carries a digest of its sources and flags, so an edited
source rebuilds and a stale library is never loaded. The compiler writes a
temporary name in the build directory that is renamed into place, so two
processes that build at once never load a half-written library. A build or
load failure raises: the port has no silent fallback (a machine that
builds the CUDA kernels has a C++ compiler, which ``nvcc`` needs too).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC_DIR = os.path.join(PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "dynamo_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_CACHE: Dict[str, ctypes.CDLL] = {}


def library_path(name: str, sources: Sequence[str],
                 build_dir: Optional[str] = None) -> str:
    """Where ``lib{name}`` of these sources lives once built (under
    ``build_dir``, by default ``BUILD_DIR``)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources:
        with open(os.path.join(HOST_SRC_DIR, src), "rb") as f:
            h.update(src.encode() + f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, sources: Sequence[str],
          build_dir: Optional[str] = None) -> str:
    """Compile ``sources`` with ``c++`` (if not built yet) and return the
    library's path. Raises ``RuntimeError`` when the compiler is missing or
    fails."""
    path = library_path(name, sources, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                               dir=os.path.dirname(path))
    os.close(fd)
    cmd = ["c++", *CXX_FLAGS, "-o", tmp,
           *[os.path.join(HOST_SRC_DIR, s) for s in sources]]
    try:
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"building lib{name}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"building lib{name} failed:\n{res.stdout}")
        os.replace(tmp, path)         # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load(name: str, sources: Sequence[str],
         build_dir: Optional[str] = None) -> ctypes.CDLL:
    """Build (if needed) and dlopen ``lib{name}``; memoized per path."""
    with _LOCK:
        path = library_path(name, sources, build_dir)
        lib = _CACHE.get(path)
        if lib is None:
            lib = ctypes.CDLL(build(name, sources, build_dir))
            _CACHE[path] = lib
        return lib
