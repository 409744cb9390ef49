"""Build and bind the hand-written CUDA kernels (``dynamo_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface under ``build/dynamo_tpu_torch/``
(one ``nvcc -c`` per source, all started together, then one link), and
loaded with ``ctypes``. The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is
never loaded.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on PyTorch's current stream, raises
when the C entry point returns a CUDA error, and counts its launches in
``Kernel.launches``. Nothing here runs on import: the CPU tests import
every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "dynamo_tpu_torch")
SOURCES = ("flash_prefill.cu", "paged_attention.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


class _Library:
    """The compiled shared library, built once per process on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log: List[str] = []   # nvcc's -Xptxas -v lines, per source

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES:
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
        return h.hexdigest()[:16]

    def build(self) -> str:
        """Compile (if needed) and return the library path."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"libdtt_kernels_{self._digest()}.so")
        if os.path.exists(path):
            return path
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            procs = []
            for name in SOURCES:
                obj = os.path.join(tmp, name + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name),
                       "-o", obj]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            objs = []
            failed = []
            for name, obj, p in procs:
                out, _ = p.communicate()
                self.build_log.append(f"== {name}\n{out}")
                if p.returncode != 0:
                    failed.append(f"{name}:\n{out}")
                objs.append(obj)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            tmp_so = os.path.join(tmp, "lib.so")
            link = subprocess.run(
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", tmp_so, *objs], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp_so, path)   # atomic: concurrent builds agree
        return path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.dtt_flash_prefill_bf16.argtypes = [
                    vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, vp]
                lib.dtt_flash_prefill_bf16.restype = ci
                lib.dtt_paged_attention_bf16.argtypes = [
                    vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, vp]
                lib.dtt_paged_attention_bf16.restype = ci
                self._lib = lib
            return self._lib


LIBRARY = _Library()


class Kernel:
    """One C entry point of the library plus its launch count."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, *args) -> None:
        err = getattr(LIBRARY.get(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1


FLASH_PREFILL = Kernel("flash_prefill", "dtt_flash_prefill_bf16")
PAGED_ATTENTION = Kernel("paged_attention", "dtt_paged_attention_bf16")
KERNELS: Dict[str, Kernel] = {k.name: k for k in (FLASH_PREFILL,
                                                  PAGED_ATTENTION)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, start_pos: int,
                       seq_len: int) -> torch.Tensor:
    """q [T, H, Dh], k/v [S, KVH, Dh] bf16 → [T, H, Dh] (csrc/flash_prefill.cu)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, torch.bfloat16, 3)
    T, H, Dh = q.shape
    S, KVH, Dh_k = k.shape
    if v.shape != k.shape or Dh_k != Dh or H % KVH or Dh not in (64, 128):
        raise ValueError(f"flash_prefill: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (Dh 64|128, "
                         f"H % KVH == 0)")
    out = torch.empty_like(q)
    FLASH_PREFILL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), T, H, KVH, Dh, S, int(start_pos),
                         int(seq_len), float(scale), _stream(q))
    return out


def paged_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, block_tables: torch.Tensor,
                         seq_lens: torch.Tensor, *, block_size: int,
                         scale: float) -> torch.Tensor:
    """q [B, H, Dh] bf16; one layer's pool [NTOK, KVH*Dh] bf16; tables [B, M]
    and seq_lens [B] int32 → [B, H, Dh] (csrc/paged_attention.cu)."""
    _check(q, "q", torch.bfloat16, 3)
    _check(k_cache, "k_cache", torch.bfloat16, 2)
    _check(v_cache, "v_cache", torch.bfloat16, 2)
    _check(block_tables, "block_tables", torch.int32, 2)
    _check(seq_lens, "seq_lens", torch.int32, 1)
    B, H, Dh = q.shape
    NTOK, C = k_cache.shape
    KVH = C // Dh
    if (v_cache.shape != k_cache.shape or C % Dh or H % KVH
            or Dh not in (64, 128) or H // KVH not in (1, 2, 4, 8)
            or block_tables.shape[0] != B or seq_lens.shape[0] != B
            or NTOK % block_size):
        raise ValueError(
            f"paged_attention: unsupported shapes q={tuple(q.shape)} "
            f"pool={tuple(k_cache.shape)} tables={tuple(block_tables.shape)} "
            f"seq_lens={tuple(seq_lens.shape)} block_size={block_size}")
    out = torch.empty_like(q)
    M = block_tables.shape[1]
    PAGED_ATTENTION.launch(q.data_ptr(), k_cache.data_ptr(),
                           v_cache.data_ptr(), block_tables.data_ptr(),
                           seq_lens.data_ptr(), out.data_ptr(), B, H, KVH, Dh,
                           M, int(block_size), float(scale), _stream(q))
    return out
