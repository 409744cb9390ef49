"""Build and bind the hand-written CUDA kernels (``dynamo_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface under ``build/dynamo_tpu_torch/``
(one ``nvcc -c`` per source, all started together, then one link), and
loaded with ``ctypes``. The library's file name carries a hash of the
sources, the headers they include and the flags, so an edited source
rebuilds and a stale library is never loaded.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output (``torch.empty``, or ``torch.zeros`` where the kernel writes only
some rows) and any scratch (``torch.empty``; K4's, K6's and K3-MLA's
merge tickets are one zeroed buffer per device and stream that the
kernels leave zeroed), launches on the current stream of the tensor's device with that
device current, raises when the C entry point returns a CUDA error, and counts
its launches in ``Kernel.launches``. A call made while a CUDA graph is being
captured launches nothing and counts nothing; the capturing program
(``engine/programs.py``) adds the launches its graph holds to the counts at
every replay (``add_launches``). Nothing here runs on import: the CPU tests
import every module of the package.
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

from .attention import (KV_SCALE_LANES, LATENT_SPLITS, decode_split_plan,
                        latent_decode_clusters, latent_decode_splits,
                        ragged_row_tiles)
from .quant_matmul import (DECODE_ROWS, GROUP, PREFILL_ROWS, STRIP,
                           int4_split_plan)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "dynamo_tpu_torch")
SOURCES = ("flash_prefill.cu", "paged_attention.cu", "lm_head_int8.cu",
           "grouped_int4_matmul.cu", "ragged_paged_attention.cu",
           "latent_attention.cu")
# the headers the sources include: hashed with them, never compiled alone
HEADERS = ("soft_cap.cuh",)
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
        for name in SOURCES + HEADERS:
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
                    vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                    vp]
                lib.dtt_flash_prefill_bf16.restype = ci
                lib.dtt_flash_prefill_partial_bf16.argtypes = [
                    vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf,
                    vp]
                lib.dtt_flash_prefill_partial_bf16.restype = ci
                for name in ("dtt_paged_attention_bf16",
                             "dtt_paged_attention_int8"):
                    fn = getattr(lib, name)
                    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                   ci, ci, ci, ci, cf, cf, vp]
                    fn.restype = ci
                for name in ("dtt_ragged_paged_attention_bf16",
                             "dtt_ragged_paged_attention_int8"):
                    fn = getattr(lib, name)
                    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                   vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                                   vp]
                    fn.restype = ci
                lib.dtt_lm_head_int8.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                                 vp]
                lib.dtt_lm_head_int8.restype = ci
                lib.dtt_grouped_int4_matmul.argtypes = [vp, vp, vp, vp, vp,
                                                        vp, ci, ci, ci, ci,
                                                        vp]
                lib.dtt_grouped_int4_matmul.restype = ci
                for name in ("dtt_latent_paged_attention_bf16",
                             "dtt_latent_paged_attention_int8"):
                    fn = getattr(lib, name)
                    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                   ci, ci, ci, ci, ci, ci, ci, cf, vp]
                    fn.restype = ci
                for name in ("dtt_latent_ragged_attention_bf16",
                             "dtt_latent_ragged_attention_int8"):
                    fn = getattr(lib, name)
                    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                   ci, ci, ci, ci, ci, ci, ci, ci, cf, vp]
                    fn.restype = ci
                lib.dtt_latent_max_active_clusters.argtypes = [ci, ci]
                lib.dtt_latent_max_active_clusters.restype = ci
                self._lib = lib
            return self._lib


LIBRARY = _Library()


class Kernel:
    """One C entry point of the library plus its launch count."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, t: torch.Tensor, *args) -> None:
        """Call the entry point with ``args`` and the current stream of
        ``t``'s device, under that device: ``<<<>>>`` launches on the
        current device, which need not be the tensor's."""
        fn = getattr(LIBRARY.get(), self.symbol)
        with torch.cuda.device(t.device):
            err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err}")
        if torch.cuda.is_current_stream_capturing():
            CAPTURED[self.name] = CAPTURED.get(self.name, 0) + 1
        else:
            self.launches += 1


FLASH_PREFILL = Kernel("flash_prefill", "dtt_flash_prefill_bf16")
FLASH_PREFILL_PARTIAL = Kernel("flash_prefill_partial",
                               "dtt_flash_prefill_partial_bf16")
PAGED_ATTENTION = Kernel("paged_attention", "dtt_paged_attention_bf16")
PAGED_ATTENTION_INT8 = Kernel("paged_attention_int8",
                              "dtt_paged_attention_int8")
LM_HEAD_INT8 = Kernel("lm_head_int8", "dtt_lm_head_int8")
GROUPED_INT4_MATMUL = Kernel("grouped_int4_matmul", "dtt_grouped_int4_matmul")
RAGGED_PAGED_ATTENTION = Kernel("ragged_paged_attention",
                                "dtt_ragged_paged_attention_bf16")
RAGGED_PAGED_ATTENTION_INT8 = Kernel("ragged_paged_attention_int8",
                                     "dtt_ragged_paged_attention_int8")
# the MLA modes of K3 and K4 (csrc/latent_attention.cu)
LATENT_PAGED_ATTENTION = Kernel("latent_paged_attention",
                                "dtt_latent_paged_attention_bf16")
LATENT_PAGED_ATTENTION_INT8 = Kernel("latent_paged_attention_int8",
                                     "dtt_latent_paged_attention_int8")
LATENT_RAGGED_ATTENTION = Kernel("latent_ragged_attention",
                                 "dtt_latent_ragged_attention_bf16")
LATENT_RAGGED_ATTENTION_INT8 = Kernel("latent_ragged_attention_int8",
                                      "dtt_latent_ragged_attention_int8")
KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    FLASH_PREFILL, FLASH_PREFILL_PARTIAL, PAGED_ATTENTION,
    PAGED_ATTENTION_INT8, LM_HEAD_INT8,
    GROUPED_INT4_MATMUL, RAGGED_PAGED_ATTENTION,
    RAGGED_PAGED_ATTENTION_INT8, LATENT_PAGED_ATTENTION,
    LATENT_PAGED_ATTENTION_INT8, LATENT_RAGGED_ATTENTION,
    LATENT_RAGGED_ATTENTION_INT8)}


# launches recorded into the CUDA graph being captured, by kernel name: the
# capturing program reads and clears it (engine/programs.py)
CAPTURED: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    for name, n in counts.items():
        KERNELS[name].launches += n


# the GQA group sizes K3 and K4 are compiled for, by head dim: every group
# of 1-8 at 64 and 128 (qwen2's 7 and 6, Qwen2.5-14B's 5, Llama-3.2-3B's
# 3), the powers of two at 96 (phi3) and 256 (gemma2)
GROUPS = {64: (1, 2, 3, 4, 5, 6, 7, 8), 96: (1, 2, 4, 8),
          128: (1, 2, 3, 4, 5, 6, 7, 8), 256: (1, 2, 4, 8)}
# the head dims the attention kernels (K1-K4) are compiled for
HEAD_DIMS = tuple(GROUPS)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_softcap(kernel: Kernel, softcap: float) -> float:
    if not softcap >= 0:
        raise ValueError(f"{kernel.name}: softcap {softcap} (0 = off)")
    return float(softcap)


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       scale: float, start_pos: int, seq_len: int,
                       window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q [T, H, Dh], k/v [S, KVH, Dh] bf16 → [T, H, Dh] (csrc/flash_prefill.cu).
    ``window``: this layer's sliding window (0: a global layer);
    ``softcap``: the attention logit soft-cap (0: off)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, torch.bfloat16, 3)
    T, H, Dh = q.shape
    S, KVH, Dh_k = k.shape
    if (v.shape != k.shape or Dh_k != Dh or H % KVH or Dh not in HEAD_DIMS
            or window < 0):
        raise ValueError(f"flash_prefill: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} or window "
                         f"{window} (Dh in {HEAD_DIMS}, H % KVH == 0)")
    softcap = _check_softcap(FLASH_PREFILL, softcap)
    out = torch.empty_like(q)
    FLASH_PREFILL.launch(q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), T, H, KVH, Dh, S, int(start_pos),
                         int(seq_len), int(window), float(scale), softcap)
    return out


def flash_prefill_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               start_pos: int, seq_len: int) -> tuple:
    """K2, one ring hop: q [T, H, Dh], k/v [S, KVH, Dh] bf16, start_pos may
    be negative → (acc [T, H, Dh], m [T, H], l [T, H]), all f32, acc
    unnormalized (the partial entry point of csrc/flash_prefill.cu). The
    kernel writes every row, so the outputs are ``torch.empty``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, torch.bfloat16, 3)
    T, H, Dh = q.shape
    S, KVH, Dh_k = k.shape
    if v.shape != k.shape or Dh_k != Dh or H % KVH or Dh not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_partial: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} (Dh in {HEAD_DIMS}, "
                         f"H % KVH == 0)")
    acc = torch.empty((T, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.empty((T, H), dtype=torch.float32, device=q.device)
    l = torch.empty((T, H), dtype=torch.float32, device=q.device)
    FLASH_PREFILL_PARTIAL.launch(q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                                 T, H, KVH, Dh, S, int(start_pos),
                                 int(seq_len), float(scale))
    return acc, m, l


def _check_paged(kernel: Kernel, pool_dtype: torch.dtype, scale_lanes: int,
                 q, k_cache, v_cache, block_tables, seq_lens,
                 block_size: int) -> tuple:
    """The checks shared by K3 and K4: q [N, H, Dh] bf16, one layer's pool
    [NTOK, KVH*Dh + scale_lanes] of ``pool_dtype``, tables [S, M] and
    seq_lens [S] int32. Returns (H, KVH, Dh)."""
    _check(q, "q", torch.bfloat16, 3)
    _check(k_cache, "k_cache", pool_dtype, 2)
    _check(v_cache, "v_cache", pool_dtype, 2)
    _check(block_tables, "block_tables", torch.int32, 2)
    _check(seq_lens, "seq_lens", torch.int32, 1)
    _, H, Dh = q.shape
    NTOK, lanes = k_cache.shape
    C = lanes - scale_lanes
    KVH = C // Dh
    if (v_cache.shape != k_cache.shape or C % Dh or KVH == 0 or H % KVH
            or H // KVH not in GROUPS.get(Dh, ())
            or seq_lens.shape[0] != block_tables.shape[0]
            or NTOK % block_size):
        raise ValueError(
            f"{kernel.name}: unsupported shapes q={tuple(q.shape)} "
            f"pool={tuple(k_cache.shape)} tables={tuple(block_tables.shape)} "
            f"seq_lens={tuple(seq_lens.shape)} block_size={block_size} "
            f"(H / KVH by Dh in kernels.GROUPS: {GROUPS})")
    return H, KVH, Dh


def _window(kernel: Kernel, win: Optional[torch.Tensor], n: int,
            name: str) -> Optional[torch.Tensor]:
    """A sliding layer's per-sequence window floors as a contiguous int32
    [n] on the card (a device-side cast: no host read, so a CUDA graph may
    capture it), or None on a global layer."""
    if win is None:
        return None
    if not win.is_cuda or win.shape != (n,):
        raise ValueError(f"{kernel.name}: {name} must be a CUDA tensor of "
                         f"shape ({n},) (got {tuple(win.shape)} on "
                         f"{win.device})")
    return win.to(torch.int32).contiguous()


def paged_scratch(q: torch.Tensor, KVH: int, M: int, block_size: int,
                  v_lanes: Optional[int] = None,
                  ragged: bool = False) -> Optional[torch.Tensor]:
    """The f32 workspace of K3 (q [B, H, Dh]) and K4 (q [TT, H, Dh]) over a
    table of M entries, on q's device (``attention.split_scratch_views``
    reads it), or None when the plan has one split. ``v_lanes``: the MLA
    modes, whose kernels merge on the card and write their partials
    (``latent_decode_splits(B)`` of K3-MLA, with ``ragged`` LATENT_SPLITS
    of K4-MLA; rows of v_lanes + 2 floats, whatever the table) only into
    room passed in to them."""
    B, H, Dh = q.shape
    if v_lanes is not None:
        S = LATENT_SPLITS if ragged else latent_decode_splits(B)
    else:
        S = decode_split_plan(M, block_size)[1]
    if S == 1:
        return None
    return torch.empty(B * KVH * S * (H // KVH) * ((v_lanes or Dh) + 2),
                       dtype=torch.float32, device=q.device)


def _split_scratch(kernel: Kernel, q: torch.Tensor, KVH: int, M: int,
                   block_size: int, scratch: Optional[torch.Tensor],
                   v_lanes: Optional[int] = None,
                   ragged: bool = False) -> Optional[torch.Tensor]:
    """The caller's scratch, checked against ``paged_scratch``, or that
    (in the MLA modes, none: the kernels need no workspace)."""
    want = (paged_scratch(q, KVH, M, block_size, v_lanes, ragged)
            if scratch is not None or v_lanes is None else None)
    if scratch is None:
        return want
    if (want is None or scratch.device != q.device
            or scratch.dtype != torch.float32 or not scratch.is_contiguous()
            or scratch.numel() != want.numel()):
        raise ValueError(f"{kernel.name}: scratch must be what "
                         f"paged_scratch allocates")
    return scratch


def _paged(kernel: Kernel, pool_dtype: torch.dtype, scale_lanes: int,
           q, k_cache, v_cache, block_tables, seq_lens, block_size: int,
           scale: float, scratch: Optional[torch.Tensor], softcap: float,
           win_lo: Optional[torch.Tensor]) -> torch.Tensor:
    H, KVH, Dh = _check_paged(kernel, pool_dtype, scale_lanes, q, k_cache,
                              v_cache, block_tables, seq_lens, block_size)
    B = q.shape[0]
    if block_tables.shape[0] != B:
        raise ValueError(f"{kernel.name}: {block_tables.shape[0]} tables for "
                         f"{B} query rows")
    softcap = _check_softcap(kernel, softcap)
    win_lo = _window(kernel, win_lo, B, "win_lo")
    out = torch.empty_like(q)
    M = block_tables.shape[1]
    scratch = _split_scratch(kernel, q, KVH, M, block_size, scratch)
    kernel.launch(q, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  None if win_lo is None else win_lo.data_ptr(),
                  out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  B, H, KVH, Dh, M, int(block_size), float(scale), softcap)
    return out


def paged_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, block_tables: torch.Tensor,
                         seq_lens: torch.Tensor, *, block_size: int,
                         scale: float,
                         scratch: Optional[torch.Tensor] = None,
                         softcap: float = 0.0,
                         win_lo: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q [B, H, Dh] bf16; one layer's pool [NTOK, KVH*Dh] bf16; tables [B, M]
    and seq_lens [B] int32 → [B, H, Dh] (csrc/paged_attention.cu).
    ``scratch``: the split partials' workspace (``paged_scratch``); left
    None the wrapper allocates it. A caller that passes it can read the
    partials of every sequence with more than one live split afterwards
    (of a sliding layer: the splits above the window). ``softcap``: the
    attention logit soft-cap (0: off); ``win_lo``: [B] the keys at or below
    it are masked (None: a global layer)."""
    return _paged(PAGED_ATTENTION, torch.bfloat16, 0, q, k_cache, v_cache,
                  block_tables, seq_lens, block_size, scale, scratch, softcap,
                  win_lo)


def paged_attention_int8_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, *, block_size: int,
                              scale: float,
                              scratch: Optional[torch.Tensor] = None,
                              softcap: float = 0.0,
                              win_lo: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """As ``paged_attention_cuda`` over an int8 pool [NTOK, KVH*Dh + 128]
    with in-row scales (attention.quantize_kv_rows; the int8 entry point of
    csrc/paged_attention.cu)."""
    return _paged(PAGED_ATTENTION_INT8, torch.int8, KV_SCALE_LANES, q,
                  k_cache, v_cache, block_tables, seq_lens, block_size, scale,
                  scratch, softcap, win_lo)


# The merge tickets of K4 (one int32 per sequence, KV head and row tile),
# K6 (one per row tile and column strip) and K3-MLA (one per decode row),
# per (device, stream): zero
# when allocated and left zero by every launch (the last CTA of an item
# resets its ticket), so no call pays a memset. Launches on one stream run
# in order, so they never share a ticket while it counts. A captured graph
# holds the address of the buffer it was captured with: a buffer that grows
# keeps the old one alive (_RETIRED_TICKETS), and none may grow during a
# capture (the program's warm-up call on the capture stream sizes it).
_TICKETS: Dict[tuple, torch.Tensor] = {}
_RETIRED_TICKETS: List[torch.Tensor] = []


def _tickets(q: torch.Tensor, n: int) -> torch.Tensor:
    key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"merge tickets for {n} items would be allocated during a "
                f"CUDA graph capture: run the captured call once on the "
                f"capture stream first")
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())),
                        dtype=torch.int32, device=q.device)
        _TICKETS[key] = t
    return t


def _ragged(kernel: Kernel, pool_dtype: torch.dtype, scale_lanes: int,
            q, k_cache, v_cache, block_tables, seq_starts, seq_counts,
            seq_lens, block_size: int, scale: float, max_rows: int,
            scratch: Optional[torch.Tensor], softcap: float,
            win_base: Optional[torch.Tensor]) -> torch.Tensor:
    H, KVH, Dh = _check_paged(kernel, pool_dtype, scale_lanes, q, k_cache,
                              v_cache, block_tables, seq_lens, block_size)
    _check(seq_starts, "seq_starts", torch.int32, 1)
    _check(seq_counts, "seq_counts", torch.int32, 1)
    TT = q.shape[0]
    S, M = block_tables.shape
    if seq_starts.shape[0] != S or seq_counts.shape[0] != S:
        raise ValueError(f"{kernel.name}: starts {tuple(seq_starts.shape)} "
                         f"and counts {tuple(seq_counts.shape)} for {S} "
                         f"sequences")
    max_rows = min(int(max_rows), TT)
    softcap = _check_softcap(kernel, softcap)
    win_base = _window(kernel, win_base, S, "win_base")
    scratch = _split_scratch(kernel, q, KVH, M, block_size, scratch)
    tickets = None
    if scratch is not None:
        tickets = _tickets(
            q, S * KVH * ragged_row_tiles(max_rows, H // KVH))
    # only owned rows are written: the rest read as zeros
    out = torch.zeros_like(q)
    kernel.launch(q, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  block_tables.data_ptr(), seq_starts.data_ptr(),
                  seq_counts.data_ptr(), seq_lens.data_ptr(),
                  None if win_base is None else win_base.data_ptr(),
                  out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  TT, S, H, KVH, Dh, M, max_rows, int(block_size),
                  float(scale), softcap)
    return out


def ragged_paged_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                block_tables: torch.Tensor,
                                seq_starts: torch.Tensor,
                                seq_counts: torch.Tensor,
                                seq_lens: torch.Tensor, *, block_size: int,
                                scale: float, max_rows: int,
                                scratch: Optional[torch.Tensor] = None,
                                softcap: float = 0.0,
                                win_base: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """q [TT, H, Dh] bf16 flat rows; one layer's pool [NTOK, KVH*Dh] bf16;
    tables [S, M], starts/counts/seq_lens [S] int32 → [TT, H, Dh], rows no
    sequence owns zero (csrc/ragged_paged_attention.cu). ``scratch``: the
    split partials' workspace (``paged_scratch``); left None the wrapper
    allocates it. A caller that passes it can read the partials of every
    row tile with more than one live split afterwards (of a sliding layer:
    the splits above the tile's first row's window). ``softcap``: the
    attention logit soft-cap (0: off); ``win_base``: [S] sequence s's row r
    masks the keys at or below win_base[s] + r (None: a global layer)."""
    return _ragged(RAGGED_PAGED_ATTENTION, torch.bfloat16, 0, q, k_cache,
                   v_cache, block_tables, seq_starts, seq_counts, seq_lens,
                   block_size, scale, max_rows, scratch, softcap, win_base)


def ragged_paged_attention_int8_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                                     v_cache: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     seq_starts: torch.Tensor,
                                     seq_counts: torch.Tensor,
                                     seq_lens: torch.Tensor, *,
                                     block_size: int, scale: float,
                                     max_rows: int,
                                     scratch: Optional[torch.Tensor] = None,
                                     softcap: float = 0.0,
                                     win_base: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """As ``ragged_paged_attention_cuda`` over an int8 pool [NTOK, KVH*Dh +
    128] with in-row scales (the int8 entry point of
    csrc/ragged_paged_attention.cu)."""
    return _ragged(RAGGED_PAGED_ATTENTION_INT8, torch.int8, KV_SCALE_LANES, q,
                   k_cache, v_cache, block_tables, seq_starts, seq_counts,
                   seq_lens, block_size, scale, max_rows, scratch, softcap,
                   win_base)


def _latent(kernel: Kernel, q, pool, block_tables, lens, block_size: int,
            v_lanes: int, quant_sections: Optional[tuple],
            scratch: Optional[torch.Tensor], ragged: bool) -> tuple:
    """The checks shared by K3-MLA and K4-MLA: q [N, 16, 640] bf16, one
    layer's latent pool [NTOK, 640] bf16 or, with ``quant_sections`` (512,
    64), [NTOK, 768] int8; tables [S, M] and lens [S] int32; v_lanes 512.
    Returns (the checked scratch, M)."""
    int8 = quant_sections is not None
    _check(q, "q", torch.bfloat16, 3)
    _check(pool, "pool", torch.int8 if int8 else torch.bfloat16, 2)
    _check(block_tables, "block_tables", torch.int32, 2)
    _check(lens, "seq_lens", torch.int32, 1)
    N, H, Dq = q.shape
    NTOK, lanes = pool.shape
    M = block_tables.shape[1]
    if ((H, Dq, v_lanes) != LATENT_SHAPE or lanes != (LATENT_INT8_LANES
                                                      if int8 else Dq)
            or (int8 and tuple(quant_sections) != LATENT_SECTIONS)
            or lens.shape[0] != block_tables.shape[0] or NTOK % block_size):
        raise ValueError(
            f"{kernel.name}: unsupported shapes q={tuple(q.shape)} "
            f"pool={tuple(pool.shape)} tables={tuple(block_tables.shape)} "
            f"v_lanes={v_lanes} sections={quant_sections} (compiled for "
            f"(heads, query lanes, v_lanes) {LATENT_SHAPE}, sections "
            f"{LATENT_SECTIONS})")
    scratch = _split_scratch(kernel, q, 1, M, block_size, scratch, v_lanes,
                             ragged)
    return scratch, M


# (query heads, query lanes, v_lanes) and int8 sections the latent kernels
# are compiled for: DeepSeek-V2's 16 heads over [c_kv 512 | k_pe 64 | pad]
LATENT_SHAPE = (16, 640, 512)
LATENT_SECTIONS = (512, 64)
# an int8 latent row (attention.check_latent_modes): the sections' values
# and KV_SCALE_LANES scale lanes, padded to a multiple of 128
LATENT_INT8_LANES = -(-(sum(LATENT_SECTIONS) + KV_SCALE_LANES) // 128) * 128


def latent_paged_attention_cuda(q: torch.Tensor, pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                seq_lens: torch.Tensor, *, block_size: int,
                                scale: float, v_lanes: int,
                                quant_sections: Optional[tuple] = None,
                                scratch: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """K3-MLA: q [B, 16, 640] bf16 over one layer's latent pool (bf16 rows
    of 640 lanes, or sectioned int8 rows of 768 with ``quant_sections``
    (512, 64)), tables [B, M], seq_lens [B] int32 → [B, 16, v_lanes]
    (csrc/latent_attention.cu: ``attention.latent_decode_clusters(B)``
    clusters a row of LATENT_DECODE_CLUSTER CTAs, two splits each, merged
    in each cluster's shared memory and then across the clusters).
    ``scratch``: None, or room for the splits' partials
    (``paged_scratch(q, 1, M, block_size, v_lanes)``), which the kernel
    then also writes there for the caller to read."""
    kernel = (LATENT_PAGED_ATTENTION_INT8 if quant_sections is not None
              else LATENT_PAGED_ATTENTION)
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"{kernel.name}: {block_tables.shape[0]} tables "
                         f"for {q.shape[0]} query rows")
    scratch, M = _latent(kernel, q, pool, block_tables, seq_lens, block_size,
                         v_lanes, quant_sections, scratch, False)
    B, H, Dq = q.shape
    out = torch.empty((B, H, v_lanes), dtype=q.dtype, device=q.device)
    # a row's clusters past the first merge through `cross`, the last to
    # finish by a ticket (the zeroed buffer K4 and K6 use)
    P = latent_decode_clusters(B)
    cross = tickets = None
    if P > 1:
        cross = torch.empty(B * P * H * (v_lanes + 2), dtype=torch.float32,
                            device=q.device)
        tickets = _tickets(q, B)
    kernel.launch(q, q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  None if cross is None else cross.data_ptr(),
                  None if tickets is None else tickets.data_ptr(), B, P, H,
                  Dq, pool.shape[1], M, int(block_size), int(v_lanes),
                  0 if quant_sections is None else int(quant_sections[1]),
                  float(scale))
    return out


def latent_ragged_attention_cuda(q: torch.Tensor, pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 seq_starts: torch.Tensor,
                                 seq_counts: torch.Tensor,
                                 seq_lens: torch.Tensor, *, block_size: int,
                                 scale: float, max_rows: int, v_lanes: int,
                                 quant_sections: Optional[tuple] = None,
                                 scratch: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """K4-MLA: q [TT, 16, 640] bf16 flat rows over one layer's latent pool
    (as ``latent_paged_attention_cuda``), tables [S, M], starts / counts /
    seq_lens [S] int32 → [TT, 16, v_lanes], rows no sequence owns zero
    (csrc/latent_attention.cu: a cluster of LATENT_SPLITS CTAs a tile of
    LATENT_TILE_ROWS rows of one sequence). ``scratch``: as
    ``latent_paged_attention_cuda``, over TT rows
    (``paged_scratch(q, 1, M, block_size, v_lanes, ragged=True)``)."""
    kernel = (LATENT_RAGGED_ATTENTION_INT8 if quant_sections is not None
              else LATENT_RAGGED_ATTENTION)
    _check(seq_starts, "seq_starts", torch.int32, 1)
    _check(seq_counts, "seq_counts", torch.int32, 1)
    S = block_tables.shape[0]
    if seq_starts.shape[0] != S or seq_counts.shape[0] != S:
        raise ValueError(f"{kernel.name}: starts {tuple(seq_starts.shape)} "
                         f"and counts {tuple(seq_counts.shape)} for {S} "
                         f"sequences")
    scratch, M = _latent(kernel, q, pool, block_tables, seq_lens, block_size,
                         v_lanes, quant_sections, scratch, True)
    TT, H, Dq = q.shape
    # only owned rows are written: the rest read as zeros
    out = torch.zeros((TT, H, v_lanes), dtype=q.dtype, device=q.device)
    kernel.launch(q, q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
                  seq_starts.data_ptr(), seq_counts.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), TT, S,
                  min(int(max_rows), TT), H, Dq, pool.shape[1], M,
                  int(block_size), int(v_lanes),
                  0 if quant_sections is None else int(quant_sections[1]),
                  float(scale))
    return out


def lm_head_int8_cuda(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x [B, D] bf16 @ q [D, V] int8 * scale [V] f32 → [B, V] f32
    (csrc/lm_head_int8.cu)."""
    _check(x, "x", torch.bfloat16, 2)
    _check(q, "q", torch.int8, 2)
    _check(scale, "scale", torch.float32, 1)
    B, D = x.shape
    Dq, V = q.shape
    if Dq != D or scale.shape[0] != V:
        raise ValueError(f"lm_head_int8: unsupported shapes x={tuple(x.shape)} "
                         f"q={tuple(q.shape)} scale={tuple(scale.shape)}")
    out = torch.empty((B, V), dtype=torch.float32, device=x.device)
    LM_HEAD_INT8.launch(x, x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), B, D, V)
    return out


def grouped_int4_scratch(x: torch.Tensor,
                         F: int) -> Optional[torch.Tensor]:
    """K6's f32 split partials [splits, N, F] for x [N, D] @ W [D, F] on
    x's device (``quant_matmul.int4_split_plan``), or None when the plan
    has one split."""
    N, D = x.shape
    splits, _ = int4_split_plan(N, D, F)
    if splits == 1:
        return None
    return torch.empty((splits, N, F), dtype=torch.float32, device=x.device)


def grouped_int4_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                             scale: torch.Tensor,
                             scratch: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """x [N, D] bf16 @ packed int4 [D/2, F] int8 with scale [D/128, F] f32
    → [N, F] bf16 (csrc/grouped_int4_matmul.cu); D % 256 == 0 and
    F % 128 == 0 (quant_matmul.grouped_kernel_eligible). ``scratch``: the
    split partials (``grouped_int4_scratch``); left None the wrapper
    allocates it. A caller that passes it can read every split's partial
    afterwards."""
    _check(x, "x", torch.bfloat16, 2)
    _check(packed, "packed", torch.int8, 2)
    _check(scale, "scale", torch.float32, 2)
    N, D = x.shape
    half, F = packed.shape
    if (2 * half != D or D % (2 * GROUP) or F % STRIP
            or tuple(scale.shape) != (D // GROUP, F)):
        raise ValueError(
            f"grouped_int4_matmul: unsupported shapes x={tuple(x.shape)} "
            f"packed={tuple(packed.shape)} scale={tuple(scale.shape)}")
    splits, _ = int4_split_plan(N, D, F)
    if scratch is None:
        scratch = grouped_int4_scratch(x, F)
    elif (splits == 1 or scratch.device != x.device
          or scratch.dtype != torch.float32 or not scratch.is_contiguous()
          or tuple(scratch.shape) != (splits, N, F)):
        raise ValueError("grouped_int4_matmul: scratch must be what "
                         "grouped_int4_scratch allocates")
    tiles = 1 if N <= DECODE_ROWS else -(-N // PREFILL_ROWS)
    tickets = None if scratch is None else _tickets(x, F // STRIP * tiles)
    out = torch.empty((N, F), dtype=torch.bfloat16, device=x.device)
    GROUPED_INT4_MATMUL.launch(
        x, x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(), N, D, F, splits)
    return out
