"""The decode program: K decode steps and their sampling over the engine's
static ``[max_num_seqs]`` batch, the work of one decode dispatch.

Counterpart of the ``decode`` and ``decode_k`` closures of the JAX
package's ``EngineCore._compile_jits``: step k feeds each slot its planned
prompt token where ``planned_mask[k]`` is set (a lane prefill) and else the
token step k-1 sampled, runs the model family's ``decode_forward``
(``models.family``: llama, or MLA with its MoE top-k), keys each row at
``steps0 + k`` (``sampling.make_slot_keys``) and samples; positions advance
by one a step. K = 1 with no plan is the single-step program.

``decode_k_forward`` is the plain function. On the CPU ``DecodeProgram``
runs it eagerly. On a CUDA device it replays one captured
``torch.cuda.CUDAGraph`` per (K, sampling variant, logits kept): the port's
form of a compiled program, so a dispatch costs the host one copy of its
inputs, one replay and one copy of its outputs instead of the 2100-3000
launches of an eager 8B step. The sampling variants are ``greedy`` (no
noise is drawn), ``temperature`` (Gumbel-argmax) and ``filtered``
(top-k / top-p); the host picks one from the slots' parameters
(``sampling_variant``), where JAX decides on the device with ``lax.cond``.

A graph is captured at its first use, after one eager call of the same
program on the capture stream over zero inputs (every slot on the trash
block 0): that call does the one-time work a capture may not do (the CUDA
entry points' shared-memory attributes, the merge tickets of
``kernels._tickets``, cuBLAS's workspace, the rope table). The graph reads
static input tensors, filled before each replay by one copy from a pinned
staging buffer (two of them, each reused only after its last copy ran) and
writes static outputs, copied at once into a pinned host buffer (two of
them, so a pipelined dispatch's outputs survive the next replay) behind an
event the harvest waits on. A replay runs no Python, so the launches a
graph holds (``kernels.CAPTURED`` at capture) are added to the kernels'
counts at every replay. A capture or a replay that fails raises: nothing
on the card falls back to eager launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import kernels
from .models import family
from .sampling import (greedy_tokens, gumbel_noise_from_keys, make_slot_keys,
                       sample_tokens)

VARIANTS = ("greedy", "temperature", "filtered")


def sampling_variant(temperature: np.ndarray, top_k: np.ndarray,
                     top_p: np.ndarray, live: np.ndarray) -> str:
    """The sampling branch of one dispatch: ``greedy`` when no live row
    samples (the rows that do not live are discarded), else ``filtered``
    when any row has top-k or top-p (JAX's ``lax.cond`` predicate, over
    every row as JAX takes it), else ``temperature``."""
    if not (temperature[live] > 0.0).any():
        return "greedy"
    if ((top_p < 1.0) | (top_k > 0)).any():
        return "filtered"
    return "temperature"


def decode_k_forward(params, kv, tokens: torch.Tensor,
                     positions: torch.Tensor, tables: torch.Tensor,
                     seeds: torch.Tensor, steps0: torch.Tensor,
                     temperature: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor, planned: Optional[torch.Tensor],
                     planned_mask: Optional[torch.Tensor], *, cfg,
                     block_size: int, base_seed: int, K: int, variant: str,
                     with_logits: bool = False) -> tuple:
    """K decode steps over the batch (the JAX ``decode_k`` scan body).

    tokens [B] int64 (the step-0 inputs), positions [B] int32, tables
    [B, M] int32, seeds / steps0 [B] int64, temperature / top_p [B] f32,
    top_k [B] int64; planned / planned_mask [K, B] (int64 / bool) or None.
    Writes each step's KV in place. Returns (toks [K, B] int64, logprobs
    [K, B] f32), and with ``with_logits`` also logits [K, B, V] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown sampling variant {variant!r}")
    toks, pos = tokens, positions
    decode = family(cfg).decode_forward
    out_t, out_l, out_x = [], [], []
    for k in range(K):
        tok_in = (toks if planned is None
                  else torch.where(planned_mask[k], planned[k], toks))
        logits = decode(params, kv, tok_in, pos, tables, cfg, block_size)
        if variant == "greedy":
            toks, lps = greedy_tokens(logits)
        else:
            keys = make_slot_keys(base_seed, seeds, steps0 + k)
            noise = gumbel_noise_from_keys(logits.shape[1], keys)
            toks, lps = sample_tokens(logits, noise, temperature, top_k,
                                      top_p, filtered=variant == "filtered")
        pos = pos + 1
        out_t.append(toks)
        out_l.append(lps)
        if with_logits:
            out_x.append(logits)
    out = (torch.stack(out_t), torch.stack(out_l))
    return out + (torch.stack(out_x),) if with_logits else out


# the program's inputs: name → (dtype, shape given B, M and K)
_FIELDS = (("tokens", torch.int64, lambda B, M, K: (B,)),
           ("chain_mask", torch.bool, lambda B, M, K: (B,)),
           ("positions", torch.int32, lambda B, M, K: (B,)),
           ("tables", torch.int32, lambda B, M, K: (B, M)),
           ("seeds", torch.int64, lambda B, M, K: (B,)),
           ("steps0", torch.int64, lambda B, M, K: (B,)),
           ("temperature", torch.float32, lambda B, M, K: (B,)),
           ("top_k", torch.int64, lambda B, M, K: (B,)),
           ("top_p", torch.float32, lambda B, M, K: (B,)),
           ("planned", torch.int64, lambda B, M, K: (K, B)),
           ("planned_mask", torch.bool, lambda B, M, K: (K, B)))
_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
       torch.float32: np.float32}


def _layout(B: int, M: int, K: int) -> Tuple[Dict[str, tuple], int]:
    """Byte offset, dtype and shape of each input in one arena (16-byte
    aligned fields), and the arena's size."""
    out, off = {}, 0
    for name, dtype, shape in _FIELDS:
        shp = shape(B, M, K)
        n = int(np.prod(shp)) * dtype.itemsize
        out[name] = (off, dtype, shp, n)
        off += -(-n // 16) * 16
    return out, off


def _views(arena: torch.Tensor, layout: dict) -> Dict[str, torch.Tensor]:
    return {name: arena[off:off + n].view(dtype).view(shp)
            for name, (off, dtype, shp, n) in layout.items()}


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    toks: torch.Tensor                  # [K, B] static outputs
    logprobs: torch.Tensor
    logits: Optional[torch.Tensor]      # [K, B, V] when kept
    launches: Dict[str, int]            # kernel launches per replay


class Dispatch:
    """One launched dispatch: its device outputs (``toks`` [K, B]; the
    last row chains a pipelined dispatch) and its host copy, which
    ``fetch`` waits for."""

    def __init__(self, toks, logprobs, logits=None, event=None,
                 host=None) -> None:
        self.toks = toks
        self.logprobs = logprobs
        self.logits = logits
        self._event = event
        self._host = host
        self._fetched: Optional[tuple] = None

    @property
    def chain(self) -> torch.Tensor:
        """The last step's sampled tokens [B], on the device."""
        return self.toks[-1]

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(toks [K, B], logprobs [K, B]) on the host: the one device→host
        wait of a dispatch."""
        if self._fetched is None:
            if self._event is None:          # eager: a plain copy
                self._fetched = (self.toks.cpu().numpy(),
                                 self.logprobs.cpu().numpy())
            else:
                self._event.synchronize()
                K = self.toks.shape[0]
                self._fetched = (self._host[0][:K].numpy().copy(),
                                 self._host[1][:K].numpy().copy())
        return self._fetched


class DecodeProgram:
    """The engine's decode program over ``params`` and the pool ``kv``
    for a ``[B]`` batch of ``[B, M]`` tables and plans of up to
    ``max_k`` steps."""

    def __init__(self, params, kv, cfg, block_size: int, B: int, M: int,
                 max_k: int, base_seed: int, device) -> None:
        self.params, self.kv, self.cfg = params, kv, cfg
        self.block_size, self.B, self.M = block_size, B, M
        self.max_k = max_k
        self.base_seed = base_seed
        self.device = torch.device(device)
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.capture_s = 0.0          # host seconds in warm-ups + captures
        self.replays = 0
        if self.device.type != "cuda":
            return
        self._layout, nbytes = _layout(B, M, max_k)
        dev = self.device
        self._stream = torch.cuda.Stream(dev)
        self._arena = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        self.static = _views(self._arena, self._layout)
        # the warm-up inputs: every slot on the trash block
        self._zeros = _views(torch.zeros(nbytes, dtype=torch.uint8,
                                         device=dev), self._layout)
        self._staging = [torch.zeros(nbytes, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
        self._staging_np = [
            {name: s.numpy()[off:off + n].view(_NP[dtype]).reshape(shp)
             for name, (off, dtype, shp, n) in self._layout.items()}
            for s in self._staging]
        self._staged = [None, None]          # event of each buffer's copy
        self._flip = 0
        self._out = [(torch.zeros((max_k, B), dtype=torch.int64,
                                  pin_memory=True),
                      torch.zeros((max_k, B), dtype=torch.float32,
                                  pin_memory=True)) for _ in range(2)]
        self._out_owner: list = [None, None]
        self._out_flip = 0

    # ------------------------------------------------------------- plain
    def _run(self, K: int, variant: str, t: Dict[str, torch.Tensor],
             with_logits: bool = False) -> tuple:
        return decode_k_forward(
            self.params, self.kv, t["tokens"], t["positions"], t["tables"],
            t["seeds"], t["steps0"], t["temperature"], t["top_k"],
            t["top_p"], t["planned"][:K], t["planned_mask"][:K],
            cfg=self.cfg, block_size=self.block_size,
            base_seed=self.base_seed, K=K, variant=variant,
            with_logits=with_logits)

    def run_eager(self, K: int, variant: str, inputs: Dict[str, np.ndarray],
                  chain: Optional[torch.Tensor] = None,
                  with_logits: bool = False) -> Dispatch:
        """The same dispatch as ``dispatch``, run eagerly on the inputs'
        own tensors (the CPU path; on the card, the plain form a replay is
        held against)."""
        self._check_k(K)
        t = {k: torch.from_numpy(v).to(self.device)
             for k, v in self._host_inputs(inputs).items()}
        if chain is not None:
            t["tokens"] = torch.where(t["chain_mask"], chain, t["tokens"])
        return Dispatch(*self._run(K, variant, t, with_logits))

    def _check_k(self, K: int) -> None:
        if not 1 <= K <= self.max_k:
            raise ValueError(f"K={K} outside 1..{self.max_k}")

    def _host_inputs(self, inputs: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Every input at its full shape (plans of ``max_k`` rows), zeros
        where ``inputs`` has none."""
        out = {}
        for name, dtype, shape in _FIELDS:
            shp = shape(self.B, self.M, self.max_k)
            a = inputs.get(name)
            full = np.zeros(shp, _NP[dtype])
            if a is not None:
                a = np.asarray(a)
                full[tuple(slice(0, d) for d in a.shape)] = a
            out[name] = full
        return out

    # ------------------------------------------------------------- graphs
    def dispatch(self, K: int, variant: str, inputs: Dict[str, np.ndarray],
                 chain: Optional[torch.Tensor] = None,
                 with_logits: bool = False) -> Dispatch:
        """Launch one dispatch of K steps. ``inputs``: host arrays by name
        (``_FIELDS``; a missing one is zeros, ``planned`` / ``planned_mask``
        may have K rows). ``chain``: device tokens [B] that replace
        ``tokens`` where ``chain_mask`` is set (a pipelined dispatch's
        merge, on the stream before the replay)."""
        if self.device.type != "cuda":
            return self.run_eager(K, variant, inputs, chain, with_logits)
        self._check_k(K)
        g = self._graph(K, variant, with_logits)
        self._upload(inputs)
        if chain is not None:
            st = self.static
            st["tokens"].copy_(torch.where(st["chain_mask"], chain,
                                           st["tokens"]))
        g.graph.replay()
        self.replays += 1
        kernels.add_launches(g.launches)
        j = self._out_flip
        self._out_flip ^= 1
        owner = self._out_owner[j]
        if owner is not None:
            owner.fetch()        # its host copy is about to be overwritten
        host = self._out[j]
        host[0][:K].copy_(g.toks, non_blocking=True)
        host[1][:K].copy_(g.logprobs, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        d = Dispatch(g.toks, g.logprobs, g.logits, ev, host)
        self._out_owner[j] = d
        return d

    def _upload(self, inputs: Dict[str, np.ndarray]) -> None:
        """Fill the static inputs: write the next pinned staging buffer
        (after its previous copy has run) and copy it in one piece."""
        i = self._flip
        self._flip ^= 1
        if self._staged[i] is not None:
            self._staged[i].synchronize()
        full = self._host_inputs(inputs)
        for name, view in self._staging_np[i].items():
            view[...] = full[name]
        self._arena.copy_(self._staging[i], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staged[i] = ev

    def _graph(self, K: int, variant: str, with_logits: bool) -> _Graph:
        key = (K, variant, with_logits)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(K, variant, with_logits)
        return g

    def _capture(self, K: int, variant: str, with_logits: bool) -> _Graph:
        t0 = time.monotonic()
        s = self._stream
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            self._run(K, variant, self._zeros, with_logits)   # warm-up
        cur.wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        kernels.CAPTURED.clear()
        with torch.cuda.graph(graph, stream=s,
                              capture_error_mode="thread_local"):
            out = self._run(K, variant, self.static, with_logits)
        launches = dict(kernels.CAPTURED)
        kernels.CAPTURED.clear()
        self.captures += 1
        self.capture_s += time.monotonic() - t0
        return _Graph(graph, out[0], out[1],
                      out[2] if with_logits else None, launches)
