"""The engine's programs: the work of one decode dispatch and of one ragged
dispatch, each a CUDA graph on the card.

``DecodeProgram`` is the counterpart of the ``decode`` and ``decode_k``
closures of the JAX package's ``EngineCore._compile_jits``: K decode steps
and their sampling over the engine's static ``[max_num_seqs]`` batch. Step
k feeds each slot its planned prompt token where ``planned_mask[k]`` is set
(a lane prefill) and else the token step k-1 sampled, runs the model
family's ``decode_forward`` (``models.family``: llama, or MLA with its MoE
top-k), keys each row at ``steps0 + k`` (``sampling.make_slot_keys``) and
samples; positions advance by one a step. K = 1 with no plan is the
single-step program.

``RaggedProgram`` is the counterpart of JAX's slot-sampled ``ragged``
closure: the family's ``ragged_forward`` over a packed batch
(``engine/ragged.py``), then one sample per slot of ``[B + 1]`` (the last
is the trash sequence), keyed at the slot's step. It has two row buckets:
``max_num_seqs`` rows, which hold every pure-decode dispatch (rows are
packed from row 0, so such a batch is the prefix of its arrays), and
``ragged_max_tokens`` rows, JAX's one shape. Each row's math is the same
in either bucket; the small one keeps a decode dispatch at decode widths
(K6's decode tiling, V2-Lite's experts and an int8 latent pool's gather
over 8 rows, not 136). Dead rows point at the trash sequence: token 0,
position 0, the all-zero table row, so their KV lands in block 0.

With speculative decoding (``EngineConfig.spec_k`` > 0) the ragged program
is row-sampled instead (JAX's ``sample_all_rows`` variant): logits and a
sample for every token row, row r of a span keyed at its slot's step + r,
so a speculative span verifies in the same dispatch as prefill chunks and
decode rows; at a span's last row the key, and so the token, is the
slot-sampled program's. ``VerifyProgram`` is the counterpart of JAX's
``_verify_jit``: ``[B, k + 1]`` query rows flattened through the family's
``decode_forward``, row (b, t) at position ``pos_b + t`` over slot b's
table and keyed at ``steps0_b + t``, the key plain decode would use there
(lockstep acceptance, ``engine/spec/``).

``decode_k_forward``, ``ragged_step_forward`` and ``verify_forward`` are
the plain functions. On the CPU each program runs its function eagerly (the
ragged one at the bucket's rows, dead rows included). On a CUDA device it
replays one captured ``torch.cuda.CUDAGraph`` per key (decode: K, sampling
variant, logits kept; ragged: bucket, variant, logits kept; verify:
variant, logits kept): the port's form of a compiled program, so a
dispatch costs the host one copy of its inputs, one replay and one copy of
its outputs instead of thousands of launches. The
sampling variants are ``greedy`` (no noise is drawn), ``temperature``
(Gumbel-argmax) and ``filtered`` (top-k / top-p); the host picks one from
the slots' parameters (``sampling_variant``), where JAX decides on the
device with ``lax.cond``.

The machinery is shared (``_GraphedProgram``). A graph is captured at its
first use, after one eager call of the same program on the capture stream
over zero inputs (every row on the trash block 0): that call does the
one-time work a capture may not do (the CUDA entry points' shared-memory
attributes, the merge tickets of ``kernels._tickets``, cuBLAS's workspace,
the rope table). A program's graphs share one memory pool: they replay one
at a time, in order, on one stream, and each keeps its static outputs. The
graph reads static input tensors, filled before each replay by one copy
from a pinned staging buffer (two of them, each reused only after its last
copy ran) and writes static outputs, copied at once into a pinned host
buffer (two of them, so a pipelined dispatch's outputs survive the next
replay) behind an event the harvest waits on. A pipelined dispatch's
chained tokens merge into the static inputs on the stream before the
replay. A replay runs no Python, so the launches a graph holds
(``kernels.CAPTURED`` at capture) are added to the kernels' counts at
every replay. A capture or a replay that fails raises: nothing on the card
falls back to eager launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

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


def _sample(logits: torch.Tensor, variant: str, base_seed: int,
            seeds: torch.Tensor, steps: torch.Tensor,
            temperature: torch.Tensor, top_k: torch.Tensor,
            top_p: torch.Tensor) -> tuple:
    """(tokens, logprobs) of ``logits`` [N, V], each row keyed on the
    device at (base_seed, seeds[i], steps[i])."""
    if variant == "greedy":
        return greedy_tokens(logits)
    keys = make_slot_keys(base_seed, seeds, steps)
    noise = gumbel_noise_from_keys(logits.shape[1], keys)
    return sample_tokens(logits, noise, temperature, top_k, top_p,
                         filtered=variant == "filtered")


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
        toks, lps = _sample(logits, variant, base_seed, seeds, steps0 + k,
                            temperature, top_k, top_p)
        pos = pos + 1
        out_t.append(toks)
        out_l.append(lps)
        if with_logits:
            out_x.append(logits)
    out = (torch.stack(out_t), torch.stack(out_l))
    return out + (torch.stack(out_x),) if with_logits else out


def ragged_step_forward(params, kv, tokens: torch.Tensor,
                        positions: torch.Tensor, tables: torch.Tensor,
                        row_slot: torch.Tensor, seq_starts: torch.Tensor,
                        seq_counts: torch.Tensor, sample_rows: torch.Tensor,
                        seeds: torch.Tensor, steps: torch.Tensor,
                        temperature: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor, *, cfg, block_size: int,
                        max_rows: int, base_seed: int, variant: str,
                        with_logits: bool = False,
                        row_sampled: bool = False) -> tuple:
    """One ragged dispatch (JAX's slot-sampled ``ragged`` program): the
    family's ``ragged_forward`` over tokens / positions / row_slot [TT]
    (int64, int32, int32), tables [S, M] and starts / counts / sample_rows
    [S] int32, then one sample per sequence keyed at (base_seed, seeds[s],
    steps[s]) with its temperature / top_k / top_p [S]. Writes every row's
    KV in place. Returns (toks [S] int64, logprobs [S] f32), and with
    ``with_logits`` also logits [S, V] f32.

    ``row_sampled`` (JAX's spec-enabled variant): steps are [TT] row
    steps, the other sampling inputs stay [S] and each row takes its
    sequence's through ``row_slot``; every row is sampled, so toks,
    logprobs and logits have TT rows."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown sampling variant {variant!r}")
    logits = family(cfg).ragged_forward(
        params, kv, tokens, positions, tables, row_slot, seq_starts,
        seq_counts, sample_rows, cfg, block_size, max_rows,
        sample_all_rows=row_sampled)
    if row_sampled:
        rs = row_slot.long()
        seeds, temperature, top_k, top_p = (
            t[rs] for t in (seeds, temperature, top_k, top_p))
    out = _sample(logits, variant, base_seed, seeds, steps, temperature,
                  top_k, top_p)
    return out + (logits,) if with_logits else out


def verify_forward(params, kv, tokens: torch.Tensor,
                   positions: torch.Tensor, tables: torch.Tensor,
                   seeds: torch.Tensor, steps0: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, *, cfg, block_size: int,
                   base_seed: int, variant: str,
                   with_logits: bool = False) -> tuple:
    """One speculative verify dispatch (JAX's ``_verify_jit``): tokens [B,
    Tv] int64 (each slot's last token and its drafts), positions [B] int32,
    tables [B, M] int32, seeds / steps0 [B] int64, temperature / top_p [B]
    f32, top_k [B] int64. The B·Tv rows run through the family's
    ``decode_forward`` as one batch: row (b, t) writes its token's KV at
    position ``positions[b] + t`` through slot b's table and attends every
    position up to it, so one slot's rows score its draft chain causally.
    Row (b, t) samples at key (base_seed, seeds[b], steps0[b] + t). Returns
    (toks [B, Tv] int64, logprobs [B, Tv] f32), and with ``with_logits``
    also logits [B, Tv, V] f32."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown sampling variant {variant!r}")
    B, Tv = tokens.shape
    t_off = torch.arange(Tv, device=tokens.device)

    def rows(t: torch.Tensor) -> torch.Tensor:
        # each slot's value on its Tv rows (expand: no host read, so a
        # CUDA graph may capture it)
        return t[:, None].expand(B, Tv, *t.shape[1:]).reshape(
            B * Tv, *t.shape[1:])

    flat_pos = (positions[:, None] + t_off.to(positions.dtype)[None, :]
                ).reshape(B * Tv)
    logits = family(cfg).decode_forward(
        params, kv, tokens.reshape(B * Tv), flat_pos, rows(tables), cfg,
        block_size)
    toks, lps = _sample(logits, variant, base_seed, rows(seeds),
                        (steps0[:, None] + t_off[None, :]).reshape(B * Tv),
                        rows(temperature), rows(top_k), rows(top_p))
    out = (toks.view(B, Tv), lps.view(B, Tv))
    return out + (logits.view(B, Tv, -1),) if with_logits else out


def ragged_merge(prev: torch.Tensor, srows: torch.Tensor,
                 host: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A pipelined ragged dispatch's chained-sample merge (JAX's
    ``_ragged_merge_jit``): row r takes the previous dispatch's device
    token ``prev[srows[r]]`` where ``mask[r]``, else its host token."""
    return torch.where(mask, prev[srows], host)


_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
       torch.float32: np.float32}


def _layout(fields, dims: tuple) -> Tuple[Dict[str, tuple], int]:
    """Byte offset, dtype and shape of each input in one arena (16-byte
    aligned fields), and the arena's size."""
    out, off = {}, 0
    for name, dtype, shape in fields:
        shp = shape(*dims)
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
    toks: torch.Tensor                  # static outputs
    logprobs: torch.Tensor
    logits: Optional[torch.Tensor]      # when kept
    launches: Dict[str, int]            # kernel launches per replay


class Dispatch:
    """One launched dispatch: its device outputs (``toks``: [K, B] of a
    decode dispatch, whose last row chains a pipelined one; [S] of a ragged
    dispatch) and its host copy, which ``fetch`` waits for."""

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
        """(toks, logprobs) on the host: the one device→host wait of a
        dispatch."""
        if self._fetched is None:
            if self._event is None:          # eager: a plain copy
                self._fetched = (self.toks.cpu().numpy(),
                                 self.logprobs.cpu().numpy())
            else:
                self._event.synchronize()
                self._fetched = (self._host[0].numpy().copy(),
                                 self._host[1].numpy().copy())
        return self._fetched


class _GraphedProgram:
    """What both programs share: the static inputs of ``fields`` at
    ``dims`` in one device arena, its two pinned staging buffers, two
    pinned output buffers of ``out_shape``, the graphs by key in one
    memory pool, and their capture and replay."""

    def __init__(self, params, kv, cfg, block_size: int, base_seed: int,
                 device, fields, dims: tuple, out_shape: tuple,
                 fills: Optional[Dict[str, float]] = None) -> None:
        self.params, self.kv, self.cfg = params, kv, cfg
        self.block_size = block_size
        self.base_seed = base_seed
        self.device = torch.device(device)
        self._fields, self._dims = fields, dims
        self._fills = fills or {}
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.capture_s = 0.0          # host seconds in warm-ups + captures
        self.replays = 0
        if self.device.type != "cuda":
            return
        self._layout, nbytes = _layout(fields, dims)
        dev = self.device
        self._stream = torch.cuda.Stream(dev)
        self._pool = torch.cuda.graph_pool_handle()
        self._arena = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        self.static = _views(self._arena, self._layout)
        # the warm-up inputs: every row on the trash block
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
        self._out = [(torch.zeros(out_shape, dtype=torch.int64,
                                  pin_memory=True),
                      torch.zeros(out_shape, dtype=torch.float32,
                                  pin_memory=True)) for _ in range(2)]
        self._out_owner: list = [None, None]
        self._out_flip = 0

    def _host_inputs(self, inputs: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Every input at its full shape: ``inputs``' values, from index 0
        of each axis, and the field's fill elsewhere (0 but where
        ``fills`` says)."""
        out = {}
        for name, dtype, shape in self._fields:
            full = np.full(shape(*self._dims), self._fills.get(name, 0),
                           _NP[dtype])
            a = inputs.get(name)
            if a is not None:
                a = np.asarray(a)
                full[tuple(slice(0, d) for d in a.shape)] = a
            out[name] = full
        return out

    def _device_inputs(self, inputs: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
        """The inputs as tensors of their own on the program's device (the
        eager run's)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self._host_inputs(inputs).items()}

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

    def _graph(self, key: tuple,
               run: Callable[[Dict[str, torch.Tensor]], tuple]) -> _Graph:
        """The graph of ``key``, captured at its first use: ``run`` of the
        static inputs, after a warm-up call of it over zeros on the
        capture stream."""
        g = self.graphs.get(key)
        if g is not None:
            return g
        t0 = time.monotonic()
        s = self._stream
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            run(self._zeros)                                 # warm-up
        cur.wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        kernels.CAPTURED.clear()
        with torch.cuda.graph(graph, pool=self._pool, stream=s,
                              capture_error_mode="thread_local"):
            out = run(self.static)
        launches = dict(kernels.CAPTURED)
        kernels.CAPTURED.clear()
        self.captures += 1
        self.capture_s += time.monotonic() - t0
        g = self.graphs[key] = _Graph(graph, out[0], out[1],
                                      out[2] if len(out) > 2 else None,
                                      launches)
        return g

    def _replay(self, g: _Graph, rows: slice) -> Dispatch:
        """Replay ``g`` and copy its outputs' ``rows`` into the next pinned
        output buffer behind an event."""
        g.graph.replay()
        self.replays += 1
        kernels.add_launches(g.launches)
        j = self._out_flip
        self._out_flip ^= 1
        owner = self._out_owner[j]
        if owner is not None:
            owner.fetch()        # its host copy is about to be overwritten
        host = (self._out[j][0][rows], self._out[j][1][rows])
        host[0].copy_(g.toks, non_blocking=True)
        host[1].copy_(g.logprobs, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        d = Dispatch(g.toks, g.logprobs, g.logits, ev, host)
        self._out_owner[j] = d
        return d


# the decode program's inputs: name → (dtype, shape given B, M and K)
_DECODE_FIELDS = (
    ("tokens", torch.int64, lambda B, M, K: (B,)),
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


class DecodeProgram(_GraphedProgram):
    """The engine's decode program over ``params`` and the pool ``kv``
    for a ``[B]`` batch of ``[B, M]`` tables and plans of up to
    ``max_k`` steps."""

    def __init__(self, params, kv, cfg, block_size: int, B: int, M: int,
                 max_k: int, base_seed: int, device) -> None:
        self.B, self.M, self.max_k = B, M, max_k
        super().__init__(params, kv, cfg, block_size, base_seed, device,
                         _DECODE_FIELDS, (B, M, max_k), (max_k, B))

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
        t = self._device_inputs(inputs)
        if chain is not None:
            t["tokens"] = torch.where(t["chain_mask"], chain, t["tokens"])
        return Dispatch(*self._run(K, variant, t, with_logits))

    def _check_k(self, K: int) -> None:
        if not 1 <= K <= self.max_k:
            raise ValueError(f"K={K} outside 1..{self.max_k}")

    def dispatch(self, K: int, variant: str, inputs: Dict[str, np.ndarray],
                 chain: Optional[torch.Tensor] = None,
                 with_logits: bool = False) -> Dispatch:
        """Launch one dispatch of K steps. ``inputs``: host arrays by name
        (``_DECODE_FIELDS``; a missing one is zeros, ``planned`` /
        ``planned_mask`` may have K rows). ``chain``: device tokens [B]
        that replace ``tokens`` where ``chain_mask`` is set (a pipelined
        dispatch's merge, on the stream before the replay)."""
        if self.device.type != "cuda":
            return self.run_eager(K, variant, inputs, chain, with_logits)
        self._check_k(K)
        g = self._graph((K, variant, with_logits),
                        lambda t: self._run(K, variant, t, with_logits))
        self._upload(inputs)
        if chain is not None:
            st = self.static
            st["tokens"].copy_(torch.where(st["chain_mask"], chain,
                                           st["tokens"]))
        return self._replay(g, slice(0, K))


# the ragged program's inputs: name → (dtype, shape given the capacity TT,
# the sequences S = B + 1 and M); the row-sampled program keys each row,
# its steps are [TT]
_RAGGED_FIELDS = (
    ("tokens", torch.int64, lambda T, S, M: (T,)),
    ("positions", torch.int32, lambda T, S, M: (T,)),
    ("row_slot", torch.int32, lambda T, S, M: (T,)),
    ("chain_mask", torch.bool, lambda T, S, M: (T,)),
    ("srows", torch.int64, lambda T, S, M: (T,)),
    ("tables", torch.int32, lambda T, S, M: (S, M)),
    ("seq_starts", torch.int32, lambda T, S, M: (S,)),
    ("seq_counts", torch.int32, lambda T, S, M: (S,)),
    ("sample_rows", torch.int32, lambda T, S, M: (S,)),
    ("seeds", torch.int64, lambda T, S, M: (S,)),
    ("steps", torch.int64, lambda T, S, M: (S,)),
    ("temperature", torch.float32, lambda T, S, M: (S,)),
    ("top_k", torch.int64, lambda T, S, M: (S,)),
    ("top_p", torch.float32, lambda T, S, M: (S,)))


class RaggedProgram(_GraphedProgram):
    """The engine's ragged program over ``params`` and the pool ``kv`` for
    ``B`` slots and the trash sequence (``[B + 1, M]`` tables), row buckets
    of ``B`` and ``capacity`` rows, spans of up to ``max_rows``;
    ``row_sampled``: a sample for every row (speculative spans)."""

    def __init__(self, params, kv, cfg, block_size: int, B: int, M: int,
                 capacity: int, max_rows: int, base_seed: int,
                 device, row_sampled: bool = False) -> None:
        self.B, self.M, self.capacity = B, M, capacity
        self.max_rows = max_rows
        self.row_sampled = row_sampled
        fields = _RAGGED_FIELDS
        if row_sampled:
            fields = tuple(
                ("steps", torch.int64, lambda T, S, M: (T,))
                if f[0] == "steps" else f for f in fields)
        # a row past the packed ones is dead: it belongs to the trash
        # sequence (the last table row, all zeros)
        super().__init__(params, kv, cfg, block_size, base_seed, device,
                         fields, (capacity, B + 1, M),
                         (capacity,) if row_sampled else (B + 1,),
                         fills={"row_slot": B, "top_p": 1.0})

    def bucket(self, inputs: Dict[str, np.ndarray]) -> int:
        """The rows a dispatch of ``inputs`` runs: ``B`` when its used rows
        fit, else the capacity."""
        used = int(np.asarray(inputs["seq_counts"]).sum())
        if used > self.capacity:
            raise ValueError(f"{used} rows over a capacity of "
                             f"{self.capacity}")
        return self.B if used <= self.B else self.capacity

    def _run(self, rows: int, variant: str, t: Dict[str, torch.Tensor],
             with_logits: bool = False) -> tuple:
        return ragged_step_forward(
            self.params, self.kv, t["tokens"][:rows], t["positions"][:rows],
            t["tables"], t["row_slot"][:rows], t["seq_starts"],
            t["seq_counts"], t["sample_rows"], t["seeds"],
            t["steps"][:rows] if self.row_sampled else t["steps"],
            t["temperature"], t["top_k"], t["top_p"], cfg=self.cfg,
            block_size=self.block_size, max_rows=self.max_rows,
            base_seed=self.base_seed, variant=variant,
            with_logits=with_logits, row_sampled=self.row_sampled)

    def run_eager(self, variant: str, inputs: Dict[str, np.ndarray],
                  chain: Optional[torch.Tensor] = None,
                  with_logits: bool = False) -> Dispatch:
        """The same dispatch as ``dispatch``, run eagerly at the same
        bucket on the inputs' own tensors (the CPU path; on the card, the
        plain form a replay is held against)."""
        rows = self.bucket(inputs)
        t = self._device_inputs(inputs)
        if chain is not None:
            t["tokens"] = ragged_merge(chain, t["srows"], t["tokens"],
                                       t["chain_mask"])
        return Dispatch(*self._run(rows, variant, t, with_logits))

    def dispatch(self, variant: str, inputs: Dict[str, np.ndarray],
                 chain: Optional[torch.Tensor] = None,
                 with_logits: bool = False) -> Dispatch:
        """Launch one ragged dispatch. ``inputs``: host arrays by name
        (``_RAGGED_FIELDS``; the row arrays may stop at any row, past which
        rows are dead; a missing array is zeros). ``chain``: the previous
        dispatch's device tokens [B + 1], merged into ``tokens`` where
        ``chain_mask`` is set (``ragged_merge``, on the stream before the
        replay)."""
        if self.device.type != "cuda":
            return self.run_eager(variant, inputs, chain, with_logits)
        rows = self.bucket(inputs)
        g = self._graph((rows, variant, with_logits),
                        lambda t: self._run(rows, variant, t, with_logits))
        self._upload(inputs)
        if chain is not None:
            st = self.static
            st["tokens"].copy_(ragged_merge(chain, st["srows"],
                                            st["tokens"], st["chain_mask"]))
        return self._replay(g, slice(0, rows) if self.row_sampled
                            else slice(None))


# the verify program's inputs: name → (dtype, shape given B, M and the rows
# a slot Tv = spec_k + 1)
_VERIFY_FIELDS = (
    ("tokens", torch.int64, lambda B, M, T: (B, T)),
    ("positions", torch.int32, lambda B, M, T: (B,)),
    ("tables", torch.int32, lambda B, M, T: (B, M)),
    ("seeds", torch.int64, lambda B, M, T: (B,)),
    ("steps0", torch.int64, lambda B, M, T: (B,)),
    ("temperature", torch.float32, lambda B, M, T: (B,)),
    ("top_k", torch.int64, lambda B, M, T: (B,)),
    ("top_p", torch.float32, lambda B, M, T: (B,)))


class VerifyProgram(_GraphedProgram):
    """The engine's verify program over ``params`` and the pool ``kv`` for
    a ``[B]`` batch of ``[B, M]`` tables, ``Tv`` = spec_k + 1 rows a slot
    (a slot with fewer drafts pads its rows; they write KV that no later
    read sees before a dispatch rewrites it)."""

    def __init__(self, params, kv, cfg, block_size: int, B: int, M: int,
                 Tv: int, base_seed: int, device) -> None:
        self.B, self.M, self.Tv = B, M, Tv
        super().__init__(params, kv, cfg, block_size, base_seed, device,
                         _VERIFY_FIELDS, (B, M, Tv), (B, Tv),
                         fills={"top_p": 1.0})

    def _run(self, variant: str, t: Dict[str, torch.Tensor],
             with_logits: bool = False) -> tuple:
        return verify_forward(
            self.params, self.kv, t["tokens"], t["positions"], t["tables"],
            t["seeds"], t["steps0"], t["temperature"], t["top_k"],
            t["top_p"], cfg=self.cfg, block_size=self.block_size,
            base_seed=self.base_seed, variant=variant,
            with_logits=with_logits)

    def run_eager(self, variant: str, inputs: Dict[str, np.ndarray],
                  with_logits: bool = False) -> Dispatch:
        """The same dispatch as ``dispatch``, run eagerly on the inputs'
        own tensors (the CPU path; on the card, the plain form a replay is
        held against)."""
        return Dispatch(*self._run(variant, self._device_inputs(inputs),
                                   with_logits))

    def dispatch(self, variant: str, inputs: Dict[str, np.ndarray],
                 with_logits: bool = False) -> Dispatch:
        """Launch one verify dispatch. ``inputs``: host arrays by name
        (``_VERIFY_FIELDS``; a missing one is zeros)."""
        if self.device.type != "cuda":
            return self.run_eager(variant, inputs, with_logits)
        g = self._graph((variant, with_logits),
                        lambda t: self._run(variant, t, with_logits))
        self._upload(inputs)
        return self._replay(g, slice(None))
