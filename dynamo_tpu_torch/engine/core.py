"""Continuous-batching engine core: slots, paged-block allocator, and the
async scheduling loop driving the model's prefill and decode steps.

Counterpart of ``dynamo_tpu.engine.core`` for the single-device main path:
submit, admission with prefix reuse, bucketed whole-prompt prefill, one
decode step per dispatch for every ready slot, finish on EOS / budget /
cancellation, and recompute preemption when the KV pool runs out.

PyTorch runs eagerly, so there are no compiled programs: prefill and decode
are plain calls into ``models/llama.py`` that update the KV pool in place.
Inactive decode slots aim at the trash block 0 with position 0, as in the
JAX engine, so every decode step has the static ``[max_num_seqs]`` batch.
Sampling noise comes from a ``torch.Generator`` per request on the device,
seeded from the engine seed and the request's seed, so a seeded request
reproduces its stream whatever else is batched with it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from ..llm.kv.blocks import TokenBlockSequence
from ..llm.kv.pool import KvBlockManager
from ..llm.protocols.common import FinishReason
from .config import EngineConfig, ModelConfig
from .device import resolve_device
from .models import llama
from .sampling import SlotSampling, gumbel_noise, sample_tokens
from .weights import init_params

logger = logging.getLogger("dynamo_tpu_torch.engine")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class EngineRequest:
    """One sequence's engine-side state."""

    rid: str
    prompt: List[int]
    sampling: SlotSampling
    max_new_tokens: int
    eos_ids: frozenset
    ctx: object = None            # runtime EngineContext (cancellation)
    out_queue: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                  # tokens currently in KV
    generated: int = 0
    last_token: int = -1
    prefix_hit_tokens: int = 0
    seq: Optional[TokenBlockSequence] = None   # full token history + hashes
    registered_blocks: int = 0
    emitted_total: int = 0        # tokens the client has seen (across lives)
    # client-stream indices where the next token was re-derived by a
    # recompute prefill after a preemption: streams are exact against an
    # uncontended run only up to the first of these
    numeric_boundaries: List[int] = dataclasses.field(default_factory=list)
    # per-request sampling noise source (None for greedy requests); its
    # state survives preemption, so recompute never reuses consumed noise
    generator: Optional[torch.Generator] = None

    @property
    def cancelled(self) -> bool:
        """Client-stop OR deadline-exceeded."""
        if self.ctx is None:
            return False
        return bool(self.ctx.is_stopped
                    or getattr(self.ctx, "deadline_exceeded", False))


@dataclasses.dataclass
class ForwardPassMetrics:
    """Worker load metrics (the main-path subset of
    ``dynamo_tpu.llm.kv_router.protocols.ForwardPassMetrics``)."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    requests_cancelled_total: int = 0
    requests_deadline_exceeded_total: int = 0
    kv_block_size: int = 0
    preemptions_total: int = 0
    prefill_tokens_total: int = 0
    decode_tokens_total: int = 0


_FINISH = object()  # queue sentinel
FINISH_SENTINEL = _FINISH


class EngineCore:
    """The model-executing scheduler. Owns params + KV pool on ``device``."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        if model_cfg.num_experts > 0 or model_cfg.kv_lora_rank > 0:
            raise NotImplementedError(
                "MoE and MLA families are not implemented by the PyTorch "
                "engine (dense llama only)")
        if (model_cfg.sliding_window is not None
                and engine_cfg.max_model_len <= model_cfg.sliding_window):
            # the window can never bind at this serving length
            model_cfg = dataclasses.replace(model_cfg, sliding_window=None)
        _rs = model_cfg.rope_scaling
        if (_rs is not None and _rs.rope_type == "longrope"
                and _rs.longrope_active == "auto"
                and engine_cfg.max_model_len
                <= _rs.original_max_position_embeddings):
            # every servable sequence fits the pretrained window: the SHORT
            # factors are HF-exact for all of them
            model_cfg = dataclasses.replace(
                model_cfg, rope_scaling=dataclasses.replace(
                    _rs, longrope_active="short"))
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.dtype = _DTYPES[engine_cfg.dtype]
        if params is None:
            params = init_params(model_cfg, engine_cfg.seed, self.device,
                                 self.dtype)
        self.params = params
        self.kv = llama.init_kv_cache(model_cfg, engine_cfg.num_kv_blocks,
                                      engine_cfg.kv_block_size, self.device,
                                      self.dtype)
        self.kv_manager = KvBlockManager(
            engine_cfg.num_kv_blocks, engine_cfg.kv_block_size,
            enable_reuse=engine_cfg.enable_prefix_reuse)
        self.M = engine_cfg.max_blocks_per_seq
        self.B = engine_cfg.max_num_seqs
        self.slots: List[Optional[EngineRequest]] = [None] * self.B
        self.waiting: asyncio.Queue = asyncio.Queue()
        self._inflight_reqs: dict = {}
        self._dead: Optional[BaseException] = None
        self._work_event = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopping = False
        # host mirrors of per-slot state
        self._block_tables = np.zeros((self.B, self.M), dtype=np.int32)
        self._positions = np.zeros((self.B,), dtype=np.int32)
        self._tokens = np.zeros((self.B,), dtype=np.int64)
        # serving stats
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.preemptions = 0
        self.requests_cancelled_total = 0
        self.requests_deadline_exceeded_total = 0

    # ------------------------------------------------------------- lifecycle
    def ensure_started(self) -> None:
        if self._dead is not None:
            raise RuntimeError(
                f"engine loop died: {self._dead!r} — create a new "
                f"EngineCore") from self._dead
        if self._loop_task is None or self._loop_task.done():
            self._stopping = False
            self._work_event = asyncio.Event()
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run_loop(), name="engine-core-loop")

    async def stop(self) -> None:
        self._stopping = True
        self._work_event.set()
        if self._loop_task is not None:
            try:
                await asyncio.wait_for(self._loop_task, timeout=30)
            except asyncio.TimeoutError:
                self._loop_task.cancel()
            except asyncio.CancelledError:
                if not self._loop_task.done():
                    raise
            except Exception:  # noqa: BLE001 — loop death already failed
                # every pending request (_fail_pending) and was logged
                pass
            self._loop_task = None

    async def submit(self, req: EngineRequest) -> None:
        self.ensure_started()
        self._inflight_reqs[id(req)] = req
        await self.waiting.put(req)
        self._work_event.set()

    def metrics(self) -> ForwardPassMetrics:
        total = self.cfg.num_kv_blocks - 1
        used = self.kv_manager.pool.used_blocks
        return ForwardPassMetrics(
            request_active_slots=sum(1 for s in self.slots if s is not None),
            request_total_slots=self.B,
            kv_active_blocks=used,
            kv_total_blocks=total,
            num_requests_waiting=self.waiting.qsize(),
            gpu_cache_usage_perc=used / max(total, 1),
            gpu_prefix_cache_hit_rate=self.kv_manager.pool.hit_rate(),
            requests_cancelled_total=self.requests_cancelled_total,
            requests_deadline_exceeded_total=self
            .requests_deadline_exceeded_total,
            kv_block_size=self.cfg.kv_block_size,
            preemptions_total=self.preemptions,
            prefill_tokens_total=self.total_prefill_tokens,
            decode_tokens_total=self.total_decode_tokens)

    # ------------------------------------------------------------ scheduler
    def _free_slot_index(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def _blocks_needed(self, n_tokens: int) -> int:
        bs = self.cfg.kv_block_size
        return (n_tokens + bs - 1) // bs

    async def _run_loop(self) -> None:
        try:
            await self._run_loop_inner()
        except asyncio.CancelledError:
            raise
        except Exception as e:   # noqa: BLE001 — fatal loop error
            logger.exception("engine loop died; failing %d active + %d "
                             "waiting requests",
                             sum(1 for x in self.slots if x is not None),
                             self.waiting.qsize())
            self._fail_pending(e)
            raise

    def _fail_pending(self, exc: BaseException) -> None:
        self._dead = exc
        for req in list(self._inflight_reqs.values()):
            req.out_queue.put_nowait((_FINISH, FinishReason.ERROR))
        self._inflight_reqs.clear()
        for req in self.slots:
            if req is not None and req.blocks:
                self.kv_manager.pool.release(req.blocks)
                req.blocks = []
        self.slots = [None] * len(self.slots)
        while not self.waiting.empty():
            self.waiting.get_nowait()

    async def _run_loop_inner(self) -> None:
        logger.info("engine loop starting: %d slots, %d KV blocks, block=%d "
                    "on %s", self.B, self.cfg.num_kv_blocks,
                    self.cfg.kv_block_size, self.device)
        while not self._stopping:
            progressed = self._sweep_cancelled()
            # 1) admit waiting work into free slots
            while not self.waiting.empty():
                slot = self._free_slot_index()
                if slot < 0:
                    break
                req: EngineRequest = self.waiting.get_nowait()
                if req.cancelled:
                    self._finish_request(req, FinishReason.CANCELLED)
                    continue
                if not self._try_admit(req, slot):
                    # not enough KV blocks — put it back and stop admitting
                    self.waiting._queue.appendleft(req)  # type: ignore[attr-defined]
                    break
                progressed = True
                await asyncio.sleep(0)   # let the admission's first token out
            # 2) one decode step for every active slot
            if any(s is not None for s in self.slots):
                self._decode_step()
                progressed = True
            if not progressed:
                self._work_event.clear()
                try:
                    await asyncio.wait_for(self._work_event.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
            else:
                await asyncio.sleep(0)  # let producers/consumers run
        logger.info("engine loop stopped")

    def _sweep_cancelled(self) -> bool:
        """Cancelled/deadline-exceeded requests leave the waiting queue
        before taking a slot, and their slots are vacated at once."""
        progressed = False
        if not self.waiting.empty():
            survivors: List[EngineRequest] = []
            while not self.waiting.empty():
                r: EngineRequest = self.waiting.get_nowait()
                if r.cancelled:
                    self._finish_request(r, FinishReason.CANCELLED)
                    progressed = True
                else:
                    survivors.append(r)
            for r in survivors:
                self.waiting.put_nowait(r)
        for req in list(self.slots):
            if req is not None and req.cancelled:
                self._release_slot(req)
                self._finish_request(req, FinishReason.CANCELLED)
                progressed = True
        return progressed

    # ---------------------------------------------------------------- admit
    def _try_admit(self, req: EngineRequest, slot: int) -> bool:
        plan = self.kv_manager.prepare_prefill(req.prompt, seq=req.seq)
        if plan is None:
            return False
        if len(plan.all_blocks) > self.M:
            # longer than a block table row — reject rather than overflow
            self.kv_manager.abort_plan(plan)
            self._finish_request(req, FinishReason.LENGTH)
            return True
        self._admit_with_plan(req, slot, plan)
        return True

    def _generator_for(self, req: EngineRequest) -> Optional[torch.Generator]:
        if req.sampling.temperature <= 0.0:
            return None
        if req.generator is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.cfg.seed * 1_000_003 + req.sampling.seed)
                            & 0x7FFF_FFFF_FFFF_FFFF)
            req.generator = gen
        return req.generator

    def _sample(self, logits: torch.Tensor,
                reqs: List[Optional[EngineRequest]]) -> tuple:
        """Sample one token per row of ``logits`` [B, V] with each row's
        request parameters (None rows sample greedily and are ignored)."""
        n = logits.shape[0]
        temperature = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int64)
        top_p = np.ones((n,), np.float32)
        gens = []
        for i, r in enumerate(reqs):
            gens.append(None if r is None else self._generator_for(r))
            if r is not None:
                temperature[i] = r.sampling.temperature
                top_k[i] = r.sampling.top_k
                top_p[i] = r.sampling.top_p
        noise = gumbel_noise(logits.shape[1], gens, self.device)
        toks, logprobs = sample_tokens(
            logits, noise, torch.from_numpy(temperature).to(self.device),
            torch.from_numpy(top_k).to(self.device),
            torch.from_numpy(top_p).to(self.device))
        return toks.cpu().numpy(), logprobs.cpu().numpy()

    def _admit_with_plan(self, req: EngineRequest, slot: int, plan) -> None:
        n_prompt = len(req.prompt)
        t0 = time.monotonic()
        req.slot = slot
        req.blocks = plan.all_blocks
        req.seq = plan.seq
        req.prefix_hit_tokens = plan.hit_tokens
        n_already = len(plan.hit_blocks)
        # prefill only the un-matched suffix — the prefix KV is already in
        # the pool's blocks (the TTFT win of prefix reuse)
        chunk = req.prompt[req.prefix_hit_tokens:]
        bucket = self.cfg.bucket_for(len(chunk))
        table = np.zeros((self.M,), np.int32)
        table[:len(req.blocks)] = req.blocks
        padded = np.zeros((bucket,), np.int64)
        padded[:len(chunk)] = chunk
        with torch.inference_mode():
            logits = llama.prefill_forward(
                self.params, self.kv,
                torch.from_numpy(padded).to(self.device),
                torch.from_numpy(table).to(self.device),
                req.prefix_hit_tokens, len(chunk), self.model_cfg,
                self.cfg.kv_block_size)
            toks, logprobs = self._sample(logits[None, :], [req])
        tok, logprob = int(toks[0]), float(logprobs[0])
        self.total_prefill_tokens += len(chunk)
        req.pos = n_prompt
        req.generated = 1
        # the prompt's full blocks now hold valid KV — register for reuse
        req.registered_blocks = self.kv_manager.register_full_blocks(
            req.blocks, plan.seq, already_registered=n_already)
        req.last_token = tok
        self.slots[slot] = req
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(req.blocks)] = req.blocks
        logger.debug("admitted %s into slot %d (prompt=%d, hit=%d, %.1fms)",
                     req.rid, slot, n_prompt, plan.hit_tokens,
                     1e3 * (time.monotonic() - t0))
        self._emit(req, tok, logprob)
        self._maybe_finish_after_emit(req)

    # --------------------------------------------------------------- decode
    def _decode_step(self) -> None:
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        for i in range(self.B):
            s = self.slots[i]
            if s is None:
                self._tokens[i] = 0
                self._positions[i] = 0
                self._block_tables[i, :] = 0  # trash block
            else:
                self._tokens[i] = s.last_token
                self._positions[i] = s.pos
        with torch.inference_mode():
            logits = llama.decode_forward(
                self.params, self.kv,
                torch.from_numpy(self._tokens).to(self.device),
                torch.from_numpy(self._positions).to(self.device),
                torch.from_numpy(self._block_tables).to(self.device),
                self.model_cfg, self.cfg.kv_block_size)
            toks, logprobs = self._sample(logits, list(self.slots))
        bs = self.cfg.kv_block_size
        for i in active_idx:
            req = self.slots[i]
            if req is None:
                continue
            if req.cancelled:
                self._release_slot(req)
                self._finish_request(req, FinishReason.CANCELLED)
                continue
            tok = int(toks[i])
            # the step wrote the *input* token's KV into the cache — its
            # block may now be full and registrable for prefix reuse
            req.seq.append(int(self._tokens[i]))
            req.registered_blocks = self.kv_manager.register_full_blocks(
                req.blocks, req.seq, req.registered_blocks)
            req.pos += 1
            req.generated += 1
            req.last_token = tok
            self.total_decode_tokens += 1
            # grow the block table if the *next* token starts a new block
            if (req.pos + 1) > len(req.blocks) * bs:
                if len(req.blocks) >= self.M:       # context capacity
                    self._emit(req, tok, float(logprobs[i]))
                    self._release_slot(req)
                    self._finish_request(req, FinishReason.LENGTH)
                    continue
                new = self.kv_manager.pool.alloc_uninit(1)
                if new is None:
                    # out of KV memory: the sampled token is still valid —
                    # emit it, then finish if it was terminal anyway, else
                    # preempt
                    self._emit(req, tok, float(logprobs[i]))
                    if (req.last_token in req.eos_ids
                            or req.generated >= req.max_new_tokens
                            or req.cancelled):
                        self._maybe_finish_after_emit(req)
                    else:
                        self._preempt_or_finish(req)
                    continue
                req.blocks.extend(new)
                self._block_tables[i, len(req.blocks) - 1] = new[0]
            self._emit(req, tok, float(logprobs[i]))
            self._maybe_finish_after_emit(req)

    def _preempt_or_finish(self, req: EngineRequest) -> None:
        """KV exhaustion policy: recompute preemption when the pool is
        contended (the request releases its blocks and re-queues with
        every emitted token appended to its prompt), else finish with
        LENGTH."""
        others = any(s is not None and s is not req for s in self.slots)
        budget_left = req.max_new_tokens - req.generated
        emitted_len = (0 if req.seq is None
                       else len(req.seq.tokens) - len(req.prompt))
        new_len = len(req.prompt) + emitted_len + 1
        bs = self.cfg.kv_block_size
        fits = (new_len < self.cfg.max_model_len
                and self._blocks_needed(new_len + bs) <= self.M)
        if not others or budget_left <= 0 or not fits:
            self._release_slot(req)
            self._finish_request(req, FinishReason.LENGTH)
            return
        self.preemptions += 1
        logger.info("preempting %s after %d tokens (KV exhausted; "
                    "recompute on re-admission)", req.rid, req.generated)
        req.numeric_boundaries.append(req.emitted_total)
        emitted = req.seq.tokens[len(req.prompt):] if req.seq else []
        self._release_slot(req)
        req.prompt = list(req.prompt) + list(emitted) + [req.last_token]
        req.max_new_tokens = budget_left
        req.seq = None               # admission rebuilds the hash chain
        req.slot = -1
        req.pos = 0
        req.generated = 0
        req.registered_blocks = 0
        req.prefix_hit_tokens = 0
        self.waiting.put_nowait(req)
        self._work_event.set()

    # ------------------------------------------------------------- finishes
    def _emit(self, req: EngineRequest, token: int, logprob: float) -> None:
        req.emitted_total += 1
        req.out_queue.put_nowait((token, logprob))

    def _maybe_finish_after_emit(self, req: EngineRequest) -> None:
        if req.last_token in req.eos_ids:
            self._release_slot(req)
            self._finish_request(req, FinishReason.EOS)
        elif req.generated >= req.max_new_tokens:
            self._release_slot(req)
            self._finish_request(req, FinishReason.LENGTH)
        elif req.cancelled:
            self._release_slot(req)
            self._finish_request(req, FinishReason.CANCELLED)

    def _release_slot(self, req: EngineRequest) -> None:
        if req.slot >= 0 and self.slots[req.slot] is req:
            self.slots[req.slot] = None
            self._block_tables[req.slot, :] = 0
        self.kv_manager.pool.release(req.blocks)
        req.blocks = []

    def _finish_request(self, req: EngineRequest,
                        reason: FinishReason) -> None:
        if reason == FinishReason.CANCELLED:
            ctx = req.ctx
            if (ctx is not None and not ctx.is_stopped
                    and getattr(ctx, "deadline_exceeded", False)):
                self.requests_deadline_exceeded_total += 1
            else:
                self.requests_cancelled_total += 1
        self._inflight_reqs.pop(id(req), None)
        req.out_queue.put_nowait((_FINISH, reason))
