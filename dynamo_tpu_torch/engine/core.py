"""Continuous-batching engine core: slots, paged-block allocator, and the
async scheduling loop driving the model's prefill and decode steps.

Counterpart of ``dynamo_tpu.engine.core`` for the single-device main path,
for a dense llama-family model or an MLA model (``models/mla.py``,
DeepSeek-V2 with its MoE block; the family's module is ``self.model_mod``):
submit, admission with prefix reuse, bucketed whole-prompt or chunked
prefill (``EngineConfig.prefill_chunk``), decode dispatches of K steps for
every ready slot (``decode_steps_per_dispatch``; each harvested once,
optionally one dispatch late so that the next chains off the device's
tokens: ``decode_dispatch_pipeline``), lane prefill of short admissions
into a busy decode batch (``lane_prefill_max_tokens``), finish on EOS /
budget / cancellation, and recompute preemption when the KV pool runs out.
Over a mesh with an sp axis (``parallel/sharding.py``), a llama model's
long cold prompts prefill sequence-parallel (``llama.prefill_forward_sp``,
ring attention); decode stays on the engine's device. With
``EngineConfig.ragged_dispatch`` every engine step is instead ONE ragged
dispatch (``engine/ragged.py``, the family's ``ragged_forward``):
admissions ride it as prefill lanes, chunk by chunk, beside the decode
rows of the other slots; with ``decode_dispatch_pipeline`` a pure-decode
ragged dispatch defers its harvest one dispatch, as a decode dispatch does.

Prefill is an eager call into the family's module that updates the KV pool
in place. A decode dispatch is the decode program and a ragged dispatch
the ragged program (``engine/programs.py``): on the card one CUDA graph
replay, the port's form of the JAX engine's compiled ``decode`` /
``decode_k`` and ``ragged`` programs; on the CPU the same function run
eagerly. Inactive decode slots aim at the trash block 0 with position 0, as
in the JAX engine, so every decode dispatch has the static
``[max_num_seqs]`` batch, and a ragged dispatch one of two row buckets.
Sampling noise is the JAX engine's: each sampled token is keyed by (engine
seed, request seed, the request's ``key_step``), so a seeded request
reproduces the JAX engine's stream whatever else is batched with it, also
across a recompute preemption. Weights may be int8/int4-quantized
(``EngineConfig.quantization``) and the KV pool int8
(``EngineConfig.kv_quantization``).

Speculative decoding (``EngineConfig.spec_k`` > 0, ``engine/spec/``): the
prompt-lookup drafter proposes up to k tokens a slot from the request's
own harvested history, and one verify dispatch (the verify program, a CUDA
graph on the card) scores every slot's drafts and the bonus position, each
row keyed where plain decode would key it; the harvest accepts drafts by
lockstep token equality and a rejected draft rolls back by rewind. When no
slot drafted, the step is plain decode. Under ``ragged_dispatch`` the
drafts ride the ragged batch as spec spans of the row-sampled ragged
program. A pipelined dispatch drains before drafting.

KV tiers (``EngineConfig.host_kv_blocks``, ``kv_disk_dir`` /
``kv_disk_blocks``): a finished request's full blocks are written back to a
host pool (``llm/kv/offload.py``; pinned memory on the card) and host
evictions spill to a durable disk store (``llm/kv/diskstore.py``) that the
next engine on the same directory warm-starts from. Under the disk, the
remote tier (``kv_remote_dir``, ``llm/kv/remotestore.py``): an object
store the disk's evictions promote into and any engine on the same root
admits from, to which ``publish_prefix_to_remote`` writes a prefix
(prefill-as-a-service), and, with a fleet fabric attached
(``attach_kv_fabric``, ``llm/kv/fabric.py``), the host and disk blocks of
peer workers; its hits pass the fabric's admission gate, which prices
recompute with ``measured_prefill_tok_per_s``. An admission whose prefix
misses the device pool but hits a tier reserves its slot and onboards off
the loop: a thread fetches the remote blocks (a failed fetch drops them
and the prefill recomputes those tokens), reads them with the host and
disk rows into pinned memory and copies them to the card on the tier
stream; the loop then scatters them in place (``engine/block_copy.py``)
and admits, while the other slots keep decoding. An idle defrag pass
(``kv_defrag_threshold``) moves the worst-fragmented sequence's own
blocks into a free run. Every
tier and defrag write into the pool is in place: the programs' CUDA graphs
hold the pool tensors' addresses.

Disaggregation (``llm/disagg.py``): a prefill worker's request carries a
``handoff``: after its prefill the engine gathers the prompt's blocks on
the compute stream and a task ships them (device tensors over the
in-process device plane, or host copies fetched off the loop on the tier
stream, whole or a layer at a time), and the request finishes. A decode
worker's request carries the ``precomputed`` KV instead: admission
scatters it into the pool in place (a device payload of another KV
quantization is repacked first, off the loop), or, for a layer stream
still arriving, reserves the slot undecodable and scatters each layer as
it lands; a dead stream re-admits cold. Both keep the prefill path (no
lane or ragged admission), as in the JAX engine.

The engine keeps a flight recorder (``engine/flight_recorder.py``, one
record a dispatch, read through ``GET /debug``) and, when
``self.recorder`` is set (``engine/replay.py`` ``Recorder``), records
every dispatch's host inputs and every harvest in device order, with the
JAX engine's event fields, for ``replay`` and the log checkers.
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
from ..llm.kv.diskstore import DiskKvStore, DiskSpillEngine, SpillJob
from ..llm.kv.offload import KvOffloadEngine, OffloadJob, make_host_pool
from ..llm.kv.fabric import PrefillRateEstimator
from ..llm.kv.pool import KvBlockManager
from ..llm.kv.remotestore import ObjectKvBackend, RemoteKvStore, stack_wire
from ..llm.kv.stream import LayeredHarvest, LayerStreamPayload
from ..llm.kv_transport import DeviceKvPayload, scatter_blocks_device
from ..llm.protocols.common import FinishReason
from ..llm.protocols.disagg import torch_dtype
from ..parallel.sharding import replicate_params
from .attention import (dequant_kv_rows, dequant_kv_rows_sections,
                        quantize_kv_rows, quantize_kv_rows_sections)
from .block_copy import (fetch_wire, fetch_wire_layer, gather_blocks_dispatch,
                         move_blocks, scatter_blocks_from_host,
                         scatter_layer_transfer, scatter_transfer, start_h2d,
                         wire_kv_heads)
from .config import EngineConfig, ModelConfig
from .device import resolve_device
from .flight_recorder import FlightRecorder, register_recorder
from .models import family
from .programs import (DecodeProgram, RaggedProgram, VerifyProgram,
                       sampling_variant)
from .quant import (init_params_quantized, quantize_params,
                    tree_quantization)
from .ragged import RaggedBatch, build_ragged_batch
from .sampling import SlotSampling, gumbel_noise, make_slot_key, sample_tokens
from .spec import PromptLookupDrafter
from .weights import init_params

logger = logging.getLogger("dynamo_tpu_torch.engine")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    # disaggregation (llm/disagg.py):
    # - prefill worker: async callback(first_token, logprob, values,
    #   seq_hashes) shipping the prompt's KV blocks to the decode engine;
    #   the request finishes after its prefill
    handoff: object = None
    # - device plane (llm/kv_transport.py): the callback receives the
    #   device gather ({"stacked", "n_blocks"}) and the first token as a
    #   device tensor; nothing is copied to the host
    handoff_device: bool = False
    # - wire plane with layer streaming (llm/kv/stream.py): the callback
    #   receives a LayeredHarvest (per-layer device→host fetches) instead
    #   of whole-stack host values
    handoff_layered: bool = False
    # - decode worker: the KV of a remote prefill (a KvPayload of host wire
    #   values, a DeviceKvPayload of device tensors, or a
    #   LayerStreamPayload, arrived or arriving); admission scatters it
    #   instead of running the prefill
    precomputed: object = None
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                  # tokens currently in KV
    generated: int = 0
    # monotone per-request sampling step: equals `generated` until a
    # preemption, after which it keeps advancing (the JAX engine's rule),
    # so recompute never reuses a consumed key
    key_step: int = 0
    last_token: int = -1
    # False while the admission prefill's sampled token is still on its
    # way from the device (EngineConfig.overlap_admission_fetch): the slot
    # is held but no dispatch decodes it until _complete_admissions
    ready: bool = True
    prefix_hit_tokens: int = 0
    seq: Optional[TokenBlockSequence] = None   # full token history + hashes
    registered_blocks: int = 0
    emitted_total: int = 0        # tokens the client has seen (across lives)
    # client-stream indices where the next token was re-derived by a
    # recompute prefill after a preemption: streams are exact against an
    # uncontended run only up to the first of these
    numeric_boundaries: List[int] = dataclasses.field(default_factory=list)
    # ragged serving: the prompt being consumed chunk by chunk (incl. any
    # prefix-hit tokens); while pos < len(lane_prompt) the slot is a
    # prefill lane of the ragged batch, after that a decode row
    lane_prompt: Optional[List[int]] = None
    # speculation budget (engine/spec/): -1 = the engine's live default
    # (EngineCore.spec_k_live), 0 = off, n > 0 clamped to
    # EngineConfig.spec_k
    spec_k: int = -1
    enqueue_time: float = dataclasses.field(default_factory=time.monotonic)
    # re-admitted after a host / disk tier read failed: skip the tier
    # cascade and recompute the prefix
    cold_admission: bool = False

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
    # ragged dispatch: used rows over capacity, the share of dispatches
    # that mixed prefill and decode, and the split-path dispatches saved
    ragged_fill_ratio: float = 0.0
    ragged_mixed_ratio: float = 0.0
    ragged_dispatches_saved_total: int = 0
    ragged_spec_rows_total: int = 0
    # speculation: drafts scored and accepted, their ratio, and accepted
    # drafts a verify dispatch
    spec_drafted_total: int = 0
    spec_accepted_total: int = 0
    spec_acceptance_rate: float = 0.0
    spec_accepted_per_step: float = 0.0
    # the device pool's layout: free-run fragmentation, maximal free runs,
    # adjacency delivered by allocations, blocks moved by defrag
    kv_frag_ratio: float = 0.0
    kv_contig_runs: int = 0
    kv_contiguity_ratio: float = 0.0
    kv_defrag_moves_total: int = 0
    # the host tier and its write-back pump
    host_stored_total: int = 0
    host_evicted_total: int = 0
    host_hit_rate: float = 0.0
    offload_dropped_jobs_total: int = 0
    # the disk tier and its spill pump
    disk_used_blocks: int = 0
    disk_capacity_blocks: int = 0
    disk_stored_total: int = 0
    disk_evicted_total: int = 0
    disk_hit_rate: float = 0.0
    disk_bytes_used: int = 0
    disk_spill_dropped_total: int = 0
    disk_spill_shed_total: int = 0
    # the device pool's prefix-match hits, in blocks (a KV-aware router's
    # placements show here)
    prefix_hit_blocks_total: int = 0
    # the streaming layer-wise KV handoff: layers scattered, streams that
    # fell back (monolithic tail or cold recompute), the share of the
    # onboard's wall time spent scattering rather than waiting on the
    # wire, and the streaming depth the router prices (0 until the first
    # streamed admission)
    disagg_stream_layers_total: int = 0
    disagg_stream_fallbacks_total: int = 0
    disagg_stream_overlap_ratio: float = 0.0
    disagg_stream_layers: int = 0
    # the remote (G4) tier and the fabric (llm/kv/remotestore.py,
    # llm/kv/fabric.py): object occupancy, peer-held blocks, hits,
    # failed fetches, gate rejections, the measured link, the data
    # plane's fetches and fallbacks, the breakers; the blocks this worker
    # published as a prefill-publish worker; and the transfer-vs-
    # recompute model's units the router prices with
    remote_used_blocks: int = 0
    remote_capacity_blocks: int = 0
    remote_peer_blocks: int = 0
    remote_stored_total: int = 0
    remote_hit_rate: float = 0.0
    remote_fetch_failures_total: int = 0
    remote_admission_rejects_total: int = 0
    remote_link_gbps: float = 0.0
    remote_link_rtt_s: float = 0.0
    remote_dataplane_fetches_total: int = 0
    remote_dataplane_fallbacks_total: int = 0
    remote_breaker_open_peers: int = 0
    remote_breaker_trips_total: int = 0
    prefill_published_blocks_total: int = 0
    kv_bytes_per_block: int = 0
    prefill_tok_per_s: float = 0.0

    def to_dict(self) -> dict:
        """The wire form a worker publishes as its stats (read by
        ``llm/kv_router/protocols.ForwardPassMetrics.from_dict``)."""
        return dict(self.__dict__)


_FINISH = object()  # queue sentinel
# an onboard whose tier hits all fell away (a failed remote fetch with no
# host or disk rows): the admission goes on with nothing to scatter
_NO_ONBOARD = object()
FINISH_SENTINEL = _FINISH


def sample_keyed(logits: torch.Tensor, base_seed: int, rows: list,
                 device) -> tuple:
    """Sample one token per row of ``logits`` [N, V]: ``rows[i]`` is
    (temperature, top_k, top_p, request seed, key step), keyed on the host
    (``make_slot_key``; a greedy row draws no noise). Returns (tokens,
    logprobs) on ``device``."""
    temperature = np.array([r[0] for r in rows], np.float32)
    top_k = np.array([r[1] for r in rows], np.int64)
    top_p = np.array([r[2] for r in rows], np.float32)
    keys = [make_slot_key(base_seed, r[3], r[4]) if r[0] > 0.0 else None
            for r in rows]
    noise = gumbel_noise(logits.shape[1], keys, device)
    return sample_tokens(
        logits, noise, torch.from_numpy(temperature).to(device),
        torch.from_numpy(top_k).to(device),
        torch.from_numpy(top_p).to(device))


class _FirstToken:
    """An admission's first token and its logprob on their way to the host
    (``overlap_admission_fetch``). On the card: an asynchronous copy into
    pinned host memory on the engine's stream with an event recorded behind
    it, issued by the eager admission, never inside a CUDA graph capture.
    On the CPU: the values themselves."""

    def __init__(self, tok: torch.Tensor, logprob: torch.Tensor) -> None:
        self._event = None
        if not tok.is_cuda:
            self._tok, self._logprob = tok, logprob
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("an admission's first-token copy must stay "
                               "out of a captured decode graph")
        self._tok = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
        self._logprob = torch.empty(logprob.shape, dtype=logprob.dtype,
                                    pin_memory=True)
        self._tok.copy_(tok, non_blocking=True)
        self._logprob.copy_(logprob, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tok.device))

    def wait(self) -> tuple:
        """(token, logprob) on the host, once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return int(self._tok[0]), float(self._logprob[0])


class EngineCore:
    """The model-executing scheduler. Owns params + KV pool on ``device``."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[dict] = None, device="cuda", mesh=None):
        self.device = resolve_device(device)
        # sequence-parallel prefill (parallel/sharding.py): the mesh is
        # authoritative, and EngineConfig.sp must agree when set
        self.mesh = mesh
        self._sp = mesh.shape["sp"] if mesh is not None else 1
        if engine_cfg.sp > 1 and engine_cfg.sp != self._sp:
            raise ValueError(f"EngineConfig.sp={engine_cfg.sp} but the mesh "
                             f"carries sp={self._sp}")
        if self._sp > 1:
            # re-run the config's checks against the mesh's sp (ragged
            # dispatch refuses it)
            engine_cfg = dataclasses.replace(engine_cfg, sp=self._sp)
        # model-family dispatch (the JAX engine's model_mod): MLA or llama;
        # each combination the port does not serve yet refuses here
        if model_cfg.kv_lora_rank > 0:
            if engine_cfg.quantization.startswith("int4"):
                raise NotImplementedError(
                    "MLA + int4 weight quantization is not integrated "
                    "(the JAX engine refuses it too)")
            if engine_cfg.quantization != "none":
                raise NotImplementedError(
                    "MLA with int8 weights is not implemented by the "
                    "PyTorch engine (ROADMAP A8: qeinsum over the expert "
                    "stacks)")
            if self._sp > 1:
                raise NotImplementedError(
                    "MLA sequence-parallel prefill (ring_attention_mla) is "
                    "not implemented by the PyTorch engine (ROADMAP A8)")
        elif model_cfg.num_experts > 0:
            raise NotImplementedError(
                "the MoE llama families (mixtral, qwen2_moe) are not "
                "implemented by the PyTorch engine (ROADMAP A8)")
        self.model_mod = family(model_cfg)
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
        if engine_cfg.kv_block_size == 0:
            # resolved before anything reads the block size
            engine_cfg = dataclasses.replace(
                engine_cfg, kv_block_size=EngineConfig.auto_kv_block_size(
                    model_cfg, engine_cfg.kv_quantization))
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.dtype = DTYPES[engine_cfg.dtype]
        quantized = engine_cfg.quantization != "none"
        # int4 = grouped-int4 layer matmuls with an int8 head and embed;
        # "-noembed" keeps the embedding in the load dtype (quant.py)
        qbits = 4 if engine_cfg.quantization.startswith("int4") else 8
        qembed = not engine_cfg.quantization.endswith("-noembed")
        if params is None and quantized:
            # one tensor at a time: never the whole tree in self.dtype
            params = init_params_quantized(model_cfg, engine_cfg.seed,
                                           self.device, self.dtype,
                                           include_embed=qembed, bits=qbits)
        elif params is None:
            params = init_params(model_cfg, engine_cfg.seed, self.device,
                                 self.dtype)
        elif quantized:
            # a tree quantized as it loaded (weights.load_params_auto) is
            # never quantized twice, and must be what the config asks
            held = tree_quantization(params)
            if held == "none":
                params = quantize_params(params, include_embed=qembed,
                                         bits=qbits)
            elif held != engine_cfg.quantization:
                raise ValueError(f"the weights are quantized as {held}, "
                                 f"the engine config asks for "
                                 f"{engine_cfg.quantization}")
        self.params = params
        # the weights on each distinct device of the sp mesh (one copy per
        # extra device; none on a mesh that repeats the engine's device)
        self._replicas = (replicate_params(params, mesh.devices)
                          if self._sp > 1 else None)
        self.kv = self.model_mod.init_kv_cache(
            model_cfg, engine_cfg.num_kv_blocks, engine_cfg.kv_block_size,
            self.device, self.dtype, quantization=engine_cfg.kv_quantization)
        # the KV tiers: a host pool behind the device pool (pinned on the
        # card, allocated at its first store) and a disk store under it,
        # fed by host evictions; on the card their copies run on a stream
        # of their own
        self._tier_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._wire_heads = wire_kv_heads(model_cfg,
                                         engine_cfg.kv_quantization)
        host_pool = None
        self.offload_engine = None
        self.disk_store = None
        self.spill_engine = None
        self._pending_spills: List[int] = []
        if engine_cfg.host_kv_blocks > 0:
            pool_t = next(iter(self.kv.values()))
            host_pool = make_host_pool(
                engine_cfg.host_kv_blocks, model_cfg,
                engine_cfg.kv_block_size, engine_cfg.kv_quantization,
                int(pool_t.shape[-1]), pool_t.dtype,
                pin_memory=self.device.type == "cuda")
        if engine_cfg.kv_disk_blocks > 0:
            self.disk_store = DiskKvStore(
                engine_cfg.kv_disk_dir, engine_cfg.kv_disk_blocks,
                expect_block_size=engine_cfg.kv_block_size)
            self.spill_engine = DiskSpillEngine(
                self.disk_store, on_commit=self._emit_kv_disk_store)
            host_pool.on_evict = self._on_host_evict
        # the remote (G4) tier under the disk: the object store the disk's
        # capacity evictions promote into (write-behind, acknowledged when
        # durable), shared with every worker on the same root; a fabric
        # (llm/kv/fabric.py, attach_kv_fabric) adds peer fetch at run time
        self.remote_store = None
        self.remote_spill_engine = None
        self.kv_fabric = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        if engine_cfg.kv_remote_dir:
            self.remote_store = RemoteKvStore(ObjectKvBackend(
                engine_cfg.kv_remote_dir, engine_cfg.kv_remote_blocks))
            self.remote_spill_engine = DiskSpillEngine(
                self.remote_store, on_commit=self._emit_kv_remote_store)
            self.disk_store.on_evict = self._on_disk_evict
        # the KV event stream for a KV-aware router
        # (llm/kv_router/publisher.py; the launcher's wire_kv_events sets
        # it), fed by the tier-aware pool hooks
        self.kv_event_publisher = None
        self.kv_manager = KvBlockManager(
            engine_cfg.num_kv_blocks, engine_cfg.kv_block_size,
            enable_reuse=engine_cfg.enable_prefix_reuse,
            on_stored=self._on_block_stored,
            on_removed=self._on_block_removed,
            host_pool=host_pool, disk_store=self.disk_store,
            remote_store=self.remote_store)
        if host_pool is not None:
            self.offload_engine = KvOffloadEngine(
                host_pool, engine_cfg.kv_block_size,
                get_kv=lambda: self.kv, num_heads=self._wire_heads,
                release_holds=self.kv_manager.pool.release,
                on_store=self._emit_kv_store, stream=self._tier_stream)
        # tier onboards whose off-loop read finished, (req, slot, plan,
        # h2d, remote values): h2d a Transfer, _NO_ONBOARD or None (the
        # read failed), the fetched remote values kept for a recorder or
        # None; and the tasks still reading
        self._onboards: List[tuple] = []
        self._onboard_tasks: set = set()
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
        # per-slot sampling parameters (set at admission, as in the JAX
        # engine; a vacated slot keeps its last values)
        self._samp = {
            "temperature": np.zeros((self.B,), np.float32),
            "top_k": np.zeros((self.B,), np.int64),
            "top_p": np.ones((self.B,), np.float32),
        }
        self._seeds = np.zeros((self.B,), np.int64)
        # the decode program (K steps per dispatch; a CUDA graph per K and
        # sampling variant on the card) and the pipelined dispatch whose
        # harvest is deferred one dispatch
        self.program = DecodeProgram(
            self.params, self.kv, model_cfg, engine_cfg.kv_block_size,
            self.B, self.M, max(engine_cfg.decode_steps_per_dispatch, 1),
            engine_cfg.seed, self.device)
        self._pending: Optional[dict] = None
        # the ragged program (a CUDA graph per row bucket and sampling
        # variant on the card) and the pipelined ragged dispatch whose
        # harvest is deferred one dispatch
        # (with speculation its row-sampled form: spec spans)
        self.ragged_program = (RaggedProgram(
            self.params, self.kv, model_cfg, engine_cfg.kv_block_size,
            self.B, self.M, engine_cfg.ragged_max_tokens,
            engine_cfg.ragged_max_seq_rows, engine_cfg.seed, self.device,
            row_sampled=engine_cfg.spec_k > 0)
            if engine_cfg.ragged_dispatch else None)
        self._ragged_pending: Optional[dict] = None
        # speculative decoding: the drafter, the live draft budget (within
        # [0, spec_k]: the verify program's rows are built at spec_k + 1 a
        # slot and never widen) and, on the split path, the verify program
        self.spec_k_live = engine_cfg.spec_k
        self.drafter = None
        self.verify_program = None
        if engine_cfg.spec_k > 0:
            self.drafter = PromptLookupDrafter(
                max_ngram=engine_cfg.spec_ngram_max,
                min_ngram=engine_cfg.spec_ngram_min,
                window=engine_cfg.spec_window)
            if not engine_cfg.ragged_dispatch:
                self.verify_program = VerifyProgram(
                    self.params, self.kv, model_cfg,
                    engine_cfg.kv_block_size, self.B, self.M,
                    engine_cfg.spec_k + 1, engine_cfg.seed, self.device)
        # engine/replay.py Recorder: the schedule's decision log (every
        # dispatch's host inputs in device order), None when off
        self.recorder = None
        # admissions whose first token is still on its way to the host:
        # (request, _FirstToken, its prefill's recorded pf_seq or None),
        # completed after the next decode dispatch
        self._admissions: List[tuple] = []
        # serving stats
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.preemptions = 0
        self.lane_admissions = 0
        # device→host fetches the engine loop has paid (decode harvests,
        # admission token fetches, one per batch of deferred admissions)
        # and the seconds it waited, counted as the JAX engine counts them
        self.host_roundtrips = 0
        self.host_stall_s = 0.0
        self.requests_cancelled_total = 0
        self.requests_deadline_exceeded_total = 0
        self.ragged_dispatches = 0
        self.ragged_rows_total = 0
        self.ragged_prefill_rows_total = 0
        self.ragged_decode_rows_total = 0
        self.ragged_mixed_dispatches = 0
        self.ragged_dispatches_saved = 0
        self.ragged_chained_dispatches = 0
        self.ragged_spec_rows = 0      # draft rows that rode ragged spans
        # KV tiers and defrag
        self.host_onboards = 0         # admissions onboarded from a tier
        self.disk_onboards = 0         # ... of which read from disk
        self.disk_onboarded_blocks = 0
        self.onboard_cold_retries = 0  # re-admitted cold after a failed read
        self.remote_onboards = 0       # ... with remote-tier blocks
        self.remote_fetch_failures = 0  # remote fetches that fell back
        self.prefill_published_blocks = 0  # publish_prefix_to_remote's puts
        # the measured prefill rate the fabric's admission gate prices
        # recompute with, age-weighted: each prefill admission's tokens
        # over its wall seconds from the admission's start (an onboard's
        # scatter included) to the prefill's return (its dispatch, on the
        # card), as the JAX engine measures it
        self.prefill_rate_estimator = PrefillRateEstimator()
        # disaggregation: the layer-stream onboards, with their seconds
        # scattering (hidden) and waiting on frames (exposed)
        self.disagg_stream_admits = 0
        self.disagg_stream_layers_scattered = 0
        self.disagg_stream_fallbacks = 0
        self.disagg_stream_hidden_s = 0.0
        self.disagg_stream_exposed_s = 0.0
        self._handoff_tasks: set = set()
        self._stream_tasks: set = set()
        self.defrag_passes = 0
        self._step = 0                 # decode steps dispatched (JAX's count)
        self._defrag_last_step = -(1 << 30)
        # speculation stats
        self.spec_dispatches = 0       # dispatches that verified drafts
        self.spec_drafted_tokens = 0   # drafts scored
        self.spec_accepted_tokens = 0  # drafts equal to their sample
        self.spec_emitted_tokens = 0   # tokens emitted by verifying rows
        # the flight recorder (GET /debug): a record a dispatch, and the
        # host seconds the loop spent outside device waits between them
        self.flight = FlightRecorder()
        register_recorder(self.flight)
        self._flight_prev_stall_s = 0.0
        self._flight_cycle_end = time.monotonic()

    # ------------------------------------------------------------- lifecycle
    def ensure_started(self) -> None:
        if self._dead is not None:
            raise RuntimeError(
                f"engine loop died: {self._dead!r} — create a new "
                f"EngineCore") from self._dead
        if self._loop_task is None or self._loop_task.done():
            self._stopping = False
            self._work_event = asyncio.Event()
            self._loop = asyncio.get_running_loop()
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run_loop(), name="engine-core-loop")
            self.flight.start_lag_probe()

    async def stop(self) -> None:
        self._stopping = True
        self.flight.stop_lag_probe()
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
        if self._admissions:              # finish deferred admissions
            self._complete_admissions()
        if self._onboard_tasks:           # in-flight tier reads
            for t in list(self._onboard_tasks):
                t.cancel()
            await asyncio.gather(*list(self._onboard_tasks),
                                 return_exceptions=True)
        # layer-stream onboards and handoff sends in flight
        tasks = list(self._stream_tasks) + list(self._handoff_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._onboards:                # release reserved onboards
            for req, slot, plan, _h2d, _rv in self._onboards:
                self.slots[slot] = None
                self.kv_manager.pool.release(plan.all_blocks)
                self._unpin_plan(plan)
                self._finish_request(req, FinishReason.CANCELLED)
            self._onboards = []
        if self._pending is not None:     # drain the pipelined dispatch
            self._harvest(self._pending)
            self._pending = None
        if self._ragged_pending is not None:  # the ragged form of same
            prev, self._ragged_pending = self._ragged_pending, None
            self._harvest_ragged(prev)
        if self.offload_engine is not None:
            await self.offload_engine.stop()
        if self.spill_engine is not None:
            # graceful persist: everything still host-resident goes to
            # disk, so the next engine on kv_disk_dir warm-starts with the
            # whole working set (kill -9 keeps what the pump acknowledged)
            try:
                await asyncio.wait_for(self.flush_host_to_disk(),
                                       timeout=120)
            except asyncio.TimeoutError:
                logger.warning("host→disk flush timed out on stop")
            await self.spill_engine.stop()
            self.disk_store.close()
        if self.remote_spill_engine is not None:
            # after the disk pump: the flush may have forced disk
            # evictions whose promotions are still queued
            await self.remote_spill_engine.stop()

    async def flush_host_to_disk(self) -> int:
        """Persist every host-resident block to the disk tier now and wait
        for the writes to be acknowledged (also run on ``stop``). Returns
        the number of blocks newly offered to the spill queue. Where the
        host holds more than the queue, the flush waits for room rather
        than drop (the JAX engine's flush drops past the queue)."""
        if self.spill_engine is None:
            return 0
        host = self.kv_manager.host_pool
        n = 0
        for h, th, ph, slot in host.resident_entries():
            if self.disk_store.contains(h):
                continue
            if not self.spill_engine.room():
                await self.spill_engine.drain()
            if self.spill_engine.offer(SpillJob(
                    seq_hash=h, tokens_hash=th, parent_hash=ph,
                    values=host.row_copy(slot))):
                n += 1
        await self.spill_engine.drain()
        return n

    async def submit(self, req: EngineRequest) -> None:
        if req.precomputed is not None:
            # validate (and repack, or stage on the card) the payload HERE:
            # the caller gets the error; a raise inside the engine loop's
            # admission would kill the loop
            req.precomputed = await self._prepare_payload(req.precomputed)
        self.ensure_started()
        self._inflight_reqs[id(req)] = req
        await self.waiting.put(req)
        self._work_event.set()

    def metrics(self) -> ForwardPassMetrics:
        total = self.cfg.num_kv_blocks - 1
        used = self.kv_manager.pool.used_blocks
        ragged = {}
        if self.ragged_dispatches:
            ragged = dict(
                ragged_fill_ratio=(self.ragged_rows_total
                                   / (self.ragged_dispatches
                                      * self.cfg.ragged_max_tokens)),
                ragged_mixed_ratio=(self.ragged_mixed_dispatches
                                    / self.ragged_dispatches),
                ragged_dispatches_saved_total=self.ragged_dispatches_saved,
                ragged_spec_rows_total=self.ragged_spec_rows)
        drafted, accepted = self.spec_drafted_tokens, self.spec_accepted_tokens
        pool = self.kv_manager.pool
        tiers = dict(kv_frag_ratio=pool.frag_ratio(),
                     kv_contig_runs=pool.contig_runs,
                     kv_contiguity_ratio=pool.contiguity_ratio(),
                     kv_defrag_moves_total=pool.defrag_moves_total)
        host = self.kv_manager.host_pool
        if host is not None:
            tiers.update(host_stored_total=host.stored_blocks_total,
                         host_evicted_total=host.evicted_blocks_total,
                         host_hit_rate=host.hit_rate(),
                         offload_dropped_jobs_total=self
                         .offload_engine.dropped_jobs_total)
        disk = self.disk_store
        if disk is not None:
            tiers.update(disk_used_blocks=disk.used_blocks,
                         disk_capacity_blocks=disk.capacity,
                         disk_stored_total=disk.stored_blocks_total,
                         disk_evicted_total=disk.evicted_blocks_total,
                         disk_hit_rate=disk.hit_rate(),
                         disk_bytes_used=disk.bytes_used,
                         disk_spill_dropped_total=self
                         .spill_engine.dropped_jobs_total,
                         disk_spill_shed_total=self
                         .spill_engine.shed_writes_total)
        if self.kv_fabric is not None:
            tiers.update(self.kv_fabric.metrics())
        elif self.remote_store is not None:
            rs = self.remote_store
            tiers.update(
                remote_used_blocks=rs.used_blocks,
                remote_capacity_blocks=rs.capacity,
                remote_peer_blocks=rs.peer_block_count(),
                remote_stored_total=rs.stored_blocks_total,
                remote_hit_rate=rs.hit_rate(),
                remote_fetch_failures_total=rs.fetch_failures_total,
                remote_admission_rejects_total=rs.admission_rejects_total)
        wall = self.disagg_stream_hidden_s + self.disagg_stream_exposed_s
        tiers.update(
            disagg_stream_layers_total=self.disagg_stream_layers_scattered,
            disagg_stream_fallbacks_total=self.disagg_stream_fallbacks,
            disagg_stream_overlap_ratio=(self.disagg_stream_hidden_s / wall
                                         if wall > 0 else 0.0),
            disagg_stream_layers=(self.model_cfg.num_layers
                                  if self.disagg_stream_admits > 0 else 0))
        return ForwardPassMetrics(
            request_active_slots=sum(1 for s in self.slots if s is not None),
            request_total_slots=self.B,
            kv_active_blocks=used,
            kv_total_blocks=total,
            num_requests_waiting=self.waiting.qsize(),
            gpu_cache_usage_perc=used / max(total, 1),
            gpu_prefix_cache_hit_rate=self.kv_manager.pool.hit_rate(),
            prefix_hit_blocks_total=self.kv_manager.pool.match_hits,
            requests_cancelled_total=self.requests_cancelled_total,
            requests_deadline_exceeded_total=self
            .requests_deadline_exceeded_total,
            kv_block_size=self.cfg.kv_block_size,
            kv_bytes_per_block=self.kv_bytes_per_block(),
            prefill_tok_per_s=self.measured_prefill_tok_per_s(),
            prefill_published_blocks_total=self.prefill_published_blocks,
            preemptions_total=self.preemptions,
            prefill_tokens_total=self.total_prefill_tokens,
            decode_tokens_total=self.total_decode_tokens,
            spec_drafted_total=drafted, spec_accepted_total=accepted,
            spec_acceptance_rate=accepted / drafted if drafted else 0.0,
            spec_accepted_per_step=(accepted / self.spec_dispatches
                                    if self.spec_dispatches else 0.0),
            **ragged, **tiers)

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
        self._pending = None
        self._ragged_pending = None
        self._admissions = []
        for req, _slot, plan, _h2d in self._onboards:
            self.kv_manager.pool.release(plan.all_blocks)
            self._unpin_plan(plan)
        self._onboards = []
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
            # 0) idle defrag: only when nothing waits and no dispatch is
            # un-harvested (the pass puts one device copy ahead of the
            # next dispatch)
            if (self.waiting.empty() and self._pending is None
                    and self._ragged_pending is None):
                self._maybe_defrag()
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
            # 2) one decode step (or ragged dispatch) for every ready slot
            if any(s is not None and s.ready for s in self.slots):
                if self.cfg.ragged_dispatch:
                    self._ragged_step()
                else:
                    self._decode_step()
                progressed = True
            elif self._pending is not None:
                # every request finished mid-harvest with a chained dispatch
                # still in flight: drain it so the dead requests and its
                # buffers are not held across an idle period
                self._harvest(self._pending)
                self._pending = None
                progressed = True
            elif self._ragged_pending is not None:
                # the same drain for a pipelined ragged dispatch
                prev, self._ragged_pending = self._ragged_pending, None
                self._harvest_ragged(prev)
                progressed = True
            # 3) deferred admissions: their copies overlapped step 2
            if self._admissions:
                self._complete_admissions()
                progressed = True
            # 4) tier onboards whose off-loop read has finished
            if self._onboards:
                self._complete_onboards()
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
        before taking a slot, and their ready slots are vacated at once —
        unless a pipelined dispatch is in flight, whose harvest finishes
        them (a deferred admission finishes when it completes)."""
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
        if self._pending is None and self._ragged_pending is None:
            for req in list(self.slots):
                if req is not None and req.ready and req.cancelled:
                    self._release_slot(req)
                    self._finish_request(req, FinishReason.CANCELLED)
                    progressed = True
        return progressed

    # --------------------------------------------------------------- defrag
    def _maybe_defrag(self) -> bool:
        """Idle compaction (the JAX engine's pass): when fragmentation
        exceeds ``kv_defrag_threshold``, move the worst-fragmented resident
        sequence's movable block suffix into a free run: a device copy in
        place (``block_copy.move_blocks``) and ``pool.relocate``, so hash
        registrations and refcounts follow the blocks. Only blocks owned
        by ONE sequence move, targets come from the uninit free space only
        (no cached prefix is evicted), the pass is skipped while a replay
        recorder is attached, and it runs at most once per 64 decode
        steps. The block table is uploaded at every dispatch, so rewriting
        the slot's mirror row is enough for the graphed programs."""
        cfg = self.cfg
        if (cfg.kv_defrag_threshold <= 0
                or self.recorder is not None
                or self._step - self._defrag_last_step < 64):
            return False
        pool = self.kv_manager.pool
        thr = cfg.kv_defrag_threshold
        pool_frag = pool.frag_ratio()
        best = None   # (runs, seq_frag, slot, suffix_start, suffix)
        for i, req in enumerate(self.slots):
            if req is None or not req.ready or len(req.blocks) < 2:
                continue
            rcs = pool.refcounts(req.blocks)
            j = len(req.blocks)
            while j > 0 and rcs[j - 1] == 1:
                j -= 1
            suffix = req.blocks[j:][:cfg.kv_defrag_max_blocks]
            if len(suffix) < 2:
                continue
            runs = pool.count_runs(suffix)
            if runs < 2:
                continue
            seq_frag = (runs - 1) / (len(suffix) - 1)
            if pool_frag <= thr and seq_frag <= thr:
                continue
            if best is None or runs > best[0]:
                best = (runs, seq_frag, i, j, suffix)
        if best is None or pool.free_uninit_blocks < len(best[4]):
            return False
        runs, _seq_frag, slot, j, old = best
        new = pool.alloc_uninit(len(old))
        if new is None:
            return False
        if pool.count_runs(new) >= runs:
            pool.release(new)       # no layout win — don't thrash
            return False
        with torch.inference_mode():
            move_blocks(self.kv, old, new, cfg.kv_block_size)
        pool.relocate(zip(old, new))
        req = self.slots[slot]
        req.blocks[j:j + len(old)] = new
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(req.blocks)] = req.blocks
        self.defrag_passes += 1
        self._defrag_last_step = self._step
        self.flight.record("defrag", moved=len(old), runs_before=runs)
        logger.debug("defrag: slot %d moved %d blocks (%d runs → %d), "
                     "pool frag %.2f", slot, len(old), runs,
                     pool.count_runs(new), pool_frag)
        return True

    # ---------------------------------------------------------------- admit
    def _try_admit(self, req: EngineRequest, slot: int) -> bool:
        plan = self.kv_manager.prepare_prefill(req.prompt, seq=req.seq,
                                               cold=req.cold_admission)
        if plan is None:
            return False
        if len(plan.all_blocks) > self.M:
            # longer than a block table row — reject rather than overflow
            self.kv_manager.abort_plan(plan)
            self._finish_request(req, FinishReason.LENGTH)
            return True
        if plan.host_slots or plan.disk_hashes or plan.remote_hashes:
            # host / disk / remote tier hits: the reads run off the loop,
            # and the admission completes once they have (the batch keeps
            # decoding meanwhile)
            self._start_onboard(req, slot, plan)
            return True
        self._admit_with_plan(req, slot, plan)
        return True

    def _unpin_plan(self, plan) -> None:
        """Release the tier pins an onboard held: its host slots (pinned
        at the onboard's start), its disk and remote hashes (pinned at
        the match)."""
        if self.kv_manager.host_pool is not None:
            self.kv_manager.host_pool.unpin(plan.host_slots)
        if plan.disk_hashes and self.disk_store is not None:
            self.disk_store.unpin(plan.disk_hashes)
        if plan.remote_hashes and self.remote_store is not None:
            self.remote_store.unpin(plan.remote_hashes)

    def _fetch_remote(self, req: EngineRequest, plan, timing: dict):
        """The plan's remote blocks (per-block dicts), read off the loop
        from the object store or a peer. A fetch that fails (a peer gone,
        a torn object or frame) is not an error: the remote tail leaves
        the plan, unpinned, and the prefill recomputes those tokens."""
        t0 = time.monotonic()
        try:
            return self.remote_store.fetch_blocks(plan.remote_hashes)
        except Exception:  # noqa: BLE001
            logger.warning("remote KV fetch of %d block(s) failed for %s — "
                           "recomputing the tail", len(plan.remote_hashes),
                           req.rid, exc_info=True)
            self.remote_fetch_failures += 1
            self.remote_store.unpin(plan.remote_hashes)
            plan.remote_hashes = []
            return []
        finally:
            timing["fabric_fetch_ms"] = round(1e3 * (time.monotonic() - t0),
                                              3)

    def _read_tier_rows(self, plan, remote_blocks=()) -> Optional[dict]:
        """The plan's host rows, then its disk rows, then its remote
        blocks, ``{key: [n, L, H, bs, D]}`` in one staging buffer per key
        (pinned on the card); None when there are none. Runs off the
        loop: the host slots and disk hashes are pinned."""
        host = self.kv_manager.host_pool
        nh = len(plan.host_slots)
        cold = ([self.disk_store.read_block(h) for h in plan.disk_hashes]
                + list(remote_blocks))
        n = nh + len(cold)
        if n == 0:
            return None
        template = ({k: a[0] for k, a in host._arena.items()} if nh
                    else cold[0])
        pin = self.device.type == "cuda"
        rows = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                               pin_memory=pin)
                for k, v in template.items()}
        if nh:
            host.fetch_rows(plan.host_slots,
                            out={k: v[:nh] for k, v in rows.items()})
        for i, b in enumerate(cold):
            for k, v in b.items():
                rows[k][nh + i].copy_(v)
        return rows

    def _start_onboard(self, req: EngineRequest, slot: int, plan) -> None:
        """Reserve the slot and read the plan's host, disk and remote rows
        off the loop: a thread fetches the remote blocks (the object
        store, or a peer through the fabric, whose loop this is not
        waiting on), fills a pinned staging buffer and copies it to the
        card on the tier stream (waiting for the copy there, not on the
        loop); the loop's onboard step then scatters and admits. The host
        slots are pinned here, the disk and remote hashes were pinned at
        the match; all unpin in _complete_onboards, after the copy has
        run.

        The flight recorder's ``onboard`` record, written when the read
        ends, carries its window: ``t_start`` (the reservation) to ``t``,
        the remote fetch's, the read's and the host→device copy's
        milliseconds (``h2d_copy_ms`` the copy's own on the card) and the
        bytes copied."""
        req.slot = slot
        req.ready = False
        self.slots[slot] = req            # reserve (skipped by dispatch)
        self.host_onboards += 1
        if plan.disk_hashes:
            self.disk_onboards += 1
            self.disk_onboarded_blocks += len(plan.disk_hashes)
        if plan.remote_hashes:
            self.remote_onboards += 1
        n_remote = len(plan.remote_hashes)
        self.kv_manager.host_pool.pin(plan.host_slots)
        t_start = time.time()
        timing = {}
        # the recorder's kv_remote_restore event carries the fetched bytes
        kept: dict = {}

        def prep():
            remote_blocks = (self._fetch_remote(req, plan, timing)
                             if plan.remote_hashes else [])
            if remote_blocks and self.recorder is not None:
                kept["values"] = stack_wire(remote_blocks)
            t0 = time.monotonic()
            rows = self._read_tier_rows(plan, remote_blocks)
            if rows is None:
                return _NO_ONBOARD   # every tier hit fell away: no copy
            t1 = time.monotonic()
            h2d = start_h2d(rows, self.device, stream=self._tier_stream)
            h2d.wait()
            copy_s = h2d.copy_s()
            timing.update(
                read_ms=round(1e3 * (t1 - t0), 3),
                h2d_ms=round(1e3 * (time.monotonic() - t1), 3),
                h2d_copy_ms=None if copy_s is None else 1e3 * copy_s,
                h2d_bytes=h2d.nbytes)
            return h2d

        async def prepare() -> None:
            h2d = None
            t0 = time.monotonic()
            try:
                h2d = await asyncio.to_thread(prep)
            except asyncio.CancelledError:
                raise      # stop(): the finally records the dead onboard
            except Exception:  # noqa: BLE001
                logger.exception("tier onboard read failed for %s", req.rid)
            finally:
                self.flight.record(
                    "onboard", rid=req.rid, host_blocks=len(plan.host_slots),
                    disk_blocks=len(plan.disk_hashes),
                    remote_blocks=len(plan.remote_hashes),
                    remote_failed=n_remote - len(plan.remote_hashes),
                    t_start=t_start,
                    total_ms=round(1e3 * (time.monotonic() - t0), 3),
                    **timing)
                self._onboards.append((req, slot, plan, h2d,
                                       kept.get("values")))
                self._work_event.set()

        task = asyncio.get_running_loop().create_task(
            prepare(), name=f"kv-onboard-{req.rid}")
        self._onboard_tasks.add(task)
        task.add_done_callback(self._onboard_tasks.discard)

    def _complete_onboards(self) -> None:
        pending, self._onboards = self._onboards, []
        for req, slot, plan, h2d, remote_values in pending:
            self.slots[slot] = None       # _admit_with_plan re-reserves
            try:
                if req.cancelled or h2d is None:
                    self.kv_manager.pool.release(plan.all_blocks)
                    if req.cancelled:
                        self._finish_request(req, FinishReason.CANCELLED)
                    elif not req.cold_admission:
                        # a tier read failed (a dead disk, a torn file):
                        # re-admit COLD, skipping the tier cascade — a
                        # broken cache tier degrades to recompute, never to
                        # a failed request
                        self.onboard_cold_retries += 1
                        req.cold_admission = True
                        req.slot = -1
                        req.ready = True
                        logger.warning("onboard read failed for %s — "
                                       "retrying as a cold admission",
                                       req.rid)
                        self.waiting.put_nowait(req)
                        self._work_event.set()
                    else:
                        self._finish_request(req, FinishReason.ERROR)
                    continue
                self._admit_with_plan(
                    req, slot, plan, None if h2d is _NO_ONBOARD else h2d,
                    remote_values=remote_values)
            finally:
                # the host→device copy has run (the read thread waited for
                # it): the tier rows may go now (a failed remote fetch
                # already unpinned and cleared its hashes)
                self._unpin_plan(plan)

    def _emit_kv_store(self, items: list) -> None:
        """Offload-pump commit hook → the recorder: a mirror gathers the
        same device blocks from its own pool and applies these literal
        placements (``replay.exec_kv_store_event``). ``spills`` lists the
        evicted hashes this batch handed to the disk spill queue."""
        spills, self._pending_spills = self._pending_spills, []
        if self.recorder is not None:
            self.recorder.rec("kv_store", items=items, spills=spills)

    def _on_host_evict(self, seq_hash: int, tokens_hash, parent_hash,
                       values: dict) -> None:
        """Host-pool eviction hook (on the loop, inside the offload pump's
        store, with a fresh copy of the arena row): offer the block to the
        disk spill queue — write-behind, never stalling the loop."""
        accepted = self.spill_engine.offer(SpillJob(
            seq_hash=seq_hash, tokens_hash=tokens_hash,
            parent_hash=parent_hash, values=values))
        if accepted:
            self._pending_spills.append(seq_hash)

    def _emit_kv_disk_store(self, items: list) -> None:
        """Spill-pump commit hook: [(hash, tokens_hash, parent, evicted)]
        a durably acknowledged put, to the recorder (a mirror applies the
        literal placements, ``replay.exec_kv_disk_store_event``), and to
        the router's radix index: the spilled prefixes announce with a
        "disk" tier tag unless the hash is still device-registered (its
        device announce stands at full weight), and the disk's evictions
        announce their removal (``_publish_tier_removed``)."""
        if self.recorder is not None:
            self.recorder.rec("kv_disk_store", items=items)
        pub = self.kv_event_publisher
        if pub is None:
            return
        for h, th, ph, evicted in items:
            for gone in evicted:
                self._publish_tier_removed(gone)
            if not self.kv_manager.pool.peek_prefix([h]):
                pub.publish_stored(-1, h, th, ph, tier="disk")

    def _on_disk_evict(self, seq_hash: int, tokens_hash, parent_hash,
                       values: dict) -> None:
        """Disk capacity-eviction hook: offer the block to the remote
        tier's promotion pump, so a prefix leaving this worker's disk
        survives in the object store. It fires on the spill pump's thread:
        the offer hops to the loop."""
        if self.remote_spill_engine is None or self._loop is None:
            return
        job = SpillJob(seq_hash=seq_hash, tokens_hash=tokens_hash,
                       parent_hash=parent_hash, values=values)
        try:
            self._loop.call_soon_threadsafe(self.remote_spill_engine.offer,
                                            job)
        except RuntimeError:
            pass                           # the loop is closed (shutdown)

    def _emit_kv_remote_store(self, items: list) -> None:
        """Remote promotion commit hook: [(hash, tokens_hash, parent,
        evicted)] a durably acknowledged object put. Announces the
        promoted prefixes with tier "remote", unless a warmer tier still
        holds the hash (its announce stands at a better weight)."""
        pub = self.kv_event_publisher
        if pub is None:
            return
        host = self.kv_manager.host_pool
        for h, th, ph, evicted in items:
            for gone in evicted:
                self._publish_tier_removed(gone)
            if self.kv_manager.pool.peek_prefix([h]):
                continue
            if host is not None and host.contains(h):
                continue
            if self.disk_store is not None and self.disk_store.contains(h):
                continue
            pub.publish_stored(-1, h, th, ph, tier="remote")

    def attach_kv_fabric(self, fabric) -> None:
        """Wire an attached fleet fabric (``llm/kv/fabric.py``): its
        RemoteKvStore (this engine's own when ``kv_remote_dir`` built one)
        becomes the cascade's remote rung."""
        self.kv_fabric = fabric
        self.remote_store = fabric.store
        self.kv_manager.remote_store = fabric.store

    def kv_bytes_per_block(self) -> int:
        """The bytes one KV block holds over all layers and keys: the
        admission gate's and the router's transfer unit."""
        total = sum(v.numel() * v.element_size() for v in self.kv.values())
        return max(total // max(self.cfg.num_kv_blocks, 1), 1)

    def measured_prefill_tok_per_s(self) -> float:
        """The measured, age-weighted prefill rate (the gate's recompute
        side); 0.0 while unknown (the gate then admits)."""
        return self.prefill_rate_estimator.rate()

    async def publish_prefix_to_remote(self, seq) -> int:
        """Prefill-as-a-service's publish (``components/prefill_service
        .py``): every still-registered full block of ``seq``'s chain goes
        from the device pool to the object store, keyed by the chained
        hashes every tier uses; any engine on the same root then admits
        the prefix through its cascade. The gather is dispatched on the
        loop (on the compute stream, before any later replay writes the
        pool); the fetch to the host (on the tier stream), the packing and
        the object puts run off the loop. A block the store already holds
        is skipped. Returns the blocks written."""
        rs = self.remote_store
        if rs is None or rs.object is None:
            return 0
        pool = self.kv_manager.pool
        # holds on the longest still-registered run: not evicted under
        # the gather
        bids = pool.match_prefix(seq.sequence_hashes)
        if not bids:
            return 0
        hashes = seq.sequence_hashes
        try:
            with torch.inference_mode():
                gathered = gather_blocks_dispatch(self.kv, bids,
                                                  self.cfg.kv_block_size)

            def publish_all() -> int:
                values = fetch_wire(gathered, len(bids), self._wire_heads,
                                    stream=self._tier_stream)
                n = 0
                for i in range(len(bids)):
                    if rs.object.contains(hashes[i]):
                        continue           # content-addressed: written
                    try:
                        rs.put(hashes[i],
                               {k: v[:, :, i] for k, v in values.items()},
                               tokens_hash=seq.block_hashes[i],
                               parent_hash=hashes[i - 1] if i else None)
                    except OSError as e:
                        # a refusing object store forfeits this block's
                        # publish: decode fleets recompute it
                        logger.warning("prefix publish of %x failed: %s",
                                       hashes[i] & 0xFFFFFFFFFFFFFFFF, e)
                        continue
                    n += 1
                return n

            n = await asyncio.to_thread(publish_all)
        finally:
            pool.release(bids)
        self.prefill_published_blocks += n
        return n

    # ------------------------------------------------------ KV event stream
    def reannounce_kv(self) -> int:
        """Replay every stored-block announcement into the KV event
        publisher: the lease-reclaim recovery hook (after a transient
        lease expiry the router wiped this worker's radix index; the
        reclaim replays discovery keys but not content events, so the pool
        re-announces them, parents first), and the bring-up announce of a
        warm-started disk tier (prefixes the device pool has never seen,
        tier-tagged, so the router can route matching prompts here)."""
        if self.kv_event_publisher is None:
            return 0
        n = self.kv_manager.pool.reannounce(
            self.kv_event_publisher.publish_stored)
        if self.disk_store is not None:
            for h, th, ph in self.disk_store.registered_entries():
                if not self.kv_manager.pool.peek_prefix([h]):
                    self.kv_event_publisher.publish_stored(
                        -1, h, th, ph, tier="disk")
                    n += 1
        # the object store's blocks this worker can fetch back (peer-held
        # hashes are the peer's to announce)
        if self.remote_store is not None:
            for h, th, ph in self.remote_store.registered_entries():
                if (not self.kv_manager.pool.peek_prefix([h])
                        and not (self.disk_store is not None
                                 and self.disk_store.contains(h))):
                    self.kv_event_publisher.publish_stored(
                        -1, h, th, ph, tier="remote")
                    n += 1
        return n

    def _publish_tier_removed(self, seq_hash: int) -> None:
        """Removed-from-disk announce, suppressed while a warmer tier
        still holds the hash (the router would otherwise lose a prefix
        this worker can still serve); a block the object store holds
        re-announces with tier "remote" instead."""
        pub = self.kv_event_publisher
        if pub is None:
            return
        host = self.kv_manager.host_pool
        if self.kv_manager.pool.peek_prefix([seq_hash]):
            return
        if host is not None and host.contains(seq_hash):
            return
        if (self.remote_store is not None
                and self.remote_store.holds_durable(seq_hash)):
            pub.publish_stored(-1, seq_hash, None, None, tier="remote")
            return
        pub.publish_removed([seq_hash])

    def _on_block_stored(self, bid: int, seq_hash: int, tokens_hash: int,
                         parent_hash) -> None:
        """Device-pool stored hook → router event (tier "device")."""
        if self.kv_event_publisher is not None:
            self.kv_event_publisher.publish_stored(
                bid, seq_hash, tokens_hash, parent_hash)

    def _on_block_removed(self, seq_hashes: list) -> None:
        """Device-pool removed hook. A hash still resident in a colder
        tier is re-announced with that tier's tag instead of removed: the
        router's radix index keeps the prefix visible at a discounted
        depth (kv_router/scoring.py TIER_WEIGHTS) rather than forgetting
        that this worker can still serve it without recompute."""
        pub = self.kv_event_publisher
        if pub is None:
            return
        host = self.kv_manager.host_pool
        gone = []
        for h in seq_hashes:
            if host is not None and host.contains(h):
                th, ph = host.meta_for(h)
                pub.publish_stored(-1, h, th, ph, tier="host")
            elif self.disk_store is not None and self.disk_store.contains(h):
                pub.publish_stored(-1, h, None, None, tier="disk")
            elif (self.remote_store is not None
                  and self.remote_store.holds_durable(h)):
                pub.publish_stored(-1, h, None, None, tier="remote")
            else:
                gone.append(h)
        if gone:
            pub.publish_removed(gone)

    def _sample_device(self, logits: torch.Tensor,
                       reqs: List[Optional[EngineRequest]]) -> tuple:
        """Sample one token per row of ``logits`` [B, V] with each row's
        request parameters, keyed on the host at the request's
        ``key_step`` (``sample_keyed``). None rows sample greedily and are
        ignored. Returns (tokens, logprobs) on the engine's device."""
        return sample_keyed(
            logits, self.cfg.seed,
            [(0.0, 0, 1.0, 0, 0) if r is None else
             (r.sampling.temperature, r.sampling.top_k, r.sampling.top_p,
              r.sampling.seed, r.key_step) for r in reqs], self.device)

    def _rec_prefill(self, kind: str, req: EngineRequest, slot: int,
                     padded: np.ndarray, table: np.ndarray, true_len: int,
                     start_pos: Optional[int] = None) -> int:
        """Record one prefill event (``prefill``, or ``prefill_sp``, which
        has no start_pos): whole-prompt admissions and each chunk of a
        chunked one. Returns its pf_seq."""
        pf = self.recorder.next_dispatch_id()
        extra = {} if start_pos is None else {"start_pos": start_pos}
        self.recorder.rec(
            kind, pf_seq=pf, rid=req.rid, slot=slot, padded=padded.copy(),
            table=table.copy(), true_len=true_len, **extra,
            samp_seed=req.sampling.seed, key_step=req.key_step,
            temp=req.sampling.temperature, top_k=req.sampling.top_k,
            top_p=req.sampling.top_p)
        return pf

    def _admit_with_plan(self, req: EngineRequest, slot: int, plan,
                         onboard=None, remote_values=None) -> None:
        n_prompt = len(req.prompt)
        t0 = time.monotonic()
        req.slot = slot
        req.blocks = plan.all_blocks
        req.seq = plan.seq
        n_host = len(plan.host_slots)
        n_hd = n_host + len(plan.disk_hashes)
        n_onboard = n_hd + len(plan.remote_hashes)
        if n_onboard:
            # tier hits: scatter the onboarded rows (on the card already,
            # ``onboard``) into their device blocks in place, on the
            # compute stream after the copy, before the prefill
            targets = plan.new_blocks[:n_onboard]
            with torch.inference_mode():
                scatter_transfer(self.kv, targets, onboard,
                                 self.cfg.kv_block_size)
            # the onboarded blocks now hold valid registered content
            n_dev = len(plan.hit_blocks)
            for i, bid in enumerate(targets):
                j = n_dev + i
                parent = plan.seq.sequence_hashes[j - 1] if j > 0 else None
                self.kv_manager.pool.register(
                    bid, plan.seq.sequence_hashes[j],
                    plan.seq.block_hashes[j], parent)
        req.prefix_hit_tokens = (plan.hit_tokens + plan.host_hit_tokens
                                 + plan.disk_hit_tokens
                                 + plan.remote_hit_tokens)
        n_already = len(plan.hit_blocks) + n_onboard
        suffix_len = n_prompt - req.prefix_hit_tokens
        if self.recorder is not None and req.prefix_hit_tokens > 0:
            if plan.remote_hashes:
                # the fleet-shared tier cannot be re-walked by a replay:
                # the restore is an event of its own with the fetched
                # hashes and bytes, before hit_transfer, so the replayed
                # scatter gives the remote targets their writer before
                # the hit walk reads them (replay.
                # exec_kv_remote_restore_event; fetch-or-bytes)
                if remote_values is None:
                    raise RuntimeError(
                        "recorded remote onboarding without captured "
                        "fetch values")
                self.recorder.rec(
                    "kv_remote_restore", rid=req.rid,
                    remote_hashes=list(plan.remote_hashes),
                    remote_targets=list(plan.new_blocks[n_hd:n_onboard]),
                    values=remote_values)
            # before the prefill's record: read rights over the shared
            # prefix, and for a tier hit the slots / hashes and targets a
            # mirror restores from (replay.exec_host_restore_event)
            self.recorder.rec(
                "hit_transfer", rid=req.rid, hit=req.prefix_hit_tokens,
                host_hit=plan.host_hit_tokens, disk_hit=plan.disk_hit_tokens,
                blocks=list(plan.all_blocks),
                host_slots=list(plan.host_slots),
                host_targets=list(plan.new_blocks[:n_host]),
                disk_hashes=list(plan.disk_hashes),
                disk_targets=list(plan.new_blocks[n_host:n_hd]))
        # disaggregated admissions keep the prefill program (the JAX
        # engine's rule): a handoff gathers the prompt's blocks after its
        # prefill, and a precomputed admission scatters them instead
        disagg = req.handoff is not None or req.precomputed is not None
        if self.cfg.ragged_dispatch and suffix_len > 0 and not disagg:
            # ragged serving: every admission rides the ragged batch as a
            # prefill lane — no prefill dispatch of its own
            self._admit_lane(req, slot, n_already)
            return
        if (self.cfg.lane_prefill_max_tokens > 0
                and self.cfg.decode_steps_per_dispatch > 1
                and 0 < suffix_len <= self.cfg.lane_prefill_max_tokens
                and not disagg
                and any(s is not None and s.ready for s in self.slots)):
            # lane prefill: the engine is already decoding — ride the
            # decode batch instead of stalling it with a prefill dispatch
            self._admit_lane(req, slot, n_already)
            return
        remote = req.precomputed is not None
        pf_seq, use_sp = None, False
        if remote:
            pc = req.precomputed
            if isinstance(pc, LayerStreamPayload):
                # a layer stream, arrived or still arriving: reserve the
                # slot now and scatter each layer as it lands, staged on
                # the tier stream off the loop (_stream_onboard; the JAX
                # engine admits a stream that landed whole as one payload)
                self._admit_stream(req, slot, plan, n_already, t0)
                return
            with torch.inference_mode():
                toks, logprobs = self._admit_precomputed(req, n_already)
        else:
            toks, logprobs, pf_seq, use_sp = self._prefill(req, slot)
            self.total_prefill_tokens += suffix_len
            # the admission gate's recompute rate (the JAX engine's wall:
            # from the plan to the dispatched prefill)
            self.prefill_rate_estimator.observe(suffix_len,
                                                time.monotonic() - t0)
        # the first token: a handoff ships it as it is (the device plane's
        # stays on the card); a device tensor's fetch is deferred past the
        # next decode dispatch (overlap_admission_fetch), or waited for now
        defer = False
        if req.handoff is not None:
            pass
        elif not isinstance(toks, torch.Tensor):
            tok, logprob = int(toks), float(logprobs)
        elif self.cfg.overlap_admission_fetch:
            defer = True
            first = _FirstToken(toks, logprobs)
        else:
            self.host_roundtrips += 1
            t_fetch = time.monotonic()
            tok, logprob = int(toks[0]), float(logprobs[0])
            self.host_stall_s += time.monotonic() - t_fetch
        req.pos = n_prompt
        req.generated = 1
        req.key_step += 1
        # the prompt's full blocks now hold valid KV — register for reuse
        req.registered_blocks = self.kv_manager.register_full_blocks(
            req.blocks, plan.seq, already_registered=n_already)
        if self.recorder is not None:
            self.recorder.rec(
                "admit", rid=req.rid, slot=slot, pos=req.pos,
                key_step=req.key_step, blocks=list(req.blocks),
                hit=req.prefix_hit_tokens, prompt=list(req.prompt))
        if req.handoff is not None:
            self._handoff_and_finish(req, toks, logprobs)
            return
        if defer:
            req.ready = False
            req.last_token = -1
            self._admissions.append((req, first, pf_seq))
        else:
            req.last_token = tok
            if self.recorder is not None:
                self.recorder.rec("first_token", rid=req.rid,
                                  pf_seq=pf_seq, tok=tok)
        self.slots[slot] = req
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(req.blocks)] = req.blocks
        self._set_slot_sampling(slot, req)
        logger.debug("admitted %s into slot %d (prompt=%d, hit=%d+%dhost+"
                     "%ddisk+%dremote, sp=%s, precomputed=%s, %.1fms)",
                     req.rid, slot, n_prompt, plan.hit_tokens,
                     plan.host_hit_tokens, plan.disk_hit_tokens,
                     plan.remote_hit_tokens, use_sp, remote,
                     1e3 * (time.monotonic() - t0))
        self._record_prefill(req, plan, suffix_len, remote, t0)
        if req.ready:
            self._emit(req, tok, logprob)
            self._maybe_finish_after_emit(req)

    def _prefill(self, req: EngineRequest, slot: int) -> tuple:
        """The admission's prefill of the prompt's un-matched suffix (the
        prefix KV is already in the pool's blocks: the TTFT win of prefix
        reuse), whole, chunked or sequence-parallel; its sampled first
        token. Returns (tokens [1], logprobs [1] on the device, the
        recorded pf_seq or None, whether it ran sequence-parallel)."""
        chunk = req.prompt[req.prefix_hit_tokens:]
        bucket = self.cfg.bucket_for(len(chunk))
        table = np.zeros((self.M,), np.int32)
        table[:len(req.blocks)] = req.blocks
        padded = np.zeros((bucket,), np.int64)
        padded[:len(chunk)] = chunk
        # sequence-parallel prefill for long cold prompts, on the JAX
        # engine's conditions: the ring has neither soft-caps nor windows
        use_sp = (self._sp > 1
                  and req.prefix_hit_tokens == 0
                  and len(chunk) >= self.cfg.sp_min_prefill_tokens
                  and bucket % self._sp == 0
                  and not self.model_cfg.attn_logit_softcap
                  and self.model_cfg.sliding_window is None)
        chunked = (not use_sp and self.cfg.prefill_chunk > 0
                   and len(chunk) > self.cfg.prefill_chunk)
        pf_seq = None
        if self.recorder is not None and not chunked:
            pf_seq = (self._rec_prefill("prefill_sp", req, slot, padded,
                                        table, len(chunk)) if use_sp
                      else self._rec_prefill("prefill", req, slot, padded,
                                             table, len(chunk),
                                             req.prefix_hit_tokens))
        with torch.inference_mode():
            tokens = torch.from_numpy(padded).to(self.device)
            table_t = torch.from_numpy(table).to(self.device)
            if use_sp:
                logits = self.model_mod.prefill_forward_sp(
                    self.params, self.kv, tokens, table_t, len(chunk),
                    self.model_cfg, self.cfg.kv_block_size, self.mesh,
                    replicas=self._replicas)
            elif chunked:
                logits, pf_seq = self._chunked_prefill(req, chunk, table,
                                                       table_t, slot)
            else:
                logits = self.model_mod.prefill_forward(
                    self.params, self.kv, tokens, table_t,
                    req.prefix_hit_tokens, len(chunk), self.model_cfg,
                    self.cfg.kv_block_size)
            toks, logprobs = self._sample_device(logits[None, :], [req])
        return toks, logprobs, pf_seq, use_sp

    def _record_prefill(self, req: EngineRequest, plan, planned: int,
                        precomputed: bool, t0: float) -> None:
        """The admission's ``prefill`` flight record."""
        now = time.monotonic()
        self.flight.record(
            "prefill", rid=req.rid, prompt=len(req.prompt),
            planned_tokens=planned,
            batch_fill=sum(1 for s in self.slots if s is not None),
            hit_device=plan.hit_tokens, hit_host=plan.host_hit_tokens,
            hit_disk=plan.disk_hit_tokens,
            hit_remote=plan.remote_hit_tokens,
            precomputed=precomputed, host_ms=round(1e3 * (now - t0), 3),
            queue_wait_ms=round(1e3 * (t0 - req.enqueue_time), 3))

    # -------------------------------------------------------- disaggregation
    @property
    def wire_kv_heads(self) -> int:
        """Head count of the KV wire format (``block_copy.wire_kv_heads``:
        one opaque head for int8 and latent rows)."""
        return self._wire_heads

    def _check_kv_payload_layout(self, lanes: int, dtype,
                                 kind: str) -> None:
        """A disaggregated KV payload must match this pool's row layout
        exactly: the same lane width and dtype. Device-plane payloads of
        another ``kv_quantization`` were repacked before this check;
        anything still mismatched (wire-plane cross-quant) fails loudly."""
        if not isinstance(dtype, torch.dtype):
            dtype = torch_dtype(np.dtype(dtype).name)
        pool = next(iter(self.kv.values()))   # llama {"k","v"}, MLA {"kv"}
        if lanes != pool.shape[-1] or dtype != pool.dtype:
            raise ValueError(
                f"disagg {kind} KV payload layout mismatch: payload rows "
                f"have {lanes} lanes of {dtype}, this pool has "
                f"{pool.shape[-1]} lanes of {pool.dtype} — prefill and "
                f"decode engines must share kv_quantization")

    def _check_layer_stream_layout(self, manifest) -> None:
        """A layer stream's manifest announces the geometry before any
        bulk frame: validated like a monolithic payload, plus the layer
        count and the block size."""
        h, _n, bs, d = (list(manifest.shape) + [0, 0, 0, 0])[:4]
        self._check_kv_payload_layout(h * d, torch_dtype(manifest.dtype),
                                      "wire")
        pool = next(iter(self.kv.values()))
        if manifest.num_layers != pool.shape[0]:
            raise ValueError(
                f"disagg wire KV payload layout mismatch: layer stream "
                f"announces {manifest.num_layers} layers, this pool has "
                f"{pool.shape[0]}")
        if bs != self.cfg.kv_block_size:
            raise ValueError(
                f"disagg wire KV payload layout mismatch: layer stream "
                f"block size {bs} != pool block size "
                f"{self.cfg.kv_block_size}")

    def _repack_needed(self, pc: DeviceKvPayload) -> bool:
        """Whether a device-plane payload needs the cross-quant repack: its
        rows are int8 and this pool's are not, or the reverse. Two int8
        layouts of different widths are refused."""
        pool = next(iter(self.kv.values()))
        sample = next(iter(pc.stacked.values()))
        if (sample.shape[-1] == pool.shape[-1]
                and sample.dtype == pool.dtype):
            return False
        src_q, dst_q = sample.dtype == torch.int8, pool.dtype == torch.int8
        if src_q and dst_q:
            raise ValueError(
                f"disagg KV repack across two int8 layouts "
                f"({sample.shape[-1]} -> {pool.shape[-1]} lanes) is not "
                f"supported")
        return src_q or dst_q

    def _repack_kv_payload(self, pc: DeviceKvPayload) -> DeviceKvPayload:
        """The scale-aware repack of a device-plane payload into this pool's
        row format (the JAX engine's ``_maybe_repack_kv_payload``): int8
        rows dequantize to the pool's dtype, full-precision rows quantize
        through bf16 into int8 rows. Runs in a thread, off the engine
        loop; on the card it waits for the gather, then for its own
        kernels, so the result is complete when it returns."""
        pool = next(iter(self.kv.values()))
        sample = next(iter(pc.stacked.values()))
        src_q = sample.dtype == torch.int8
        if self.model_cfg.kv_lora_rank > 0:
            sections = (self.model_cfg.kv_lora_rank,
                        self.model_cfg.qk_rope_head_dim)
            C = sum(sections)
        else:
            sections = None
            C = self.model_cfg.num_kv_heads * self.model_cfg.head_dim

        def convert(arr):
            lead = arr.shape[:-1]
            rows = arr.reshape(-1, arr.shape[-1])
            if src_q:
                rows = (dequant_kv_rows_sections(rows, sections, pool.dtype)
                        if sections is not None
                        else dequant_kv_rows(rows, C, pool.dtype))
                if rows.shape[-1] < pool.shape[-1]:   # latent row padding
                    rows = torch.nn.functional.pad(
                        rows, (0, pool.shape[-1] - rows.shape[-1]))
            else:
                x = rows[..., :C].to(torch.bfloat16)
                rows = (quantize_kv_rows_sections(x, sections)
                        if sections is not None else quantize_kv_rows(x))
            return rows.reshape(lead + (rows.shape[-1],))

        with torch.inference_mode():
            if not sample.is_cuda:
                stacked = {k: convert(v) for k, v in pc.stacked.items()}
            else:
                with torch.cuda.device(sample.device):
                    stream = torch.cuda.current_stream(sample.device)
                    if pc.ready is not None:
                        stream.wait_event(pc.ready)
                    stacked = {k: convert(v) for k, v in pc.stacked.items()}
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()
        logger.info("disagg KV payload repacked %s/%d -> %s/%d lanes for %s",
                    sample.dtype, sample.shape[-1], pool.dtype,
                    next(iter(stacked.values())).shape[-1], pc.request_id)
        return dataclasses.replace(pc, stacked=stacked, ready=None)

    async def _prepare_payload(self, pc):
        """Validate a precomputed payload against this pool, off the loop's
        admission: a device-plane payload of another kv_quantization is
        repacked in a thread, and on the card a wire payload's values are
        copied to the card on the tier stream, also in a thread, so the
        loop never waits on a host→device copy of a whole prompt's KV."""
        if isinstance(pc, DeviceKvPayload):
            if self._repack_needed(pc):
                pc = await asyncio.to_thread(self._repack_kv_payload, pc)
            sample = next(iter(pc.stacked.values()))
            self._check_kv_payload_layout(sample.shape[-1], sample.dtype,
                                          "device")
            return pc
        if isinstance(pc, LayerStreamPayload):
            # the manifest announced the geometry: validate before any
            # frame is scattered
            self._check_layer_stream_layout(pc.manifest)
            return pc
        sample = next(iter(pc.values.values()))
        self._check_kv_payload_layout(sample.shape[1] * sample.shape[4],
                                      sample.dtype, "wire")
        if self.device.type == "cuda" and not sample.is_cuda:
            values = await asyncio.to_thread(
                lambda: start_h2d(pc.values, self.device,
                                  stream=self._tier_stream).wait())
            pc = dataclasses.replace(pc, values=values)
        return pc

    def _admit_precomputed(self, req: EngineRequest, n_already: int) -> tuple:
        """Admission from a remote prefill's KV payload: scatter the shipped
        blocks into this engine's pool, in place, instead of running the
        prefill (the decode half of PD disaggregation). Blocks this engine
        already had (device or tier prefix hits) are skipped. Returns the
        payload's first token and logprob (device tensors for the device
        plane, host values for the wire)."""
        pc = req.precomputed
        n_prompt_blocks = self._blocks_needed(len(req.prompt))
        targets = req.blocks[n_already:n_prompt_blocks]
        if isinstance(pc, DeviceKvPayload):
            if self.recorder is not None:
                # the payload is device-resident and not logged: an
                # offline replay refuses this event
                self.recorder.rec(
                    "precomputed_device_admit", rid=req.rid,
                    targets=list(targets), skip=n_already,
                    n_needed=n_prompt_blocks)
            if targets:
                scatter_blocks_device(self.kv, targets, pc, n_already,
                                      n_prompt_blocks)
            elif self.device.type == "cuda" and pc.ready is not None:
                # the first token's copy must still follow the gather
                torch.cuda.current_stream(self.device).wait_event(pc.ready)
        elif targets:
            if self.device.type == "cuda":
                compute = torch.cuda.current_stream(self.device)
                for v in pc.values.values():
                    # staged on the tier stream (_prepare_payload), read
                    # on this one: the allocator keeps it until the
                    # scatter has run
                    v.record_stream(compute)
            vals = {k: v[:, :, n_already:n_prompt_blocks]
                    for k, v in pc.values.items()}
            if self.recorder is not None:
                # the values are logged, so the replayer applies the same
                # scatter (recorded before it, as every device program)
                self.recorder.rec(
                    "precomputed_admit", rid=req.rid, targets=list(targets),
                    values={k: v.cpu().clone() for k, v in vals.items()})
            scatter_blocks_from_host(self.kv, targets, vals,
                                     self.cfg.kv_block_size)
        # drop the payload: a DeviceKvPayload would otherwise hold the
        # prefill engine's gathered blocks for this request's life
        req.precomputed = None
        return pc.first_token, pc.first_logprob

    def _admit_stream(self, req: EngineRequest, slot: int, plan,
                      n_already: int, t0: float) -> None:
        """Admission against a LayerStreamPayload, whole or arriving: the slot
        is reserved with a precomputed admission's bookkeeping (pos,
        key_step, mirrors: the later decode stream equals the monolithic
        handoff's), but the request stays ``ready=False`` (dispatches aim it
        at the trash block) while ``_stream_onboard`` scatters the layers
        as they land. The first token, block registration and the
        ``first_token`` record wait for the last layer; a dead stream
        re-admits COLD."""
        n_prompt = len(req.prompt)
        n_prompt_blocks = self._blocks_needed(n_prompt)
        req.pos = n_prompt
        req.generated = 1
        req.key_step += 1
        req.ready = False
        req.last_token = -1
        self.disagg_stream_admits += 1
        if self.recorder is not None:
            self.recorder.rec(
                "admit", rid=req.rid, slot=slot, pos=req.pos,
                key_step=req.key_step, blocks=list(req.blocks),
                hit=req.prefix_hit_tokens, prompt=list(req.prompt))
        self.slots[slot] = req
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(req.blocks)] = req.blocks
        self._set_slot_sampling(slot, req)
        logger.debug(
            "stream-admitted %s into slot %d (prompt=%d, hit=%d, %d layers "
            "inbound)", req.rid, slot, n_prompt, req.prefix_hit_tokens,
            req.precomputed.num_layers)
        self._record_prefill(req, plan, 0, True, t0)
        task = asyncio.get_running_loop().create_task(
            self._stream_onboard(req, plan, n_already, n_prompt_blocks),
            name=f"kv-stream-onboard-{req.rid}")
        self._stream_tasks.add(task)
        task.add_done_callback(self._stream_tasks.discard)

    def _stage_layer(self, values: dict):
        """A thread's half of a layer's onboard: the layer's wire values to
        the card on the tier stream, waited for (on the CPU: as they
        are)."""
        h2d = start_h2d(values, self.device, stream=self._tier_stream)
        h2d.wait()
        return h2d

    def _stream_gone(self, req: EngineRequest) -> bool:
        """Whether a stream-admitted request left its slot (raced away) or
        was cancelled; a cancelled one still holding its slot is released
        and finished here (a slot that is not ready is never swept)."""
        if req.slot < 0 or self.slots[req.slot] is not req:
            return True
        if req.cancelled:
            self._release_slot(req)
            self._finish_request(req, FinishReason.CANCELLED)
            return True
        return False

    async def _stream_onboard(self, req: EngineRequest, plan,
                              n_already: int, n_prompt_blocks: int) -> None:
        """Progressive onboard of a layer stream: per layer, await the
        frame, copy it to the card off the loop (tier stream), then on the
        loop record ``kv_layer_stream`` and scatter it in place on the
        compute stream, with no await between them (recorder order is
        device order). The targets are re-read each layer."""
        pc = req.precomputed
        t_wait = t_busy = 0.0
        try:
            for layer in range(pc.num_layers):
                _t0 = time.monotonic()
                vals = await pc.wait_layer(layer)
                _t1 = time.monotonic()
                t_wait += _t1 - _t0
                if self._stream_gone(req):
                    return
                if n_prompt_blocks > n_already:
                    sliced = {k: v[:, n_already:n_prompt_blocks]
                              for k, v in vals.items()}
                    h2d = await asyncio.to_thread(self._stage_layer, sliced)
                    if self._stream_gone(req):
                        return
                    targets = req.blocks[n_already:n_prompt_blocks]
                    if self.recorder is not None:
                        self.recorder.rec(
                            "kv_layer_stream", rid=req.rid, layer=layer,
                            num_layers=pc.num_layers, targets=list(targets),
                            values={k: v.cpu().clone()
                                    for k, v in sliced.items()})
                    with torch.inference_mode():
                        scatter_layer_transfer(self.kv, targets, layer, h2d,
                                               self.cfg.kv_block_size)
                self.disagg_stream_layers_scattered += 1
                t_busy += time.monotonic() - _t1
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — dead stream → cold rung
            self.disagg_stream_fallbacks += 1
            self.disagg_stream_hidden_s += t_busy
            self.disagg_stream_exposed_s += t_wait
            if self._stream_gone(req):
                return
            logger.warning("kv layer stream failed for %s (%s) — "
                           "re-admitting as a cold recompute", req.rid, e)
            self._release_slot(req)
            # the pre-admission sampling state, so that the recompute
            # samples what an uncontended run would (the dead stream
            # consumed no key: the first token was the producer's)
            req.key_step -= 1
            req.pos = 0
            req.generated = 0
            req.precomputed = None
            req.seq = None
            req.slot = -1
            req.registered_blocks = 0
            req.prefix_hit_tokens = 0
            req.ready = True
            req.cold_admission = True
            self.waiting.put_nowait(req)
            self._work_event.set()
            return
        # completion: the pool holds the prompt's KV — register it, emit
        # the producer's first token, join the decode batch
        self.disagg_stream_hidden_s += t_busy
        self.disagg_stream_exposed_s += t_wait
        if pc.fallback_monolithic:
            self.disagg_stream_fallbacks += 1
        req.precomputed = None
        if self._stream_gone(req):
            return
        req.registered_blocks = self.kv_manager.register_full_blocks(
            req.blocks, plan.seq, already_registered=n_already)
        tok, logprob = int(pc.first_token), float(pc.first_logprob)
        req.last_token = tok
        req.ready = True
        if self.recorder is not None:
            self.recorder.rec("first_token", rid=req.rid, pf_seq=None,
                              tok=tok)
        self._emit(req, tok, logprob)
        self._maybe_finish_after_emit(req)
        self._work_event.set()

    def _handoff_and_finish(self, req: EngineRequest, toks: torch.Tensor,
                            logprobs: torch.Tensor) -> None:
        """Prefill-worker epilogue: dispatch the gather of the prompt's
        blocks on the compute stream (ordered before any later write into
        them), then ship it from a task, so the engine loop keeps stepping
        while the copies and the transfer run. The device plane ships the
        gather and the first token as device tensors; the wire plane
        fetches them in threads, the layers on the tier stream."""
        n_blocks = self._blocks_needed(req.pos)
        ids = req.blocks[:n_blocks]
        if self.recorder is not None:
            self.recorder.rec("handoff_gather", rid=req.rid, ids=list(ids),
                              n_blocks=n_blocks,
                              park=bool(req.handoff_device))
        with torch.inference_mode():
            stacked = gather_blocks_dispatch(self.kv, ids,
                                             self.cfg.kv_block_size)
        seq_hashes = list(req.seq.sequence_hashes[:req.registered_blocks])
        handoff = req.handoff
        heads, stream = self.wire_kv_heads, self._tier_stream

        if req.handoff_device:
            async def send() -> None:
                await handoff(toks, logprobs,
                              {"stacked": stacked, "n_blocks": n_blocks},
                              seq_hashes)
        else:
            first = _FirstToken(toks, logprobs)
            if req.handoff_layered:
                num_layers = next(iter(stacked.values())).shape[0]

                async def send() -> None:
                    tok, logprob = await asyncio.to_thread(first.wait)
                    harvest = LayeredHarvest(
                        num_layers=num_layers,
                        fetch_layer=lambda l: fetch_wire_layer(
                            stacked, n_blocks, heads, l, stream),
                        fetch_all=lambda: fetch_wire(stacked, n_blocks,
                                                     heads, stream))
                    await handoff(tok, logprob, harvest, seq_hashes)
            else:
                async def send() -> None:
                    tok, logprob = await asyncio.to_thread(first.wait)
                    values = await asyncio.to_thread(
                        fetch_wire, stacked, n_blocks, heads, stream)
                    await handoff(tok, logprob, values, seq_hashes)

        task = asyncio.get_running_loop().create_task(
            send(), name=f"kv-handoff-{req.rid}")
        self._handoff_tasks.add(task)
        task.add_done_callback(self._handoff_tasks.discard)
        self._release_slot(req)
        self._finish_request(req, FinishReason.LENGTH)

    def _complete_admissions(self) -> None:
        """Finish the deferred admissions: their copies have been in flight
        across a decode dispatch; fetch each first token (one round trip
        for the batch, as the JAX engine counts it), emit it and make the
        slot decodable."""
        pending, self._admissions = self._admissions, []
        if pending:
            self.host_roundtrips += 1
        for req, first, pf_seq in pending:
            t_fetch = time.monotonic()
            tok, logprob = first.wait()
            self.host_stall_s += time.monotonic() - t_fetch
            req.last_token = tok
            req.ready = True
            if self.recorder is not None:
                self.recorder.rec("first_token", rid=req.rid,
                                  pf_seq=pf_seq, tok=tok)
            if self.slots[req.slot] is not req:
                continue               # raced away (shutdown edge)
            self._emit(req, tok, logprob)
            self._maybe_finish_after_emit(req)

    def _chunked_prefill(self, req: EngineRequest, chunk: list,
                         table: np.ndarray, table_t: torch.Tensor,
                         slot: int) -> tuple:
        """Prompt prefill as a sequence of fixed-size chunk dispatches
        (EngineConfig.prefill_chunk): each chunk continues at ``start_pos``
        against the KV already written — the mechanism of a prefix-reuse
        continuation — and the tail pads to the chunk size too, so one
        shape serves any prompt length. Each chunk records as a
        ``prefill`` event. Returns the last chunk's logits (only the final
        chunk's sample matters) and its event's pf_seq."""
        C = self.cfg.prefill_chunk
        off = req.prefix_hit_tokens
        logits = pf_seq = None
        for lo in range(0, len(chunk), C):
            piece = chunk[lo:lo + C]
            padded = np.zeros((C,), np.int64)
            padded[:len(piece)] = piece
            if self.recorder is not None:
                pf_seq = self._rec_prefill("prefill", req, slot, padded,
                                           table, len(piece), off)
            logits = self.model_mod.prefill_forward(
                self.params, self.kv, torch.from_numpy(padded).to(self.device),
                table_t, off, len(piece), self.model_cfg,
                self.cfg.kv_block_size)
            off += len(piece)
        return logits, pf_seq

    def _set_slot_sampling(self, slot: int, req: EngineRequest) -> None:
        """The slot's rows of the decode program's sampling inputs."""
        self._samp["temperature"][slot] = req.sampling.temperature
        self._samp["top_k"][slot] = req.sampling.top_k
        self._samp["top_p"][slot] = req.sampling.top_p
        self._seeds[slot] = req.sampling.seed

    def _admit_lane(self, req: EngineRequest, slot: int,
                    n_already: int) -> None:
        """Continuous-batching admission: no prefill dispatch — the prompt
        rides the decode batch as planned tokens (split path, see
        EngineConfig.lane_prefill_max_tokens) or the ragged batch as a
        prefill lane. Blocks are allocated (by the caller's plan) but NOT
        registered yet: their KV is written step by step or chunk by
        chunk, so registration follows the harvest as in decode."""
        self.lane_admissions += 1
        n_prompt = len(req.prompt)
        hit = req.prefix_hit_tokens
        # the first generated token comes from the decode program or the
        # ragged forward here (an uncontended run derives it via the
        # prefill path) — a numeric boundary for the exactness contract
        req.numeric_boundaries.append(req.emitted_total)
        req.lane_prompt = list(req.prompt)
        req.pos = hit
        req.generated = 0
        # sampling-key parity with the prefill path: the step (or row)
        # consuming the last prompt token samples the first generation at
        # the request's CURRENT key_step; planned steps before it burn
        # earlier (possibly negative) keys whose samples are discarded, and
        # a ragged dispatch keys a span at key_step + len - 1
        req.key_step -= n_prompt - hit - 1
        req.last_token = req.prompt[hit]
        req.ready = True
        # the hash chain restarts from the hit prefix and grows per row
        req.seq = TokenBlockSequence(self.cfg.kv_block_size,
                                     req.prompt[:hit])
        req.registered_blocks = n_already
        self.slots[slot] = req
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(req.blocks)] = req.blocks
        self._set_slot_sampling(slot, req)
        if self.recorder is not None:
            self.recorder.rec(
                "admit", rid=req.rid, slot=slot, pos=req.pos,
                key_step=req.key_step, blocks=list(req.blocks), hit=hit,
                prompt=list(req.prompt), lane=True)
        logger.debug("lane-admitted %s into slot %d (prompt=%d, hit=%d)",
                     req.rid, slot, n_prompt, hit)

    # --------------------------------------------------------------- ragged
    def _ragged_step(self) -> None:
        """One ragged dispatch: grow blocks, pack every slot's pending work
        (mid-prompt lanes up to ragged_max_seq_rows prompt rows, decoding
        slots one row, or with drafts a spec span of 1 + k rows) into one
        batch, run it, harvest.

        With ``decode_dispatch_pipeline`` a pure-decode dispatch defers its
        harvest one iteration: the next dispatch chains off the in-flight
        device tokens (the chained-sample merge), so the device→host fetch
        overlaps the next dispatch's compute. Any churn (an admission
        mid-prompt, slot turnover, growth that fails, a slot at capacity,
        drafts due) drains the pipeline first and costs one un-overlapped
        dispatch."""
        if self._ragged_pending is not None:
            nxt = self._ragged_dispatch_pipelined()
            prev, self._ragged_pending = self._ragged_pending, None
            self._harvest_ragged(prev)
            if nxt is not None:
                self._ragged_pending = nxt
                return
            if not any(s is not None and s.ready for s in self.slots):
                return
            # couldn't chain: a fresh host-fed dispatch against the
            # harvested state
        pending = self._ragged_dispatch_fresh()
        if pending is None:
            return
        if (self.cfg.decode_dispatch_pipeline
                and all(sq.mode == "decode" for sq in pending["batch"].seqs)):
            # pure decode: defer the harvest so the next iteration can
            # chain off it (prefill and spec spans harvest at once: their
            # bookkeeping gates the next packing)
            self._ragged_pending = pending
        else:
            self._harvest_ragged(pending)

    def _draft_slots(self) -> dict:
        """Drafts for every decoding slot with a live spec budget, by slot
        (request, drafts): the verify dispatch's drafts on the split path,
        the spec spans a ragged dispatch carries. Drafting reads harvested
        history only, so no pipelined dispatch may be in flight."""
        drafts: dict = {}
        if self.drafter is None:
            return drafts
        for i, s in enumerate(self.slots):
            if (s is None or not s.ready or s.seq is None
                    or s.last_token < 0):
                continue
            if s.lane_prompt is not None and s.pos < len(s.lane_prompt):
                continue               # mid-prompt: decode hasn't begun
            k = self._req_spec_k(s)
            if k <= 0:
                continue
            d = self.drafter.draft(list(s.seq.tokens) + [s.last_token], k)
            if d:
                drafts[i] = (s, [int(t) for t in d[:k]])
        return drafts

    def _ragged_dispatch_fresh(self) -> Optional[dict]:
        """Draft, grow, pack and run one host-fed ragged dispatch. Block
        growth runs BEFORE packing at each slot's largest possible span
        (the packer only ever shrinks a span; over-grown blocks stay owned
        by their request); a slot that cannot grow preempts or finishes as
        the split path would. Returns the un-harvested dispatch, or
        None."""
        cfg = self.cfg
        Lmax = cfg.ragged_max_seq_rows
        capacity = self.M * cfg.kv_block_size
        drafts = self._draft_slots()
        for i, s in enumerate(self.slots):
            if s is None or not s.ready:
                continue
            in_prompt = (s.lane_prompt is not None
                         and s.pos < len(s.lane_prompt))
            ent = drafts.get(i)
            n_draft = len(ent[1]) if ent is not None and ent[0] is s else 0
            want = (min(len(s.lane_prompt) - s.pos, Lmax) if in_prompt
                    else 1 + n_draft)
            if s.pos + want + 1 > capacity:
                self._release_slot(s)
                self._finish_request(s, FinishReason.LENGTH)
                continue
            need = self._blocks_needed(s.pos + want + 1)
            if need > len(s.blocks):
                new = self.kv_manager.pool.alloc_uninit(need - len(s.blocks))
                if new is None:
                    self._preempt_or_finish(s)
                    continue
                s.blocks.extend(new)
                self._block_tables[i, :len(s.blocks)] = s.blocks
        decode_rows = []
        prefill_lanes = []
        spec_lanes = []
        for i, s in enumerate(self.slots):
            if s is None or not s.ready:
                continue
            if s.lane_prompt is not None and s.pos < len(s.lane_prompt):
                prefill_lanes.append(
                    (i, s.lane_prompt[s.pos:s.pos + Lmax], s.pos))
                continue
            ent = drafts.get(i)
            # growth may have preempted or finished the drafted request:
            # keep drafts only for slots that still hold it
            if ent is not None and ent[0] is s:
                spec_lanes.append((i, [s.last_token] + ent[1], s.pos))
            else:
                decode_rows.append((i, s.last_token, s.pos))
        batch = build_ragged_batch(cfg.ragged_max_tokens, self.B,
                                   decode_rows, prefill_lanes, Lmax,
                                   spec_lanes=spec_lanes)
        if batch is None:
            return None
        return self._ragged_dispatch(batch)

    def _ragged_dispatch_pipelined(self) -> Optional[dict]:
        """Steady-state pipelined ragged dispatch: chain off the in-flight
        dispatch's device tokens. Returns the new pending record, or None
        when the pipeline must drain first: the slot→request mapping must
        be the in-flight dispatch's, no slot mid-prompt or due to draft,
        and growth one token ahead must succeed without finishing or
        preempting anything (an un-harvested token is in flight)."""
        prev = self._ragged_pending
        now = self._ready_slots()
        if any(now[i] is not prev["reqs"][i] for i in range(self.B)):
            return None
        live = [i for i in range(self.B) if now[i] is not None]
        if not live:
            return None
        for i in live:
            s = now[i]
            if s.lane_prompt is not None and s.pos < len(s.lane_prompt):
                return None        # admission churn mid-flight
            if (self.drafter is not None and s.seq is not None
                    and self._req_spec_k(s) > 0):
                # drafts come from harvested state: drain, and the next
                # fresh dispatch carries the spec span
                return None
        capacity = self.M * self.cfg.kv_block_size
        for i in live:
            s = now[i]
            if s.pos + 1 + 2 > capacity:
                return None
            need = self._blocks_needed(s.pos + 1 + 2)
            if need > len(s.blocks):
                new = self.kv_manager.pool.alloc_uninit(need - len(s.blocks))
                if new is None:
                    return None
                s.blocks.extend(new)
                self._block_tables[i, :len(s.blocks)] = s.blocks
        batch = build_ragged_batch(
            self.cfg.ragged_max_tokens, self.B,
            [(i, now[i].last_token, now[i].pos + 1) for i in live],
            [], self.cfg.ragged_max_seq_rows)
        if batch is None:
            return None
        return self._ragged_dispatch(batch, chain=prev, ahead=1)

    def _ragged_dispatch(self, batch: RaggedBatch,
                         chain: Optional[dict] = None,
                         ahead: int = 0) -> dict:
        """Launch one ragged dispatch over ``batch`` (the ragged program;
        the trash sequence is slot B). A span that ends in a sample keys it
        at ``key_step + ahead + len - 1``: the key the split path uses
        there, by the lane admission's offset (== key_step for a decode
        row); the row-sampled program keys row r of every span at
        ``key_step + ahead + r``, the same key at a span's last row. Spans
        that end mid-prompt, the trash slot and the slots the batch leaves
        out sample at temperature 0, and are discarded. ``chain``: the
        in-flight pending record whose device tokens feed this dispatch's
        decode rows (the chained-sample merge); ``ahead``: the un-harvested
        tokens each chained slot runs ahead of host state (its positions
        were advanced by the caller's packing). Returns the un-harvested
        dispatch."""
        S = self.B + 1
        T = self.cfg.ragged_max_tokens
        row_sampled = self.ragged_program.row_sampled
        tables = np.zeros((S, self.M), np.int32)
        tables[:self.B] = self._tables_for_dispatch()
        seeds = np.zeros((S,), np.int64)
        steps = np.zeros((T if row_sampled else S,), np.int64)
        temperature = np.zeros((S,), np.float32)
        top_k = np.zeros((S,), np.int64)
        top_p = np.ones((S,), np.float32)
        live = np.zeros((S,), bool)
        for sq in batch.seqs:
            s = self.slots[sq.slot]
            i = sq.slot
            seeds[i] = self._seeds[i]
            if row_sampled:
                steps[sq.start:sq.start + sq.length] = (
                    s.key_step + ahead + np.arange(sq.length))
            else:
                steps[i] = s.key_step + ahead + sq.length - 1
            if (sq.mode == "prefill"
                    and s.pos + sq.length < len(s.lane_prompt)):
                continue
            live[i] = True
            temperature[i] = self._samp["temperature"][i]
            top_k[i] = self._samp["top_k"][i]
            top_p[i] = self._samp["top_p"][i]
        inputs = {"tokens": batch.tokens.astype(np.int64),
                  "positions": batch.positions, "row_slot": batch.row_slot,
                  "tables": tables, "seq_starts": batch.seq_starts,
                  "seq_counts": batch.seq_counts,
                  "sample_rows": batch.sample_rows, "seeds": seeds,
                  "steps": steps, "temperature": temperature,
                  "top_k": top_k, "top_p": top_p}
        prev = mask = srows = None
        if chain is not None:
            # each chained row takes the previous dispatch's device token
            # at its slot (the row-sampled program: at the slot's sample
            # row of the previous batch)
            mask = np.zeros((T,), bool)
            srows = np.zeros((T,), np.int64)
            for sq in batch.seqs:
                mask[sq.start] = True
                srows[sq.start] = (chain["batch"].sample_rows[sq.slot]
                                   if row_sampled else sq.slot)
            inputs["chain_mask"], inputs["srows"] = mask, srows
            prev = chain["dispatch"].toks
            self.ragged_chained_dispatches += 1
        self._step += 1
        did = None
        if self.recorder is not None:
            did = self.recorder.next_dispatch_id()
            self.recorder.rec(
                "ragged", id=did, tokens=inputs["tokens"].copy(),
                positions=batch.positions.copy(),
                row_slot=batch.row_slot.copy(),
                starts=batch.seq_starts.copy(),
                counts=batch.seq_counts.copy(),
                sample_rows=batch.sample_rows.copy(), tables=tables,
                seeds=seeds, steps=steps, temperature=temperature,
                top_k=top_k, top_p=top_p, seqs=batch.seqs_meta(),
                chained_from=chain["id"] if chain is not None else None,
                mask=mask, srows=srows,
                reqs=[s.rid if s is not None else None
                      for s in self._ready_slots()])
        variant = sampling_variant(temperature, top_k, top_p, live)
        with torch.inference_mode():
            dispatch = self.ragged_program.dispatch(variant, inputs,
                                                    chain=prev)
        n = batch.rows_used
        self.ragged_dispatches += 1
        self.ragged_rows_total += n
        self.ragged_prefill_rows_total += batch.prefill_rows
        self.ragged_decode_rows_total += n - batch.prefill_rows
        if batch.mixed:
            self.ragged_mixed_dispatches += 1
        self.ragged_dispatches_saved += batch.dispatches_replaced - 1
        if batch.n_spec:
            self.spec_dispatches += 1
            self.spec_drafted_tokens += batch.spec_rows
            self.ragged_spec_rows += batch.spec_rows
        return {"batch": batch, "dispatch": dispatch, "id": did,
                "chained": chain is not None, "reqs": self._ready_slots()}

    def _harvest_ragged(self, pending: dict) -> None:
        """Apply one ragged dispatch: per span, the consumed prompt rows'
        bookkeeping (hash chain, registration, pos/key_step) and, when the
        span ends in a sample (a decode row, or the row consuming the LAST
        prompt token), the emission and finish checks of one decode step.
        A spec span walks its rows with lockstep acceptance, as a verify
        harvest does: a rejected draft's row rolls back by rewind. A span
        whose slot holds another request than at dispatch is skipped."""
        toks, logprobs = self._fetch(pending["dispatch"])
        batch = pending["batch"]
        row_sampled = self.ragged_program.row_sampled
        applied = []
        for sq in batch.seqs:
            i = sq.slot
            req = pending["reqs"][i]
            if req is None or self.slots[i] is not req:
                continue
            if req.cancelled:
                self._release_slot(req)
                self._finish_request(req, FinishReason.CANCELLED)
                continue
            if sq.mode == "spec":
                rows = slice(sq.start, sq.start + sq.length)
                n = self._apply_verified(i, req, batch.tokens[rows],
                                         toks[rows], logprobs[rows])
                applied.append((i, req.rid, n, n))
                continue
            if sq.mode == "prefill":
                for _ in range(sq.length):
                    req.seq.append(req.lane_prompt[req.pos])
                    req.registered_blocks = \
                        self.kv_manager.register_full_blocks(
                            req.blocks, req.seq, req.registered_blocks)
                    req.pos += 1
                    req.key_step += 1
                self.total_prefill_tokens += sq.length
                if req.pos < len(req.lane_prompt):
                    applied.append((i, req.rid, sq.length, 0))
                    continue               # still mid-prompt: no sample
                req.lane_prompt = None     # plain decode from here on
            else:
                req.seq.append(int(req.last_token))
                req.registered_blocks = self.kv_manager.register_full_blocks(
                    req.blocks, req.seq, req.registered_blocks)
                req.pos += 1
                req.key_step += 1
                self.total_decode_tokens += 1
            sample = sq.start + sq.length - 1 if row_sampled else i
            tok = int(toks[sample])
            req.generated += 1
            req.last_token = tok
            self._emit(req, tok, float(logprobs[sample]))
            self._maybe_finish_after_emit(req)
            applied.append((i, req.rid, sq.length, 1))
        if self.recorder is not None and pending["id"] is not None:
            self.recorder.rec("ragged_harvest", id=pending["id"],
                              toks=np.array(toks), applied=applied)
        device_ms, host_gap_ms = self._flight_times()
        # the JAX record's prefetch_* fields are left out: the port's K4
        # has no cross-sequence wave prefetch (ROADMAP B1)
        self.flight.record(
            "ragged", rows=batch.rows_used, capacity=batch.capacity,
            fill=round(batch.fill_ratio, 4),
            prefill_rows=batch.prefill_rows,
            decode_rows=batch.rows_used - batch.prefill_rows,
            n_prefill=batch.n_prefill, n_decode=batch.n_decode,
            n_spec=batch.n_spec, spec_rows=batch.spec_rows,
            chained=pending["chained"], mixed=batch.mixed,
            emitted=sum(e for _i, _r, _n, e in applied),
            device_ms=device_ms, host_gap_ms=host_gap_ms)

    def _flight_times(self) -> tuple:
        """(device_ms, host_gap_ms) of the dispatch-harvest cycle ending
        now: the host's wait on the device's results since the last cycle
        ended, and the rest of the cycle's host time."""
        now = time.monotonic()
        stall = self.host_stall_s - self._flight_prev_stall_s
        self._flight_prev_stall_s = self.host_stall_s
        gap = max(1e3 * (now - self._flight_cycle_end - stall), 0.0)
        self._flight_cycle_end = now
        return round(1e3 * stall, 3), round(gap, 3)

    # --------------------------------------------------------------- decode
    def _tables_for_dispatch(self) -> np.ndarray:
        """Block tables a dispatch should see: a slot whose admission is
        not complete keeps its mirror row, but the dispatch aims it at the
        trash block (copy-on-write, so the mirror survives)."""
        tables = self._block_tables
        for i, s in enumerate(self.slots):
            if s is not None and not s.ready:
                if tables is self._block_tables:
                    tables = self._block_tables.copy()
                tables[i, :] = 0
        return tables

    def _dispatch_inputs(self, steps: np.ndarray, planned=None,
                         pmask=None, mask=None) -> dict:
        """The decode program's inputs from the host mirrors (the program
        copies them: the mirrors may change while a dispatch runs)."""
        return {"tokens": self._tokens, "positions": self._positions,
                "tables": self._tables_for_dispatch(), "seeds": self._seeds,
                "steps0": steps, "temperature": self._samp["temperature"],
                "top_k": self._samp["top_k"], "top_p": self._samp["top_p"],
                "planned": planned, "planned_mask": pmask,
                "chain_mask": mask}

    def _variant(self) -> str:
        live = np.array([s is not None and s.ready for s in self.slots])
        return sampling_variant(self._samp["temperature"],
                                self._samp["top_k"], self._samp["top_p"],
                                live)

    def _fetch(self, dispatch) -> tuple:
        """The dispatch's (toks [K, B], logprobs [K, B]) on the host: one
        device→host round trip, its wait counted."""
        self.host_roundtrips += 1
        t0 = time.monotonic()
        out = dispatch.fetch()
        self.host_stall_s += time.monotonic() - t0
        return out

    def _decode_step(self) -> None:
        if self.verify_program is not None and self._spec_candidates():
            # drafts come from harvested state: a pipelined dispatch
            # drains first (speculation forfeits the fetch overlap)
            if self._pending is not None:
                prev, self._pending = self._pending, None
                self._harvest(prev)
                if not any(s is not None and s.ready for s in self.slots):
                    return
            if self._decode_step_spec():
                return
            # no slot drafted: plain decode this step
        K = self.cfg.decode_steps_per_dispatch
        if K > 1:
            self._decode_step_multi(K)
            return
        active_idx = [i for i, s in enumerate(self.slots)
                      if s is not None and s.ready]
        steps = np.zeros((self.B,), np.int64)
        for i in range(self.B):
            s = self.slots[i]
            if s is None or not s.ready:
                self._tokens[i] = 0
                self._positions[i] = 0
                if s is None:
                    self._block_tables[i, :] = 0  # trash block
            else:
                self._tokens[i] = s.last_token
                self._positions[i] = s.pos
                steps[i] = s.key_step
        inputs = self._dispatch_inputs(steps)
        self._step += 1
        did = self._rec_dispatch(1, inputs)
        with torch.inference_mode():
            dispatch = self.program.dispatch(1, self._variant(), inputs)
        toks, logprobs = self._fetch(dispatch)
        if self.recorder is not None:
            self.recorder.rec(
                "harvest", id=did, toks=np.array(toks),
                applied=[(i, self.slots[i].rid, 1) for i in active_idx])
        toks, logprobs = toks[0], logprobs[0]
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
            req.key_step += 1
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
        device_ms, host_gap_ms = self._flight_times()
        self.flight.record("decode", K=1, batch_fill=len(active_idx),
                           planned_tokens=len(active_idx),
                           emitted=len(active_idx), device_ms=device_ms,
                           host_gap_ms=host_gap_ms)

    def _rec_dispatch(self, K: int, inputs: dict,
                      chained_from: Optional[int] = None) -> Optional[int]:
        """Record one decode dispatch (``inputs``: ``_dispatch_inputs``);
        returns its id, or None with no recorder."""
        if self.recorder is None:
            return None
        did = self.recorder.next_dispatch_id()
        mask = inputs["chain_mask"]
        plan = ({} if inputs["planned"] is None else
                {"planned": inputs["planned"].copy(),
                 "planned_mask": inputs["planned_mask"].copy()})
        self.recorder.rec(
            "dispatch", id=did, K=K, chained_from=chained_from,
            mask=(np.zeros((self.B,), bool) if mask is None
                  else mask.copy()),
            tokens=inputs["tokens"].copy(),
            positions=inputs["positions"].copy(),
            tables=inputs["tables"].copy(), seeds=inputs["seeds"].copy(),
            steps=inputs["steps0"].copy(),
            temperature=inputs["temperature"].copy(),
            top_k=inputs["top_k"].copy(), top_p=inputs["top_p"].copy(),
            **plan, reqs=[s.rid if s is not None else None
                          for s in self._ready_slots()])
        return did

    def _decode_step_multi(self, K: int) -> None:
        """K decode steps, one dispatch, one host harvest: sampled tokens
        chain into the next step on the device, so the device→host fetch
        and the host's dispatch work are paid once per K tokens.
        EOS/cancel/max_tokens are applied at harvest: device steps past a
        finish are discarded (the K-1-steps-of-waste trade,
        EngineConfig).

        With ``decode_dispatch_pipeline`` the harvest is deferred one
        dispatch: the next K-batch launches chained off the previous
        dispatch's ON-DEVICE tokens, so the device→host copy overlaps the
        next dispatch's compute. Finish reaction widens to <=2K-1 steps."""
        if self._pending is not None:
            nxt = self._dispatch_pipelined(K)
            prev, self._pending = self._pending, None
            self._harvest(prev)
            if nxt is not None:
                self._pending = nxt
                return
            # couldn't chain (slot churn / growth failure): fall through to
            # a fresh host-fed dispatch against the harvested state
        if not self._prepare_multi(K):
            return
        pending = self._dispatch_multi(K)
        if self.cfg.decode_dispatch_pipeline:
            self._pending = pending
        else:
            self._harvest(pending)

    def _prepare_multi(self, K: int, ahead_mask=None) -> bool:
        """Capacity check + block-table pre-grow for the next K steps.
        ``ahead_mask`` flags slots whose request has K un-harvested steps
        already in flight (pipelined dispatch). Returns False when nothing
        is left to decode — or, with a mask, when the pipeline must drain
        before growth/finish decisions can be made safely (blocks already
        grown for earlier slots in the pass stay owned by their
        requests)."""
        capacity = self.M * self.cfg.kv_block_size
        for i, s in enumerate(self.slots):
            if s is None or not s.ready:
                continue
            in_flight = bool(ahead_mask is not None and ahead_mask[i])
            pos_eff = s.pos + (K if in_flight else 0)
            if pos_eff + K + 1 > capacity:
                # within K tokens of the context capacity: finish now
                # rather than let the program write past the block table
                if in_flight:
                    return False
                self._release_slot(s)
                self._finish_request(s, FinishReason.LENGTH)
                continue
            need = self._blocks_needed(pos_eff + K + 1)
            if need > len(s.blocks):
                new = self.kv_manager.pool.alloc_uninit(need - len(s.blocks))
                if new is None:
                    # out of KV memory: preempt (recompute) when other
                    # sequences keep the pool contended, else finish — but
                    # never with un-harvested tokens in flight
                    if in_flight:
                        return False
                    self._preempt_or_finish(s)
                    continue
                s.blocks.extend(new)
                self._block_tables[i, :len(s.blocks)] = s.blocks
        return any(s is not None and s.ready for s in self.slots)

    def _dispatch_pipelined(self, K: int) -> Optional[dict]:
        """Steady-state pipelined dispatch: chain off the in-flight batch's
        device tokens. Returns the new pending record, or None when the
        pipeline must drain first: chaining requires the slot→request
        mapping to be IDENTICAL to the in-flight dispatch's, so any churn
        (admission, finish, preemption) costs one un-overlapped
        dispatch."""
        prev = self._pending
        if prev["K"] != K:
            return None
        now = self._ready_slots()
        if any(now[i] is not prev["reqs"][i] for i in range(self.B)):
            return None
        mask = np.array([s is not None for s in now], dtype=bool)
        if not mask.any():
            return None
        if not self._prepare_multi(K, ahead_mask=mask):
            return None
        return self._dispatch_multi(K, chain=prev["dispatch"].chain,
                                    mask=mask, chained_from=prev["id"])

    def _dispatch_multi(self, K: int, chain=None, mask=None,
                        chained_from: Optional[int] = None) -> dict:
        """Launch one K-step dispatch. ``mask`` flags slots chained off the
        in-flight dispatch: their input token comes from ``chain`` (device)
        and their positions/keys run K steps ahead of harvested host
        state; everything else feeds host-known last_tokens."""
        if mask is None:
            mask = np.zeros((self.B,), dtype=bool)
        steps = np.zeros((self.B,), np.int64)
        for i in range(self.B):
            s = self.slots[i]
            ahead = K if mask[i] else 0
            if s is None or not s.ready:
                self._tokens[i] = 0
                self._positions[i] = 0
                if s is None:
                    self._block_tables[i, :] = 0  # trash block
            else:
                self._tokens[i] = s.last_token
                self._positions[i] = s.pos + ahead
                steps[i] = s.key_step + ahead
        # lane-prefill planned inputs: stateless from positions (which
        # already include the pipelined +K lookahead), so chained and
        # host-fed dispatches agree without extra bookkeeping
        planned = pmask = None
        for i, s in enumerate(self.slots):
            if s is None or not s.ready or s.lane_prompt is None:
                continue
            if planned is None:
                planned = np.zeros((K, self.B), np.int64)
                pmask = np.zeros((K, self.B), bool)
            pos0 = int(self._positions[i])
            n_pr = len(s.lane_prompt)
            for k in range(K):
                p = pos0 + k
                if p < n_pr:
                    planned[k, i] = s.lane_prompt[p]
                    pmask[k, i] = True
        inputs = self._dispatch_inputs(steps, planned, pmask, mask)
        self._step += K
        did = self._rec_dispatch(K, inputs,
                                 chained_from if chain is not None else None)
        with torch.inference_mode():
            dispatch = self.program.dispatch(K, self._variant(), inputs,
                                             chain=chain)
        return {"dispatch": dispatch, "K": K, "id": did,
                "reqs": self._ready_slots()}

    def _ready_slots(self) -> List[Optional[EngineRequest]]:
        """The slots a dispatch decodes: each ready request, else None."""
        return [s if (s is not None and s.ready) else None
                for s in self.slots]

    def _harvest(self, pending: dict) -> None:
        """Apply one dispatch's results: emissions, seq bookkeeping,
        EOS/budget/cancel finishes. Device overrun past a finish — or past
        a slot whose request changed since dispatch — is discarded."""
        toks_k, logprobs_k = self._fetch(pending["dispatch"])  # [K, B]
        K = pending["K"]
        applied = []
        for i, req in enumerate(pending["reqs"]):
            if req is None or self.slots[i] is not req:
                continue
            input_tok = req.last_token
            pos0 = req.pos
            for k in range(K):
                if req.cancelled:
                    self._release_slot(req)
                    self._finish_request(req, FinishReason.CANCELLED)
                    break
                in_prompt = (req.lane_prompt is not None
                             and req.pos < len(req.lane_prompt))
                if in_prompt:
                    input_tok = req.lane_prompt[req.pos]
                tok = int(toks_k[k, i])
                if req.seq is not None:
                    req.seq.append(input_tok)
                    req.registered_blocks = \
                        self.kv_manager.register_full_blocks(
                            req.blocks, req.seq, req.registered_blocks)
                req.pos += 1
                req.key_step += 1
                if in_prompt and req.pos < len(req.lane_prompt):
                    # mid-prompt planned step: the sampled token is
                    # discarded; the next input comes from the prompt
                    self.total_prefill_tokens += 1
                    continue
                if in_prompt:               # consumed the LAST prompt token
                    self.total_prefill_tokens += 1
                    req.lane_prompt = None  # plain decode from here on
                req.generated += 1
                req.last_token = tok
                self.total_decode_tokens += 1
                self._emit(req, tok, float(logprobs_k[k, i]))
                self._maybe_finish_after_emit(req)
                if self.slots[i] is not req:
                    break                      # finished: drop device overrun
                input_tok = tok
            applied.append((i, req.rid, req.pos - pos0))
        if self.recorder is not None and pending["id"] is not None:
            self.recorder.rec("harvest", id=pending["id"],
                              toks=np.array(toks_k), applied=applied)
        device_ms, host_gap_ms = self._flight_times()
        self.flight.record("decode", K=K, batch_fill=len(applied),
                           planned_tokens=K * len(applied),
                           emitted=sum(n for _i, _r, n in applied),
                           device_ms=device_ms, host_gap_ms=host_gap_ms)

    # ---------------------------------------------------------- speculation
    def _req_spec_k(self, req: EngineRequest) -> int:
        """A request's draft budget: its own (-1 = the live default)
        clamped to the verify program's spec_k."""
        k = self.spec_k_live if req.spec_k < 0 else req.spec_k
        return max(0, min(int(k), self.cfg.spec_k))

    def _spec_candidates(self) -> bool:
        """True when a verify dispatch could be worth trying. A slot in
        lane prefill vetoes the batch: the verify program has no planned
        tokens, and lanes last a few steps."""
        any_spec = False
        for s in self.slots:
            if s is None or not s.ready:
                continue
            if s.lane_prompt is not None:
                return False
            if s.seq is not None and self._req_spec_k(s) > 0:
                any_spec = True
        return any_spec

    def _decode_step_spec(self) -> bool:
        """One speculative step: draft a slot from its harvested history,
        score every slot's drafts and bonus position in one verify
        dispatch (slots without drafts ride as one row), harvest with
        lockstep acceptance. Returns False when no slot drafted: the
        caller then runs plain decode."""
        drafts = self._draft_slots()
        if not drafts:
            return False
        Tv = self.cfg.spec_k + 1
        if not self._prepare_multi(Tv):
            return True            # capacity churn consumed the step
        steps = np.zeros((self.B,), np.int64)
        tokens = np.zeros((self.B, Tv), np.int64)
        n_rows = np.zeros((self.B,), np.int32)
        dmap = {}
        for i in range(self.B):
            s = self.slots[i]
            if s is None or not s.ready:
                self._tokens[i] = 0
                self._positions[i] = 0
                if s is None:
                    self._block_tables[i, :] = 0  # trash block
                continue
            ent = drafts.get(i)
            # _prepare_multi may have finished or preempted the drafted
            # request: keep drafts only whose slot still holds it
            d = ent[1] if (ent is not None and ent[0] is s) else []
            self._tokens[i] = s.last_token
            self._positions[i] = s.pos
            steps[i] = s.key_step
            tokens[i, 0] = s.last_token
            tokens[i, 1:1 + len(d)] = d
            if d:
                dmap[i] = d
            n_rows[i] = 1 + len(d)
        if not dmap:
            return False           # every drafted slot churned away
        inputs = {"tokens": tokens, "positions": self._positions,
                  "tables": self._tables_for_dispatch(),
                  "seeds": self._seeds, "steps0": steps,
                  "temperature": self._samp["temperature"],
                  "top_k": self._samp["top_k"], "top_p": self._samp["top_p"]}
        self._step += 1
        did = None
        if self.recorder is not None:
            did = self.recorder.next_dispatch_id()
            self.recorder.rec(
                "verify", id=did, Tv=Tv, tokens=tokens.copy(),
                positions=self._positions.copy(),
                tables=inputs["tables"].copy(), seeds=self._seeds.copy(),
                steps=steps.copy(),
                temperature=self._samp["temperature"].copy(),
                top_k=self._samp["top_k"].copy(),
                top_p=self._samp["top_p"].copy(), n_rows=n_rows,
                reqs=[s.rid if s is not None else None
                      for s in self._ready_slots()])
        with torch.inference_mode():
            dispatch = self.verify_program.dispatch(self._variant(), inputs)
        self.spec_dispatches += 1
        self.spec_drafted_tokens += sum(len(d) for d in dmap.values())
        self._harvest_verify({"dispatch": dispatch, "tokens": tokens,
                              "n_rows": n_rows, "id": did,
                              "reqs": self._ready_slots()})
        return True

    def _harvest_verify(self, pending: dict) -> None:
        """Apply one verify dispatch: each slot's rows with lockstep
        acceptance (``_apply_verified``)."""
        toks, logprobs = self._fetch(pending["dispatch"])     # [B, Tv]
        applied = []
        for i, req in enumerate(pending["reqs"]):
            if req is None or self.slots[i] is not req:
                continue
            if req.cancelled:
                self._release_slot(req)
                self._finish_request(req, FinishReason.CANCELLED)
                applied.append((i, req.rid, 0, 0))
                continue
            rows = int(pending["n_rows"][i])
            n = self._apply_verified(i, req, pending["tokens"][i, :rows],
                                     toks[i], logprobs[i])
            applied.append((i, req.rid, n, max(n - 1, 0)))
        if self.recorder is not None and pending["id"] is not None:
            self.recorder.rec("spec_harvest", id=pending["id"],
                              toks=np.array(toks), applied=applied)
        self.flight.record(
            "verify", batch_fill=len(applied), spec_k=self.cfg.spec_k,
            emitted=sum(n for _i, _r, n, _a in applied),
            accepted=sum(a for _i, _r, _n, a in applied))

    def _apply_verified(self, i: int, req: EngineRequest, inputs,
                        toks, logprobs) -> int:
        """Walk slot ``i``'s verified rows with lockstep acceptance: row t
        wrote ``inputs[t]``'s KV (one decode step's bookkeeping) and
        sampled ``toks[t]``, which is emitted; reaching row t > 0 accepted
        draft t. The walk stops at a finish (the overrun rows are dropped)
        or at the first sample that differs from the next draft: that
        draft's row rolls back by rewind (pos never advances over it, and a
        later dispatch rewrites it before any query reads it). Returns the
        rows applied."""
        n = 0
        for t in range(len(inputs)):
            tok = int(toks[t])
            req.seq.append(int(inputs[t]))
            req.registered_blocks = self.kv_manager.register_full_blocks(
                req.blocks, req.seq, req.registered_blocks)
            req.pos += 1
            req.key_step += 1
            req.generated += 1
            req.last_token = tok
            n += 1
            self.total_decode_tokens += 1
            self.spec_emitted_tokens += 1
            if t > 0:
                self.spec_accepted_tokens += 1
            self._emit(req, tok, float(logprobs[t]))
            self._maybe_finish_after_emit(req)
            if self.slots[i] is not req:
                break              # finished: drop the overrun rows
            if t + 1 < len(inputs) and tok != int(inputs[t + 1]):
                break              # draft rejected: rewind
        return n

    def _preempt_or_finish(self, req: EngineRequest) -> None:
        """KV exhaustion policy: recompute preemption when the pool is
        contended (the request releases its blocks and re-queues with
        every emitted token appended to its prompt), else finish with
        LENGTH."""
        others = any(s is not None and s is not req for s in self.slots)
        budget_left = req.max_new_tokens - req.generated
        in_prompt = (req.lane_prompt is not None
                     and req.pos < len(req.lane_prompt))
        emitted_len = (0 if in_prompt or req.seq is None
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
        self.flight.record("preempt", rid=req.rid, generated=req.generated)
        if self.recorder is not None:
            self.recorder.rec("preempt", rid=req.rid,
                              generated=req.generated)
        if in_prompt:
            # a lane preempted mid-prompt emitted nothing: it re-queues with
            # its prompt unchanged (no recompute boundary: no sampled token
            # depended on re-derived state) and its key offset undone
            self._release_slot(req)
            req.key_step += len(req.lane_prompt) - req.pos - 1
        else:
            req.numeric_boundaries.append(req.emitted_total)
            emitted = req.seq.tokens[len(req.prompt):] if req.seq else []
            self._release_slot(req)
            req.prompt = list(req.prompt) + list(emitted) + [req.last_token]
        req.lane_prompt = None
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
        # write the registered prefix blocks back to the host tier before
        # the device copies can be evicted; the extra hold keeps them
        # until the pump's batch has committed (the pump releases it)
        if (self.offload_engine is not None and req.registered_blocks > 0
                and req.seq is not None):
            n = req.registered_blocks
            pinned = req.blocks[:n]
            self.kv_manager.pool.hold(pinned)
            try:
                self.offload_engine.enqueue(OffloadJob(
                    block_ids=list(pinned),
                    seq_hashes=list(req.seq.sequence_hashes[:n]),
                    tokens_hashes=list(req.seq.block_hashes[:n])))
            except Exception:
                # a failed enqueue must not strand the extra hold
                self.kv_manager.pool.release(pinned)
                raise
        if self.recorder is not None and req.blocks:
            self.recorder.rec("release", rid=req.rid,
                              blocks=list(req.blocks))
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
