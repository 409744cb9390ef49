"""Endpoint load scoring (a copy of ``dynamo_tpu.llm.kv_router.scoring``;
reference lib/llm/src/kv_router/scoring.rs:24-55:
`ProcessedEndpoints` — load average/stddev over kv_active_blocks) plus the
KV-tier overlap weights and the NetKV-style transfer model: a matched
prefix block is worth less the colder the tier that holds it, because
serving it costs a promote (host h2d scatter, a disk read + scatter, or a
fabric fetch over a real network link) instead of a free HBM reuse — and a
remote block is worth NOTHING when the modeled transfer loses to simply
recomputing it (NetKV, arXiv:2606.03910: score decode instances by
measured transfer cost, not overlap depth alone)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from .protocols import ForwardPassMetrics

# Per-tier overlap discount (the indexer tags each (worker, hash) with
# the announcing event's tier; KvIndexer.find_matches applies these).
# device = free HBM reuse; host = one DRAM→HBM scatter; disk = a file read + scatter — still far cheaper
# than recomputing the prefix, hence > 0; remote = a fabric fetch (peer
# RPC or object-store read) + scatter — the coldest rung that still
# beats recompute WHEN the link pays (the scheduler additionally gates
# remote credit on the transfer model below).
#
# Runtime-configurable through set_tier_weights() (the JAX package's
# `llmctl kv set-weights` key watch is not ported yet, ROADMAP A7) — the
# dict is mutated IN PLACE so module importers
# see the change without re-importing.
TIER_WEIGHTS: Dict[str, float] = {"device": 1.0, "host": 0.8, "disk": 0.5,
                                  "remote": 0.25}
_DEFAULT_TIER_WEIGHTS: Dict[str, float] = dict(TIER_WEIGHTS)


def set_tier_weights(weights: Dict[str, float]) -> Dict[str, float]:
    """Apply a (partial) weight override live (llmctl kv set-weights →
    kvtier/weights/{ns} → admin.watch_weights_loop). Unknown tiers are
    ignored; values clamp to [0, 1] (an overlap block can never be worth
    more than a device-resident one). Returns the effective table."""
    for k, v in weights.items():
        if k in TIER_WEIGHTS and v is not None:
            TIER_WEIGHTS[k] = min(max(float(v), 0.0), 1.0)
    return dict(TIER_WEIGHTS)


def reset_tier_weights() -> None:
    """Restore the defaults (test isolation)."""
    TIER_WEIGHTS.update(_DEFAULT_TIER_WEIGHTS)


def tier_weighted_depth(depth: int, tiers: Sequence[str]) -> float:
    """Effective overlap of one worker's ``depth`` leading matched blocks
    given each block's tier tag (entries beyond ``tiers`` default to
    device)."""
    total = 0.0
    for i in range(depth):
        tier = tiers[i] if i < len(tiers) else "device"
        total += TIER_WEIGHTS.get(tier, 1.0)
    return total


# ---------------------------------------------------------------------------
# NetKV transfer model: would moving the blocks beat recomputing them?
# The inputs ride ForwardPassMetrics — each worker publishes its measured
# fabric link (remote_link_gbps / remote_link_rtt_s, decay-averaged by
# llm/kv/fabric.PeerLinkTable), its KV wire density (kv_bytes_per_block)
# and its measured prefill rate (prefill_tok_per_s) — so the ROUTER
# prices a candidate's fetch with the candidate's own numbers.
# ---------------------------------------------------------------------------


def modeled_transfer_s(n_blocks: int, bytes_per_block: int, gbps: float,
                       rtt_s: float) -> float:
    """Modeled wall time to move ``n_blocks`` of KV over a link."""
    if gbps <= 0:
        return float("inf")
    return rtt_s + n_blocks * bytes_per_block / (gbps * 1e9)


def modeled_overlap_transfer_s(n_blocks: int, bytes_per_block: int,
                               gbps: float, rtt_s: float, n_layers: int,
                               hidden_s: float = 0.0) -> float:
    """Modeled EXPOSED wall time of the same move when the receiver
    consumes it as a per-layer stream (llm/kv/stream.py): scatter of
    layer l overlaps the wire time of layer l+1, so only
    max(serial/L, serial − hidden) sits on the critical path. A worker
    that published ``disagg_stream_layers == 0`` (monolithic consumer /
    old payload) is priced via n_layers ≤ 1, which degrades to
    modeled_transfer_s exactly."""
    if gbps <= 0:
        return float("inf")
    from ..kv.stream import exposed_transfer_s
    serial = n_blocks * bytes_per_block / (gbps * 1e9)
    return rtt_s + exposed_transfer_s(serial, n_layers, hidden_s)


def modeled_recompute_s(n_blocks: int, block_size: int,
                        prefill_tok_per_s: float) -> float:
    """Modeled wall time to re-prefill ``n_blocks`` worth of tokens.
    inf when the rate is unknown (no prefill measured yet) — transfer
    then wins by default, matching the fabric's optimistic admission."""
    if prefill_tok_per_s <= 0:
        return float("inf")
    return n_blocks * block_size / prefill_tok_per_s


def transfer_pays(n_blocks: int, block_size: int,
                  m: "ForwardPassMetrics") -> bool:
    """Does fetching ``n_blocks`` to the worker described by ``m`` beat
    recomputing them there? False when the worker has no fabric link."""
    if n_blocks <= 0 or m.remote_link_gbps <= 0 or m.kv_bytes_per_block <= 0:
        return False
    t = modeled_transfer_s(n_blocks, m.kv_bytes_per_block,
                           m.remote_link_gbps, m.remote_link_rtt_s)
    r = modeled_recompute_s(n_blocks, block_size, m.prefill_tok_per_s)
    return t < r


def network_adjusted_overlap(weighted: float, own_depth: int,
                             remote_depth: int, fleet_depth: int,
                             block_size: int,
                             m: "ForwardPassMetrics") -> float:
    """NetKV scoring for ONE candidate: tier-discounted overlap minus
    modeled transfer cost, in block units.

    - ``remote_depth`` matched blocks sit in the candidate's REMOTE tier
      (a fabric fetch away). Their TIER_WEIGHTS["remote"] credit stands
      only when the candidate's modeled transfer beats its modeled
      recompute — the router prefers the holder only when the fetch
      pays; otherwise those blocks are priced exactly like a miss.
    - ``fleet_depth - own_depth`` blocks exist elsewhere in the fleet;
      a fabric-attached candidate can fetch them, so they earn remote
      credit scaled by the modeled saving fraction (1 - transfer /
      recompute): a near-free link earns almost full remote weight, a
      barely-winning link earns almost nothing.
    """
    w_remote = TIER_WEIGHTS.get("remote", 0.0)
    eff = weighted
    if remote_depth > 0 and not transfer_pays(remote_depth, block_size, m):
        eff -= remote_depth * w_remote
    extra = fleet_depth - own_depth
    if extra > 0 and m.remote_link_gbps > 0 and m.kv_bytes_per_block > 0:
        # transfer_pays inlined so the t/r the saving needs aren't
        # modeled twice — this runs once per candidate per routing
        # decision, the router's hottest loop at fleet scale. A
        # candidate whose streaming plane has proven live (it published
        # a MEASURED disagg_stream_layers > 0) is priced at the exposed
        # overlapped transfer, not the serial one — streaming consumers
        # earn more fetch credit because their fetch costs less.
        layers = max(int(getattr(m, "disagg_stream_layers", 0) or 0), 1)
        t = modeled_overlap_transfer_s(extra, m.kv_bytes_per_block,
                                       m.remote_link_gbps,
                                       m.remote_link_rtt_s, layers)
        r = modeled_recompute_s(extra, block_size, m.prefill_tok_per_s)
        if t < r:
            saving = 1.0 if math.isinf(r) else max(1.0 - t / r, 0.0)
            eff += extra * w_remote * saving
    return max(eff, 0.0)


# ---------------------------------------------------------------------------
# Fleet-level fetch-vs-recompute crossover (ROADMAP KV-fabric item (c),
# second half): the planner's disagg retune consumes the fleet's
# aggregate crossover depth — there is no point pushing the disagg
# threshold BELOW the depth at which moving KV across the fabric starts
# beating recompute, because a remote prefill's payoff rides the same
# link economics the per-worker AdmissionGate prices.
# ---------------------------------------------------------------------------


def crossover_tokens(m: dict) -> Optional[float]:
    """One worker's fetch-vs-recompute crossover depth in TOKENS, from
    its published ForwardPassMetrics dict: the depth where
    rtt + tokens·(bytes_per_block/block_size)/bw  ==  tokens/rate.

    Returns None when the worker's inputs are absent (no fabric, old
    payload, rate still unknown) and +inf when its link NEVER beats
    recompute (per-token transfer >= per-token recompute)."""
    rate = float(m.get("prefill_tok_per_s", 0) or 0)
    gbps = float(m.get("remote_link_gbps", 0) or 0)
    bpb = float(m.get("kv_bytes_per_block", 0) or 0)
    bs = float(m.get("kv_block_size", 0) or 0)
    rtt = float(m.get("remote_link_rtt_s", 0) or 0)
    if rate <= 0 or gbps <= 0 or bpb <= 0 or bs <= 0:
        return None
    # a worker whose streaming handoff plane has proven live publishes
    # its measured pipeline depth (disagg_stream_layers); its exposed
    # per-token transfer is 1/L of the serial cost (llm/kv/stream.py),
    # so its crossover sits shallower. 0 (old payload / monolithic
    # consumer) prices serially — identical to the pre-streaming model.
    layers = max(int(m.get("disagg_stream_layers", 0) or 0), 1)
    per_tok_gain = 1.0 / rate - bpb / (bs * gbps * 1e9) / layers
    if per_tok_gain <= 0:
        return math.inf
    return rtt / per_tok_gain


def fleet_crossover_tokens(stats: Dict[int, dict]) -> Optional[float]:
    """Median per-worker crossover depth across the scraped fleet — the
    robust aggregate the planner's disagg retune floors at. None when no
    worker published usable inputs."""
    vals = sorted(v for v in (crossover_tokens(m) for m in stats.values())
                  if v is not None)
    if not vals:
        return None
    return vals[len(vals) // 2]


@dataclasses.dataclass
class Endpoint:
    worker_id: int
    metrics: ForwardPassMetrics

    @property
    def load(self) -> int:
        return self.metrics.kv_active_blocks


class ProcessedEndpoints:
    def __init__(self, endpoints: List[Endpoint]):
        self.endpoints: Dict[int, Endpoint] = {e.worker_id: e
                                               for e in endpoints}
        loads = [e.load for e in endpoints]
        n = len(loads)
        self.load_avg = sum(loads) / n if n else 0.0
        if n:
            var = sum((x - self.load_avg) ** 2 for x in loads) / n
            self.load_std = math.sqrt(var)
        else:
            self.load_std = 0.0

    @property
    def worker_ids(self) -> List[int]:
        return list(self.endpoints)

    def __len__(self) -> int:
        return len(self.endpoints)
