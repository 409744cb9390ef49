"""Deterministic schedule recording and replay for the engine core.

Counterpart of ``dynamo_tpu.engine.replay``, with the port's programs
doing the execution. The engine's nondeterminism lives in the interleaving
of admissions and harvests with dispatches still in flight on the card
(the pipelined decode and ragged dispatches chain off device tokens, and
each graphed dispatch reads static buffers filled by a copy). Recording the
scheduler's decision log (every dispatch's host inputs, in device order)
of a live run gives two tools:

- ``replay`` re-executes the same dispatch sequence synchronously against
  a fresh pool, each dispatch's results fetched before the next is issued.
  If the replay gives the live run's tokens (``compare_replay`` empty) the
  tokens follow from the recorded schedule; if it does not, the live run
  needed real asynchronous overlap to go wrong: a static input read too
  early, or a chained token read before it was written.
- ``check_log`` simulates pool-slot ownership over the log and flags every
  dispatch that reads a KV slot last written by another request (the
  stale-read signature), and ``check_inputs`` the input-consistency
  invariants (chained positions and keys, host tokens), with no model
  evaluation.

Event kinds and fields are the JAX engine's, so the JAX package's own
``check_log`` and ``check_inputs`` read a port log. The port records
admissions (whole, chunked, lane), ``prefill`` and ``prefill_sp``, the
split K-step ``dispatch`` and its pipelined chain, ``ragged`` dispatches
(pipelined ones too), ``verify``, every harvest kind, ``first_token``,
``preempt``, ``release``, a prefix hit's ``hit_transfer`` (with a host or
disk tier restore's slots, hashes and targets) and the tiers' commits,
``kv_store`` (a host write-back batch's literal placements) and
``kv_disk_store`` (a spill batch's). The replayer mirrors both tiers: a
host pool (``offload.make_host_pool``) fed by gathering the same device
blocks from the replay's pool at each ``kv_store``, and an in-memory disk
mirror fed from the staged rows of the spilled evictions; a restore
scatters from the mirrors into the same targets. ``kv_remote_restore``
and ``handoff_gather`` wait for the remote tier and disaggregation
(ROADMAP A7), pipeline-parallel replay for pp (A9).

Recording copies small host arrays only; it does not synchronize the
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..llm.kv.offload import make_host_pool
from .block_copy import gather_blocks_to_host, scatter_blocks_from_host
from .core import sample_keyed
from .programs import (DecodeProgram, RaggedProgram, VerifyProgram,
                       sampling_variant)

# Host bookkeeping: events that carry no device-state transition, so the
# replayer executes none of them; compare_replay and check_inputs read them
HOST_EVENTS = frozenset(
    {"admit", "first_token", "harvest", "ragged_harvest", "spec_harvest",
     "preempt", "release"})


class Recorder:
    """Collects scheduler events in device-dispatch order."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self.dispatch_seq = 0

    def rec(self, ev: str, **kw) -> None:
        kw["ev"] = ev
        self.events.append(kw)

    def next_dispatch_id(self) -> int:
        self.dispatch_seq += 1
        return self.dispatch_seq


# --------------------------------------------------------------------------
# Synchronous replay of the recorded dispatch sequence
# --------------------------------------------------------------------------


class ReplayPrograms:
    """``core``'s programs over another pool ``kv`` (the replay's): the
    same weights, config, batch and buckets, each built at first use (on
    the card, its graphs captured then)."""

    def __init__(self, core, kv) -> None:
        self.core, self.kv = core, kv
        self._built: Dict[str, object] = {}

    def _get(self, name: str, build):
        if name not in self._built:
            self._built[name] = build()
        return self._built[name]

    def _args(self) -> tuple:
        c = self.core
        return (c.params, self.kv, c.model_cfg, c.cfg.kv_block_size, c.B,
                c.M)

    @property
    def decode(self) -> DecodeProgram:
        c = self.core
        return self._get("decode", lambda: DecodeProgram(
            *self._args(), c.program.max_k, c.cfg.seed, c.device))

    @property
    def verify(self) -> VerifyProgram:
        c = self.core
        return self._get("verify", lambda: VerifyProgram(
            *self._args(), c.cfg.spec_k + 1, c.cfg.seed, c.device))

    @property
    def ragged(self) -> RaggedProgram:
        c, rp = self.core, self.core.ragged_program
        return self._get("ragged", lambda: RaggedProgram(
            *self._args(), rp.capacity, rp.max_rows, c.cfg.seed, c.device,
            row_sampled=rp.row_sampled))


def _live(ev: dict) -> np.ndarray:
    return np.array([r is not None for r in ev["reqs"]], bool)


def _exec_prefill(progs: ReplayPrograms, ev: dict, sp: bool):
    """The recorded prefill (``sp``: the sequence-parallel one, which has
    no start_pos) against the replay's pool and its sample at the event's
    key. Returns the token [1] on the device."""
    core = progs.core
    dev = core.device
    tokens = torch.from_numpy(np.asarray(ev["padded"], np.int64)).to(dev)
    table = torch.from_numpy(np.asarray(ev["table"], np.int32)).to(dev)
    with torch.inference_mode():
        if sp:
            logits = core.model_mod.prefill_forward_sp(
                core.params, progs.kv, tokens, table, int(ev["true_len"]),
                core.model_cfg, core.cfg.kv_block_size, core.mesh,
                replicas=core._replicas)
        else:
            logits = core.model_mod.prefill_forward(
                core.params, progs.kv, tokens, table, int(ev["start_pos"]),
                int(ev["true_len"]), core.model_cfg,
                core.cfg.kv_block_size)
        tok, _ = sample_keyed(
            logits[None, :], core.cfg.seed,
            [(float(ev["temp"]), int(ev["top_k"]), float(ev["top_p"]),
              int(ev["samp_seed"]), int(ev["key_step"]))], dev)
    return tok


def exec_prefill_event(progs: ReplayPrograms, ev: dict):
    return _exec_prefill(progs, ev, sp=False)


def exec_sp_prefill_event(progs: ReplayPrograms, ev: dict):
    return _exec_prefill(progs, ev, sp=True)


def exec_dispatch_event(progs: ReplayPrograms, ev: dict, chain):
    """Issue the recorded K-step decode dispatch. ``chain``: the
    chained-from dispatch's [K, B] device tokens (None when host-fed).
    Returns the dispatch (``programs.Dispatch``)."""
    K = int(ev["K"])
    inputs = {"tokens": ev["tokens"], "chain_mask": ev["mask"],
              "positions": ev["positions"], "tables": ev["tables"],
              "seeds": ev["seeds"], "steps0": ev["steps"],
              "temperature": ev["temperature"], "top_k": ev["top_k"],
              "top_p": ev["top_p"], "planned": ev.get("planned"),
              "planned_mask": ev.get("planned_mask")}
    variant = sampling_variant(np.asarray(ev["temperature"]),
                               np.asarray(ev["top_k"]),
                               np.asarray(ev["top_p"]), _live(ev))
    with torch.inference_mode():
        return progs.decode.dispatch(
            K, variant, inputs,
            chain=chain[-1] if ev["chained_from"] is not None else None)


def exec_verify_event(progs: ReplayPrograms, ev: dict):
    """Issue the recorded speculative verify dispatch. Returns the
    dispatch, whose toks are [B, Tv]."""
    core = progs.core
    Tv = np.asarray(ev["tokens"]).shape[1]
    if core.cfg.spec_k + 1 != Tv:
        raise NotImplementedError(
            f"recorded verify dispatch has {Tv} rows a slot but this core "
            f"was built with spec_k={core.cfg.spec_k} — replay with the "
            f"recorded engine config")
    inputs = {"tokens": ev["tokens"], "positions": ev["positions"],
              "tables": ev["tables"], "seeds": ev["seeds"],
              "steps0": ev["steps"], "temperature": ev["temperature"],
              "top_k": ev["top_k"], "top_p": ev["top_p"]}
    variant = sampling_variant(np.asarray(ev["temperature"]),
                               np.asarray(ev["top_k"]),
                               np.asarray(ev["top_p"]), _live(ev))
    with torch.inference_mode():
        return progs.verify.dispatch(variant, inputs)


def exec_ragged_event(progs: ReplayPrograms, ev: dict, chain=None):
    """Issue the recorded ragged dispatch. ``chain``: the chained-from
    dispatch's device tokens for a pipelined event (None when host-fed).
    Returns the dispatch, whose toks are [B + 1] or, row-sampled, a row
    bucket's."""
    core = progs.core
    if core.ragged_program is None:
        raise NotImplementedError(
            "recorded ragged dispatch but this core was built without "
            "ragged_dispatch — replay with the recorded engine config")
    T = np.asarray(ev["tokens"]).shape[0]
    if core.cfg.ragged_max_tokens != T:
        raise NotImplementedError(
            f"recorded ragged dispatch has {T} token rows but this core "
            f"was built with ragged_max_tokens={core.cfg.ragged_max_tokens}"
            f" — replay with the recorded engine config")
    # the steps' shape marks the program: [B + 1] slot steps, or [T] row
    # steps of the row-sampled one (spec_k > 0)
    row_sampled = np.asarray(ev["steps"]).shape[0] == T
    if row_sampled != core.ragged_program.row_sampled:
        raise NotImplementedError(
            f"recorded ragged dispatch was "
            f"{'row' if row_sampled else 'slot'}-sampled but this core "
            f"was built with spec_k={core.cfg.spec_k} — replay with the "
            f"recorded engine config")
    inputs = {"tokens": ev["tokens"], "positions": ev["positions"],
              "row_slot": ev["row_slot"], "tables": ev["tables"],
              "seq_starts": ev["starts"], "seq_counts": ev["counts"],
              "sample_rows": ev["sample_rows"], "seeds": ev["seeds"],
              "steps": ev["steps"], "temperature": ev["temperature"],
              "top_k": ev["top_k"], "top_p": ev["top_p"]}
    chained = ev.get("chained_from") is not None
    if chained:
        inputs["chain_mask"], inputs["srows"] = ev["mask"], ev["srows"]
    temperature = np.asarray(ev["temperature"])
    # spans that do not sample carry temperature 0 and no top-k / top-p,
    # so every row may stand in the variant's predicate
    variant = sampling_variant(temperature, np.asarray(ev["top_k"]),
                               np.asarray(ev["top_p"]),
                               np.ones(temperature.shape, bool))
    with torch.inference_mode():
        return progs.ragged.dispatch(variant, inputs,
                                     chain=chain if chained else None)


def exec_kv_store_event(kv, ev: dict, pool, block_size: int,
                        spill_stage: Optional[dict] = None) -> None:
    """Mirror one of the live engine's write-back commits: gather the SAME
    device blocks from ``kv`` (bit-identical by the replay induction) and
    apply the literal hash→slot placements to the mirror ``pool``.
    ``spill_stage``: where the live engine runs a disk tier, the event's
    ``spills`` names the evicted hashes its spill queue accepted; a copy
    of each such row, read from the mirror BEFORE the eviction overwrites
    it, is staged by hash for the later ``kv_disk_store``."""
    spills = set(ev.get("spills") or ())
    ids = [int(it[3]) for it in ev["items"]]
    values = gather_blocks_to_host(kv, ids, block_size, pool.num_kv_heads)
    for i, (h, hslot, evicted, _bid) in enumerate(ev["items"]):
        if (spill_stage is not None and evicted is not None
                and evicted in spills):
            vslot = pool._by_hash.get(evicted)
            if vslot is not None and pool._arena is not None:
                spill_stage[evicted] = pool.row_copy(vslot)
        pool.apply_store(h, hslot, evicted,
                         {key: arr[:, :, i] for key, arr in values.items()})


def exec_kv_disk_store_event(ev: dict, disk_store, pool,
                             spill_stage: dict) -> None:
    """Apply one of the live engine's spill commits to a mirror store: the
    literal placements (hash and eviction set), the bytes from the staged
    row copy (an eviction's spill) or from the host mirror (a flush's: the
    row is still resident there). Never re-runs the LRU policy."""
    for h, th, ph, evicted in ev["items"]:
        values = spill_stage.pop(h, None)
        if values is None:
            slot = pool._by_hash.get(h) if pool is not None else None
            if slot is None:
                raise ValueError(
                    f"kv_disk_store for hash {h:#x} has no staged row copy "
                    f"and no host-mirror residence — the kv_store spills "
                    f"list and this mirror diverged")
            values = pool.row_copy(slot)
        disk_store.apply_put(h, list(evicted), values, tokens_hash=th,
                             parent_hash=ph)


def exec_host_restore_event(kv, ev: dict, pool, block_size: int,
                            disk_store=None) -> None:
    """Re-execute a host / disk tier restore from the mirror tiers: the
    same slots and hashes into the same device targets, in place."""
    parts = []
    targets: list = []
    if ev.get("host_slots"):
        parts.append(pool.fetch(list(ev["host_slots"])))
        targets += list(ev["host_targets"])
    if ev.get("disk_hashes"):
        if disk_store is None:
            raise ValueError(
                "hit_transfer references disk-tier hashes but no mirror "
                "disk store was provided — replay with the recorded "
                "engine config (kv_disk_dir/kv_disk_blocks)")
        parts.append(disk_store.fetch(list(ev["disk_hashes"])))
        targets += list(ev["disk_targets"])
    vals = (parts[0] if len(parts) == 1 else
            {k: torch.cat([p[k] for p in parts], dim=2) for k in parts[0]})
    scatter_blocks_from_host(kv, targets, vals, block_size)


class _MemDiskMirror:
    """In-memory stand-in for ``DiskKvStore`` in a replay (the replayer
    applies the live engine's literal disk placements; durability is the
    live store's concern): ``apply_put`` / ``fetch`` / ``contains``."""

    def __init__(self) -> None:
        self._blocks: Dict[int, dict] = {}

    def apply_put(self, h, evicted, values, tokens_hash=None,
                  parent_hash=None) -> None:
        for e in evicted:
            self._blocks.pop(e, None)
        self._blocks[h] = values

    def contains(self, h) -> bool:
        return h in self._blocks

    def fetch(self, hashes) -> dict:
        blocks = [self._blocks[h] for h in hashes]
        return {k: torch.stack([b[k] for b in blocks], dim=2)
                for k in blocks[0]}


def _pool_slots(table, positions, bs: int):
    return (int(table[p // bs]) * bs + p % bs for p in positions)


def replay(core, events: List[dict], fingerprint: bool = False) -> dict:
    """Re-execute the recorded schedule against a fresh pool, each dispatch
    fetched before the next is issued. ``core`` supplies the weights,
    config and programs' shapes (its own pool is untouched). Returns
    {"prefill": {pf_seq: tok}, "dispatch": {id: [K, B]}, "verify": {id:
    [B, Tv]}, "ragged": {id: toks}, "fingerprints": [(label, digest),
    ...]}."""
    bs = core.cfg.kv_block_size
    # the pool's layout must be the recording core's (an int8 pool replayed
    # over a bf16 one would report phantom divergence)
    kv = core.model_mod.init_kv_cache(
        core.model_cfg, core.cfg.num_kv_blocks, bs, core.device, core.dtype,
        quantization=core.cfg.kv_quantization)
    progs = ReplayPrograms(core, kv)
    out = {"prefill": {}, "dispatch": {}, "verify": {}, "ragged": {},
           "fingerprints": []}
    mirror = None          # the host-tier mirror, built at the first kv_store
    mirrored_slots: set = set()
    disk_mirror = None     # the disk mirror, built at the first kv_disk_store
    spill_stage: dict = {}
    disp_toks: Dict[int, torch.Tensor] = {}
    # pool slots written by in-log events: a prefix hit whose blocks were
    # registered before recording began has no in-log writer, and the fresh
    # pool holds zeros there
    written: set = set()

    def fp(label):
        if not fingerprint:
            return
        h = hashlib.blake2b(digest_size=16)
        for key in sorted(kv):
            h.update(kv[key].contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        out["fingerprints"].append((label, h.hexdigest()))

    def done(did, dispatch, kind):
        # the results on the host before the next dispatch; the device
        # tokens kept apart from the program's static outputs, which the
        # next replay of the same graph overwrites
        toks = dispatch.fetch()[0]
        disp_toks[did] = dispatch.toks.clone()
        out[kind][did] = np.array(toks)

    for ev in events:
        kind = ev["ev"]
        if kind in HOST_EVENTS:
            continue
        if kind == "kv_store":
            if mirror is None:
                if core.cfg.host_kv_blocks <= 0:
                    raise NotImplementedError(
                        "the record offloaded to a host tier but the "
                        "replaying core has host_kv_blocks=0 — replay "
                        "with the recorded engine config")
                pool_t = next(iter(core.kv.values()))
                mirror = make_host_pool(
                    core.cfg.host_kv_blocks, core.model_cfg, bs,
                    core.cfg.kv_quantization, int(pool_t.shape[-1]),
                    pool_t.dtype)
            for b in (int(it[3]) for it in ev["items"]):
                if any(b * bs + o not in written for o in range(bs)):
                    raise NotImplementedError(
                        f"kv_store gathers block {b} with no in-log writer "
                        f"— start recording before any blocks are stored")
            exec_kv_store_event(kv, ev, mirror, bs, spill_stage=spill_stage)
            mirrored_slots.update(int(it[1]) for it in ev["items"])
            continue
        if kind == "kv_disk_store":
            if disk_mirror is None:
                disk_mirror = _MemDiskMirror()
            exec_kv_disk_store_event(ev, disk_mirror, mirror, spill_stage)
            continue
        if kind == "hit_transfer":
            if int(ev.get("disk_hit", 0)) > 0 and disk_mirror is None:
                raise NotImplementedError(
                    f"disk-restored hit for rid={ev.get('rid')} with no "
                    f"in-log kv_disk_store — those spills happened before "
                    f"recording began")
            missing = [s for s in ev.get("host_slots") or ()
                       if s not in mirrored_slots]
            if missing:
                raise NotImplementedError(
                    f"host-restored hit for rid={ev.get('rid')} reads host "
                    f"slots {missing[:4]} with no in-log kv_store — those "
                    f"write-backs happened before recording began")
            if ev.get("host_slots") or ev.get("disk_hashes"):
                exec_host_restore_event(kv, ev, mirror, bs,
                                        disk_store=disk_mirror)
                written.update(
                    int(b) * bs + o
                    for b in (list(ev.get("host_targets") or [])
                              + list(ev.get("disk_targets") or []))
                    for o in range(bs))
                fp(("tier_restore", ev.get("rid")))
            for p, ps in enumerate(_pool_slots(ev["blocks"],
                                               range(int(ev["hit"])), bs)):
                if ps not in written:
                    raise NotImplementedError(
                        f"prefix hit for rid={ev.get('rid')} reads pool "
                        f"slot {ps} (kv position {p}) with no in-log "
                        f"writer — its blocks were registered before "
                        f"recording began; start recording before any "
                        f"prefix blocks are stored")
        elif kind in ("prefill", "prefill_sp"):
            tok = (exec_prefill_event(progs, ev) if kind == "prefill"
                   else exec_sp_prefill_event(progs, ev))
            out["prefill"][ev["pf_seq"]] = int(tok[0])
            start = int(ev.get("start_pos", 0))     # sp: always 0
            written.update(_pool_slots(
                ev["table"], range(start, start + int(ev["true_len"])), bs))
            fp(("prefill", ev["pf_seq"]))
        elif kind == "dispatch":
            chain = (disp_toks[ev["chained_from"]]
                     if ev["chained_from"] is not None else None)
            done(ev["id"], exec_dispatch_event(progs, ev, chain), "dispatch")
            K = int(ev["K"])
            for i, rid in enumerate(ev["reqs"]):
                if rid is not None:
                    p0 = int(ev["positions"][i])
                    written.update(_pool_slots(ev["tables"][i],
                                               range(p0, p0 + K), bs))
            fp(("dispatch", ev["id"]))
        elif kind == "ragged":
            chain = (disp_toks[ev["chained_from"]]
                     if ev.get("chained_from") is not None else None)
            done(ev["id"], exec_ragged_event(progs, ev, chain), "ragged")
            counts, starts = ev["counts"], ev["starts"]
            for slot in range(len(counts)):
                rows = range(int(starts[slot]),
                             int(starts[slot]) + int(counts[slot]))
                written.update(_pool_slots(
                    ev["tables"][slot],
                    (int(ev["positions"][r]) for r in rows), bs))
            fp(("ragged", ev["id"]))
        elif kind == "verify":
            # every row (accepted, rejected, pad) wrote its position's
            # slot; a stale row is rewritten before any read, as live
            done(ev["id"], exec_verify_event(progs, ev), "verify")
            for i, rid in enumerate(ev["reqs"]):
                if rid is not None:
                    p0 = int(ev["positions"][i])
                    written.update(_pool_slots(
                        ev["tables"][i], range(p0, p0 + int(ev["n_rows"][i])),
                        bs))
            fp(("verify", ev["id"]))
        else:
            raise NotImplementedError(
                f"recorded event {kind!r} has no replay in this package")
    return out


def compare_replay(events: List[dict], replayed: dict) -> List[str]:
    """Diff the live run's harvested tokens and first tokens against the
    synchronous replay. Returns human-readable mismatch lines."""
    diffs = []
    kinds = {"harvest": ("dispatch", "(k,slot)"),
             "spec_harvest": ("verify", "(slot,row)"),
             "ragged_harvest": ("ragged", "slots")}
    for ev in events:
        if ev["ev"] in kinds:
            key, where = kinds[ev["ev"]]
            rep = replayed.get(key, {}).get(ev["id"])
            if rep is None:
                continue
            live = np.asarray(ev["toks"])
            if not np.array_equal(live, rep):
                bad = np.argwhere(live != rep)
                diffs.append(
                    f"{key} {ev['id']}: live != replay at {where} "
                    f"{bad.tolist()} live={live.tolist()} "
                    f"replay={rep.tolist()}")
        elif ev["ev"] == "first_token":
            rep = replayed["prefill"].get(ev["pf_seq"])
            if rep is not None and rep != ev["tok"]:
                diffs.append(
                    f"prefill {ev['pf_seq']} ({ev['rid']}): live tok "
                    f"{ev['tok']} != replay {rep}")
    return diffs


# --------------------------------------------------------------------------
# Pure log analysis: pool-slot ownership and stale-read detection
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StaleRead:
    dispatch_id: int
    slot: int
    rid: str
    kv_pos: int
    pool_slot: int
    writer: Optional[str]

    def __str__(self) -> str:
        return (f"dispatch {self.dispatch_id} slot {self.slot} ({self.rid}) "
                f"reads kv position {self.kv_pos} from pool slot "
                f"{self.pool_slot}, last written by {self.writer!r}")


def check_log(events: List[dict], block_size: int) -> List[StaleRead]:
    """Simulate each pool slot's last writer over the recorded device order
    and report reads of slots whose last writer is another request.

    A prefill writes positions start_pos..start_pos+true_len-1 through its
    table and reads those before; a K-step dispatch, for each live slot,
    writes positions p..p+K-1 and at step k reads every position <= p+k; a
    verify dispatch is n_rows[i] such steps a slot, and a ragged dispatch
    counts[slot] of them. A prefix hit hands read rights over the shared
    positions to its request. Writes to the trash block (id 0) are
    ignored."""
    last_writer: Dict[int, str] = {}
    stale: List[StaleRead] = []

    def write(pool_slot: int, rid: str) -> None:
        if pool_slot // block_size != 0:       # trash block: ignore
            last_writer[pool_slot] = rid

    def read(did: int, slot: int, rid: str, table, p: int) -> None:
        for q, qs in enumerate(_pool_slots(table, range(p + 1),
                                           block_size)):
            w = last_writer.get(qs)
            if w is not None and w != rid:
                stale.append(StaleRead(did, slot, rid, q, qs, w))

    for ev in events:
        kind = ev["ev"]
        if kind == "hit_transfer":
            for ps in _pool_slots(ev["blocks"], range(int(ev["hit"])),
                                  block_size):
                write(ps, ev["rid"])
        elif kind in ("prefill", "prefill_sp"):
            table, rid = ev["table"], ev["rid"]
            start = int(ev.get("start_pos", 0))
            n = int(ev["true_len"])
            for p, ps in enumerate(_pool_slots(table, range(start + n),
                                               block_size)):
                if p >= start:
                    write(ps, rid)
                else:
                    w = last_writer.get(ps)
                    if w is not None and w != rid:
                        stale.append(StaleRead(-1, -1, rid, p, ps, w))
        elif kind == "ragged":
            tables, positions = ev["tables"], ev["positions"]
            starts, counts = ev["starts"], ev["counts"]
            for i, rid in enumerate(ev["reqs"]):
                if rid is None or int(counts[i]) == 0:
                    continue
                for r in range(int(counts[i])):
                    p = int(positions[int(starts[i]) + r])
                    write(next(_pool_slots(tables[i], (p,), block_size)),
                          rid)
                    read(ev["id"], i, rid, tables[i], p)
        elif kind in ("dispatch", "verify"):
            for i, rid in enumerate(ev["reqs"]):
                if rid is None:
                    continue
                K = (int(ev["K"]) if kind == "dispatch"
                     else int(ev["n_rows"][i]))
                p0 = int(ev["positions"][i])
                for p in range(p0, p0 + K):
                    write(next(_pool_slots(ev["tables"][i], (p,),
                                           block_size)), rid)
                    read(ev["id"], i, rid, ev["tables"][i], p)
    # dedupe (the same slot is re-read every later step)
    seen = set()
    uniq = []
    for s in stale:
        key = (s.rid, s.kv_pos, s.pool_slot, s.writer)
        if key not in seen:
            seen.add(key)
            uniq.append(s)
    return uniq


def check_inputs(events: List[dict]) -> List[str]:
    """Input-consistency invariants over the log, rebuilt from the admit,
    first-token, dispatch and harvest events alone: a chained dispatch runs
    its ahead steps on positions and keys and maps its slots to the
    chained-from dispatch's requests; a host-fed one feeds the request's
    last harvested token at its current position and key."""
    problems = []
    state: Dict[str, dict] = {}       # rid -> {pos, key_step, last}
    disp: Dict[int, dict] = {}
    rag_disp: Dict[int, dict] = {}
    for ev in events:
        kind = ev["ev"]
        if kind == "admit":
            state[ev["rid"]] = {"pos": ev["pos"], "key_step": ev["key_step"],
                                "last": None}  # the first token may lag
        elif kind == "first_token":
            if ev["rid"] in state:
                state[ev["rid"]]["last"] = ev["tok"]
        elif kind == "dispatch":
            disp[ev["id"]] = ev
            positions, steps = ev["positions"], ev["steps"]
            tokens, mask = ev["tokens"], ev["mask"]
            if ev["chained_from"] is not None:
                src = disp.get(ev["chained_from"])
                for i, rid in enumerate(ev["reqs"]):
                    if mask[i] and (src is None or src["reqs"][i] != rid):
                        problems.append(
                            f"dispatch {ev['id']} slot {i} chained but "
                            f"chained-from mapping differs")
            pm = ev.get("planned_mask")
            for i, rid in enumerate(ev["reqs"]):
                if rid is None or rid not in state:
                    continue
                st = state[rid]
                ahead = int(ev["K"]) if mask[i] else 0
                if int(positions[i]) != st["pos"] + ahead:
                    problems.append(
                        f"dispatch {ev['id']} slot {i} ({rid}): position "
                        f"{int(positions[i])} != state {st['pos']}+{ahead}")
                if int(steps[i]) != st["key_step"] + ahead:
                    problems.append(
                        f"dispatch {ev['id']} slot {i} ({rid}): key step "
                        f"{int(steps[i])} != state {st['key_step']}+{ahead}")
                planned_first = bool(pm is not None and pm[0][i])
                if (not mask[i] and not planned_first
                        and st["last"] is not None
                        and int(tokens[i]) != st["last"]):
                    problems.append(
                        f"dispatch {ev['id']} slot {i} ({rid}): host token "
                        f"{int(tokens[i])} != last harvested {st['last']}")
        elif kind == "verify":
            for i, rid in enumerate(ev["reqs"]):
                if rid is None or rid not in state:
                    continue
                st = state[rid]
                if int(ev["positions"][i]) != st["pos"]:
                    problems.append(
                        f"verify {ev['id']} slot {i} ({rid}): position "
                        f"{int(ev['positions'][i])} != state {st['pos']}")
                if int(ev["steps"][i]) != st["key_step"]:
                    problems.append(
                        f"verify {ev['id']} slot {i} ({rid}): key step "
                        f"{int(ev['steps'][i])} != state {st['key_step']}")
                if (st["last"] is not None
                        and int(ev["tokens"][i][0]) != st["last"]):
                    problems.append(
                        f"verify {ev['id']} slot {i} ({rid}): row-0 token "
                        f"{int(ev['tokens'][i][0])} != last harvested "
                        f"{st['last']}")
        elif kind == "ragged":
            rag_disp[ev["id"]] = ev
            positions, starts = ev["positions"], ev["starts"]
            counts, steps = ev["counts"], ev["steps"]
            row_sampled = len(steps) == len(positions)
            mask = ev["mask"] if ev.get("chained_from") is not None else None
            for i, rid in enumerate(ev["reqs"]):
                if rid is None or rid not in state or int(counts[i]) == 0:
                    continue
                st = state[rid]
                # a chained span runs one un-harvested token ahead
                ahead = int(mask is not None and mask[int(starts[i])])
                p0 = int(positions[int(starts[i])])
                if p0 != st["pos"] + ahead:
                    problems.append(
                        f"ragged {ev['id']} slot {i} ({rid}): first-row "
                        f"position {p0} != state {st['pos']}+{ahead}")
                if row_sampled:
                    got, want = (int(steps[int(starts[i])]),
                                 st["key_step"] + ahead)
                else:
                    # the span's last row samples at key_step + len - 1
                    got, want = (int(steps[i]), st["key_step"] + ahead
                                 + int(counts[i]) - 1)
                if got != want:
                    problems.append(
                        f"ragged {ev['id']} slot {i} ({rid}): key step "
                        f"{got} != state {want}")
        elif kind == "ragged_harvest":
            toks = np.asarray(ev["toks"])
            src = rag_disp.get(ev["id"])
            for slot, rid, n, emitted in ev["applied"]:
                if rid not in state:
                    continue
                st = state[rid]
                st["pos"] += n
                st["key_step"] += n
                if emitted and n > 0:
                    if src is not None and len(src["steps"]) == len(
                            src["positions"]):
                        # row-sampled: the last applied row's token (a spec
                        # span may rewind before its end)
                        st["last"] = int(toks[int(src["starts"][slot])
                                              + n - 1])
                    else:
                        st["last"] = int(toks[slot])
        elif kind == "harvest":
            toks = np.asarray(ev["toks"])
            for slot, rid, n in ev["applied"]:
                if rid in state:
                    st = state[rid]
                    st["pos"] += n
                    st["key_step"] += n
                    if n > 0:
                        st["last"] = int(toks[n - 1, slot])
        elif kind == "spec_harvest":
            toks = np.asarray(ev["toks"])      # [B, Tv]
            for slot, rid, n, _accepted in ev["applied"]:
                if rid in state:
                    st = state[rid]
                    st["pos"] += n
                    st["key_step"] += n
                    if n > 0:
                        st["last"] = int(toks[slot, n - 1])
        elif kind == "preempt":
            state.pop(ev["rid"], None)
    return problems
