"""Ring attention: sequence-parallel causal attention over the mesh's sp
axis, for long-prompt prefill.

Counterpart of ``dynamo_tpu.parallel.ring_attention.ring_attention`` for
the llama family, with its flash hop body. The sequence is a list of sp
shards, shard r on mesh device r (JAX: one array sharded by
``shard_map``). At hop s shard r holds the KV chunk that shard
src = (r - s) % sp computed, runs one partial attention hop against it
(``engine.attention.flash_prefill_partial``: K2 on the card, its plain
version on the CPU, which is the JAX "dense" hop's arithmetic) and merges
the partial into its running (acc, m, l) with the online-softmax
recurrence in plain PyTorch, as JAX runs that merge in XLA outside the
kernel. Then each shard passes its chunk on to shard r + 1 (JAX's
``lax.ppermute``; here ``.to`` the next device, no copy when it is the
same device). The result is exact, not an approximation.

The MLA ring (``ring_attention_mla``) waits for the MLA family (ROADMAP
A7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..engine.attention import flash_prefill_partial
from .sharding import Mesh

__all__ = ["ring_attention"]


def _merge(state: tuple, part: tuple) -> tuple:
    acc, m, l = state
    acc_c, m_c, l_c = part
    m_new = torch.maximum(m, m_c)
    a_old = torch.exp(m - m_new)
    a_new = torch.exp(m_c - m_new)
    return (acc * a_old[..., None] + acc_c * a_new[..., None], m_new,
            l * a_old + l_c * a_new)


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor], mesh: Mesh, *, scale: float,
                   kv_len: Optional[int] = None) -> List[torch.Tensor]:
    """Causal attention of a sequence sharded over the sp axis: q, k, v
    are lists of sp shards ``[Tl, H, Dh]`` / ``[Sl, KVH, Dh]`` in ring
    order, shard r on ``mesh.devices[r]`` at global positions r*Tl...;
    keys at or past ``kv_len`` (default: all sp*Sl) are masked. Returns
    the output shards ``[Tl, H, Dh]`` in q's dtype, on their devices."""
    n = mesh.shape["sp"]
    if not len(q) == len(k) == len(v) == n:
        raise ValueError(f"ring_attention: {len(q)}/{len(k)}/{len(v)} "
                         f"q/k/v shards for an sp axis of {n}")
    Tl, Sl = q[0].shape[0], k[0].shape[0]
    total = n * Sl if kv_len is None else int(kv_len)
    k, v = list(k), list(v)
    state: List[Optional[tuple]] = [None] * n
    for s in range(n):
        for r in range(n):
            src = (r - s) % n              # the shard that computed this chunk
            part = flash_prefill_partial(
                q[r], k[r], v[r], scale=scale, start_pos=r * Tl - src * Sl,
                seq_len=min(max(total - src * Sl, 0), Sl))
            # merging into the empty state (m = NEG_INF, l = acc = 0) gives
            # the hop's partial bit for bit
            state[r] = part if state[r] is None else _merge(state[r], part)
        if s < n - 1:
            k = [k[r - 1].to(mesh.devices[r], non_blocking=True)
                 for r in range(n)]
            v = [v[r - 1].to(mesh.devices[r], non_blocking=True)
                 for r in range(n)]
    return [(acc / torch.clamp(l, min=1e-20)[..., None]).to(qr.dtype)
            for qr, (acc, _, l) in zip(q, state)]
