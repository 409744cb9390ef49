// Native KV block reuse pool: refcounted device blocks, prefix matching by
// chained sequence hash, priority-then-LRU eviction.
//
// A copy of the JAX package's csrc/kv_reuse_pool.cpp, built for the port by
// dynamo_tpu_torch/utils/native.py (a host library: it runs on the CPU beside
// the card). It is the C++ hot path behind dynamo_tpu_torch/llm/kv/pool.py's
// KvBlockPool — the equivalent of the reference's Rust `AvailableBlocks` /
// `ReservedBlocks` machinery (lib/llm/src/kv/reuse.rs:50-750 with its
// `PriorityKey{priority, return_tick, seq_hash}` eviction order, and
// kv/reserved.rs). Exposed as a flat C ABI consumed via ctypes; stored /
// removed events are returned to the caller (who owns event publication)
// rather than invoked as callbacks, keeping the ABI trivially safe.
//
// Single-threaded by design: one pool per engine loop, same actor
// discipline as the reference's mpsc progress engine (reuse.rs:638).

#include <cstdint>
#include <map>
#include <set>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Meta {
    uint64_t seq_hash = 0;
    uint64_t tokens_hash = 0;
    uint64_t parent_hash = 0;
    bool registered = false;
    bool has_parent = false;
    int64_t refcount = 0;
    int64_t priority = 0;
    int64_t return_tick = 0;
    bool reusable = false;
};

// eviction order: (priority asc, return_tick asc, block_id) — the
// reference's PriorityKey with block id as the deterministic tiebreak
using EvictKey = std::tuple<int64_t, int64_t, int64_t>;

// Coalescing free-run index over the uninitialized blocks: maximal runs
// of adjacent block ids with BEST-FIT allocation, the exact mirror of
// pool.py FreeRunIndex (the differential fuzz test drives both through
// identical states). Contract: best fit = smallest run with len >= n
// (ties: smallest start); no fit → take the LARGEST run (ties: smallest
// start) whole and repeat; ids hand out ascending from each run's start.
struct FreeRunIndex {
    std::map<int64_t, int64_t> start_len;          // run start -> length
    std::unordered_map<int64_t, int64_t> end_start;  // end(excl) -> start
    std::set<std::pair<int64_t, int64_t>> by_len;  // (length, start)
    int64_t count = 0;

    void insert_run(int64_t start, int64_t len) {
        start_len[start] = len;
        end_start[start + len] = start;
        by_len.insert({len, start});
    }

    void remove_run(int64_t start, int64_t len) {
        start_len.erase(start);
        end_start.erase(start + len);
        by_len.erase({len, start});
    }

    void add(int64_t bid) {
        int64_t start = bid, len = 1;
        auto l = end_start.find(bid);
        if (l != end_start.end()) {
            int64_t ls = l->second, ll = start_len[ls];
            remove_run(ls, ll);
            start = ls;
            len = ll + 1;
        }
        auto r = start_len.find(bid + 1);
        if (r != start_len.end()) {
            int64_t rl = r->second;
            remove_run(bid + 1, rl);
            len += rl;
        }
        insert_run(start, len);
        ++count;
    }

    void take(int64_t n, std::vector<int64_t>* out) {
        count -= n;
        while (n > 0) {
            int64_t start, len, got;
            auto it = by_len.lower_bound({n, INT64_MIN});
            if (it != by_len.end()) {            // best fit
                len = it->first;
                start = it->second;
                got = n;
            } else {                             // largest (tie: min start)
                int64_t max_len = by_len.rbegin()->first;
                it = by_len.lower_bound({max_len, INT64_MIN});
                len = it->first;
                start = it->second;
                got = len;
            }
            remove_run(start, len);
            if (got < len) insert_run(start + got, len - got);
            for (int64_t i = 0; i < got; ++i) out->push_back(start + i);
            n -= got;
        }
    }
};

struct Pool {
    int64_t num_blocks;
    std::vector<Meta> meta;                      // indexed by block id
    FreeRunIndex free_uninit;                    // coalescing run index
    std::unordered_map<uint64_t, int64_t> by_hash;
    std::set<EvictKey> evict_order;              // reusable blocks only
    int64_t tick = 0;
    int64_t match_queries = 0;
    int64_t match_hits = 0;
    // contiguity accounting (mirrors pool.py)
    int64_t alloc_blocks_total = 0;
    int64_t alloc_runs_total = 0;
    int64_t alloc_requests_total = 0;
    int64_t defrag_moves_total = 0;

    explicit Pool(int64_t n) : num_blocks(n), meta(n) {
        if (n > 1) {                             // one run [1, n-1]
            free_uninit.insert_run(1, n - 1);
            free_uninit.count = n - 1;
        }
    }

    EvictKey key(int64_t bid) const {
        return {meta[bid].priority, meta[bid].return_tick, bid};
    }

    void drop_reusable(int64_t bid) {
        if (meta[bid].reusable) {
            evict_order.erase(key(bid));
            meta[bid].reusable = false;
        }
    }

    // returns true (and the removed hash) when the block had registered
    // content the caller must publish as removed
    bool invalidate(int64_t bid, uint64_t* removed_hash) {
        Meta& m = meta[bid];
        drop_reusable(bid);
        bool had = false;
        if (m.registered) {
            auto it = by_hash.find(m.seq_hash);
            if (it != by_hash.end() && it->second == bid) by_hash.erase(it);
            *removed_hash = m.seq_hash;
            had = true;
        }
        m.registered = false;
        m.has_parent = false;
        return had;
    }

    int64_t evict_one(uint64_t* removed_hash, bool* had_hash) {
        auto it = evict_order.begin();
        int64_t bid = std::get<2>(*it);
        *had_hash = invalidate(bid, removed_hash);
        return bid;
    }
};

}  // namespace

extern "C" {

void* kvpool_create(int64_t num_blocks) { return new Pool(num_blocks); }

void kvpool_destroy(void* p) { delete static_cast<Pool*>(p); }

int64_t kvpool_free_blocks(void* p) {
    Pool* pool = static_cast<Pool*>(p);
    return pool->free_uninit.count +
           static_cast<int64_t>(pool->evict_order.size());
}

int64_t kvpool_reusable_blocks(void* p) {
    return static_cast<int64_t>(static_cast<Pool*>(p)->evict_order.size());
}

int64_t kvpool_match_queries(void* p) {
    return static_cast<Pool*>(p)->match_queries;
}

int64_t kvpool_match_hits(void* p) {
    return static_cast<Pool*>(p)->match_hits;
}

// Longest-prefix match with refcount holds. Writes matched block ids to
// out_bids (caller-sized >= n); returns the match count.
int64_t kvpool_match_prefix(void* p, const uint64_t* hashes, int64_t n,
                            int64_t* out_bids) {
    Pool* pool = static_cast<Pool*>(p);
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        pool->match_queries++;
        auto it = pool->by_hash.find(hashes[i]);
        if (it == pool->by_hash.end()) break;
        pool->match_hits++;
        int64_t bid = it->second;
        Meta& m = pool->meta[bid];
        if (m.refcount == 0) pool->drop_reusable(bid);
        m.refcount++;
        out_bids[count++] = bid;
    }
    return count;
}

int64_t kvpool_peek_prefix(void* p, const uint64_t* hashes, int64_t n) {
    Pool* pool = static_cast<Pool*>(p);
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (pool->by_hash.find(hashes[i]) == pool->by_hash.end()) break;
        ++count;
    }
    return count;
}

// Allocate n uninitialized blocks (refcount=1) as few maximal runs of
// adjacent ids. When the uninit index runs short, reusable blocks are
// evicted FIRST — strict priority-then-LRU, preserving the eviction
// contract — and coalesce back into the index, THEN best-fit runs are
// carved (mirror of pool.py alloc_uninit). out_bids sized >= n;
// out_removed sized >= n receives the seq hashes of evicted registered
// content (the caller publishes them as removed events), *n_removed their
// count. Returns 0 on success, -1 when even eviction can't satisfy (state
// untouched).
int64_t kvpool_alloc_uninit(void* p, int64_t n, int64_t* out_bids,
                            uint64_t* out_removed, int64_t* n_removed) {
    Pool* pool = static_cast<Pool*>(p);
    *n_removed = 0;
    if (n > kvpool_free_blocks(p)) return -1;
    for (int64_t i = pool->free_uninit.count; i < n; ++i) {
        uint64_t removed = 0;
        bool had = false;
        int64_t bid = pool->evict_one(&removed, &had);
        if (had) out_removed[(*n_removed)++] = removed;
        pool->free_uninit.add(bid);
    }
    std::vector<int64_t> out;
    out.reserve(n);
    pool->free_uninit.take(n, &out);
    int64_t runs = 0;
    for (int64_t i = 0; i < n; ++i) {
        pool->meta[out[i]].refcount = 1;
        out_bids[i] = out[i];
        if (i == 0 || out[i] != out[i - 1] + 1) ++runs;
    }
    if (n > 0) {
        pool->alloc_requests_total += 1;
        pool->alloc_blocks_total += n;
        pool->alloc_runs_total += runs;
    }
    return 0;
}

// Declare a block's content. Returns 1 when the caller should emit a
// stored event, 0 for the no-op/duplicate paths (pool.py register()).
int64_t kvpool_register(void* p, int64_t bid, uint64_t seq_hash,
                        uint64_t tokens_hash, uint64_t parent_hash,
                        int64_t has_parent, int64_t priority) {
    Pool* pool = static_cast<Pool*>(p);
    Meta& m = pool->meta[bid];
    if (m.registered && m.seq_hash == seq_hash) return 0;
    auto it = pool->by_hash.find(seq_hash);
    if (it != pool->by_hash.end() && it->second != bid) return 0;  // dup
    if (m.registered) pool->by_hash.erase(m.seq_hash);
    // re-key the eviction entry before mutating priority, or a stale
    // EvictKey would linger and later hand an in-use block to alloc
    bool was_reusable = m.reusable;
    if (was_reusable) pool->evict_order.erase(pool->key(bid));
    m.seq_hash = seq_hash;
    m.tokens_hash = tokens_hash;
    m.parent_hash = parent_hash;
    m.has_parent = has_parent != 0;
    m.registered = true;
    m.priority = priority;
    if (was_reusable) pool->evict_order.insert(pool->key(bid));
    pool->by_hash[seq_hash] = bid;
    return 1;
}

void kvpool_hold(void* p, const int64_t* bids, int64_t n) {
    Pool* pool = static_cast<Pool*>(p);
    for (int64_t i = 0; i < n; ++i)
        if (bids[i] != 0) pool->meta[bids[i]].refcount++;
}

void kvpool_release(void* p, const int64_t* bids, int64_t n) {
    Pool* pool = static_cast<Pool*>(p);
    for (int64_t i = 0; i < n; ++i) {
        int64_t bid = bids[i];
        if (bid == 0) continue;
        Meta& m = pool->meta[bid];
        if (m.refcount == 0) continue;  // double release is a no-op
        m.refcount--;
        if (m.refcount == 0) {
            m.return_tick = ++pool->tick;
            if (m.registered) {
                if (!m.reusable) {
                    m.reusable = true;
                    pool->evict_order.insert(pool->key(bid));
                }
            } else {
                pool->free_uninit.add(bid);
            }
        }
    }
}

// Drop all reusable content. out_removed sized >= num_blocks; returns the
// number of removed-hash entries written.
int64_t kvpool_reset(void* p, uint64_t* out_removed) {
    Pool* pool = static_cast<Pool*>(p);
    int64_t count = 0;
    while (!pool->evict_order.empty()) {
        int64_t bid = std::get<2>(*pool->evict_order.begin());
        uint64_t removed = 0;
        if (pool->invalidate(bid, &removed)) out_removed[count++] = removed;
        pool->free_uninit.add(bid);
    }
    return count;
}

// Contiguity / fragmentation stats, one call (mirror of pool.py's
// properties): out[0]=contig_runs, out[1]=largest_free_run,
// out[2]=free_uninit_count, out[3]=alloc_blocks_total,
// out[4]=alloc_runs_total, out[5]=alloc_requests_total,
// out[6]=defrag_moves_total. out sized >= 7.
void kvpool_layout_stats(void* p, int64_t* out) {
    Pool* pool = static_cast<Pool*>(p);
    out[0] = static_cast<int64_t>(pool->free_uninit.start_len.size());
    out[1] = pool->free_uninit.by_len.empty()
                 ? 0
                 : pool->free_uninit.by_len.rbegin()->first;
    out[2] = pool->free_uninit.count;
    out[3] = pool->alloc_blocks_total;
    out[4] = pool->alloc_runs_total;
    out[5] = pool->alloc_requests_total;
    out[6] = pool->defrag_moves_total;
}

// Live refcounts (0 for the trash block) — the defrag pass skips blocks
// shared across sequences.
void kvpool_refcounts(void* p, const int64_t* bids, int64_t n,
                      int64_t* out) {
    Pool* pool = static_cast<Pool*>(p);
    for (int64_t i = 0; i < n; ++i)
        out[i] = bids[i] == 0 ? 0 : pool->meta[bids[i]].refcount;
}

// Rebind resident blocks old→new after the engine copied their device
// contents (defrag): registrations + refcounts follow, old ids coalesce
// back into the free-run index. Mirror of pool.py relocate(); returns 0
// on success, -1 when a target is not a fresh uninit block or a source
// is not resident (state up to that pair already applied).
int64_t kvpool_relocate(void* p, const int64_t* old_bids,
                        const int64_t* new_bids, int64_t n) {
    Pool* pool = static_cast<Pool*>(p);
    for (int64_t i = 0; i < n; ++i) {
        Meta& mo = pool->meta[old_bids[i]];
        Meta& mn = pool->meta[new_bids[i]];
        if (mn.registered || mn.refcount != 1) return -1;
        if (mo.refcount < 1) return -1;
        mn.refcount = mo.refcount;
        mn.priority = mo.priority;
        mn.return_tick = mo.return_tick;
        if (mo.registered) {
            mn.seq_hash = mo.seq_hash;
            mn.tokens_hash = mo.tokens_hash;
            mn.parent_hash = mo.parent_hash;
            mn.has_parent = mo.has_parent;
            mn.registered = true;
            pool->by_hash[mn.seq_hash] = new_bids[i];
        }
        mo.registered = false;
        mo.has_parent = false;
        mo.refcount = 0;
        pool->free_uninit.add(old_bids[i]);
        ++pool->defrag_moves_total;
    }
    return 0;
}

}  // extern "C"
