#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

``python3 chip_smoke.py --ab DIR`` runs only phase 3's attention kernels
(K1-K4 at the 8B shapes) and phase 3m's latent kernels of the checkout at
DIR (another commit, unpacked with ``git archive``) and of this checkout
in turns on the one card, and prints their times and ratios
(``ab_compare``): a change's effect on the kernels, read within one run;
it fails unless K3 and K4 give the same output bits in every turn at the
GQA groups both checkouts compile. ``python3 chip_smoke.py --ab DIR
latent`` times the latent kernels alone; ``python3 chip_smoke.py --ab DIR
serve`` runs phases 4m and 5m of both checkouts in the same turns instead
(``ab_serve``).

Phases, each failing the run (non-zero exit, no result line) on error:

1. card: name and power limit (nvidia-smi), torch's device name;
2. build: compile the CUDA kernels from ``dynamo_tpu_torch/csrc`` (six
   sources, one nvcc each, all started together) and print nvcc's
   register / shared-memory / spill lines;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the Llama-3-8B shapes, with planted faults that the limit must
   reject, and time kernel, plain version, one PyTorch call as the library
   yardstick, and the card's bound for the same work (K1 on a fresh
   prompt, a prefix hit, a padded bucket and the 1900-token prompt of
   phase 4, K2 on five ring hops with its m and l held to limits of their
   own, K3 bf16 and int8 on a mixed 8-slot batch with repeated bits and a
   planted fault in its split merge, on and around the split boundaries,
   and on a full batch of 8 x 2048 keys, K5 at 1, 2, 4 and 8 rows with
   repeated bits, K6 at the four 8B layer shapes for 1, 8, 16, 17 and 512
   rows with repeated bits and, where it splits the contraction, its own
   partials merged in plain PyTorch and a planted fault that leaves one
   split out of that merge, K4
   bf16 and int8 on a ragged mix of prefill chunks and decode rows with
   repeated bits and a planted fault in its split merge, on and around
   the split boundaries, and on a full ragged batch of 8 slots at 2048
   keys); then the ring over 2 and 4 shards on the one card against K1
   over the whole sequence, with a dropped hop planted;
4. model: the 8B geometry (random weights from a seed, on the card) runs
   one prefill and 4 decode steps through the kernels and through the
   plain versions, in three modes: bf16, int4 weights over an int8 KV
   pool, and int8 weights over a bf16 pool; the logits must agree, and a
   planted fault in each kernel of the mode must not; one decode step of
   each mode is profiled, and the sampler's noise is timed. In bf16 and
   int4 + int8 KV the same weights then run two ragged dispatches (the
   second mixes a decode row, a chunk continuing a prefix and a fresh
   chunk) through K4 and through the plain versions, with a planted K4
   fault, and one pure-decode ragged dispatch of 8 rows is profiled beside
   the split decode step over the same rows (device time and kernel count
   of the step, with K3's, K4's, K5's and K6's share). The bf16 weights
   also run the sequence-parallel prefill (sp = 2 on the one card, 1900 of
   2048 tokens) through K2 against the whole-prompt prefill through K1,
   over a bf16 and an int8 pool, with a dropped ring hop planted, and both
   prefills are timed and profiled (K1's and K2's device time among them).
   In each mode the decode program (``engine/programs.py``) replays its
   CUDA graph at K = 1 and K = 8 against the same program run eagerly
   (live slots' tokens, logprobs and logits and the pool, bit for bit),
   K = 8 against eight K = 1 dispatches (the same tokens), a planted
   fault (static inputs left stale) must be caught, and wall / device /
   launches per token are read for the eager step, the graphed K = 1
   step and the K = 8 dispatch. In the ragged modes the ragged program
   (``check_ragged_program``) replays its graph at both row buckets (a
   pure-decode dispatch of a row a slot, and the mixed dispatch at the
   capacity) against the same program run eagerly (live slots' tokens,
   logprobs and logits and the pool, bit for bit), a stale static input
   must be caught, two chained pure-decode dispatches must give the
   tokens of two host-fed ones, the graphs' memory in the program's one
   pool is read beside each graph in a pool of its own, and wall / device
   / launches of the pure-decode dispatch and of a 64-row chunk ending at
   key min(3000, the table) beside decode rows (PR 13's mixed shape) are
   read eager against graphed (in 4-4q alike);
5. serve: the port's HTTP server answers concurrent, streamed,
   prefix-cached and sampled ``/v1/completions`` at the 8B width in bf16,
   with the kernels' launch counts taken over this phase alone;
5b. serve quantized: the same server with ``--quantization int4
   --kv-quantization int8`` answers concurrent greedy, streamed and seeded
   sampled completions, with the launch counts taken over this phase
   alone;
5c. serve ragged: phase 5's requests with ``--ragged``: every admission
   and decode step goes through K4 (K1 and K3 launch 0 times), every
   ragged dispatch is a graph replay of the ragged program (0 eager; the
   replays, captures and capture seconds are printed), some dispatches
   mix prefill and decode rows, a seeded request gives the same text
   twice, and the ragged metrics are printed;
5d. serve ragged quantized: phase 5b's requests with ``--ragged
   --quantization int4 --kv-quantization int8``, checked as 5c;
5e. serve sp: phase 5's requests on a server whose mesh places sp = 2
   shards on the one card: the 700-, 1500- and 1900-token prompts prefill
   through the ring (K2), the others through K1; a seeded request gives
   the same text twice; each stream's TTFT/ITL is printed beside phase
   5's, with the share of greedy tokens the two servers agree on;
5f. serve dispatch modes: phase 5b's requests, a 1500-token prompt and a
   64-token stream posted while the others decode, on a server with
   ``--decode-steps-per-dispatch 8 --decode-dispatch-pipeline
   --lane-prefill-max-tokens 128 --prefill-chunk 512``: some admission
   rides the batch as a lane, the 700-, 1500- and 1900-token prompts
   prefill in 2, 3 and 4 chunks (32 K1 launches a chunk), the host fetches
   fewer times than a quarter of the decode tokens, a seeded request gives
   the same text twice, and each stream's TTFT/ITL is printed beside
   5b's, with the share of greedy tokens the two agree on;
5r. serve ragged pipelined: phase 5f's requests on a server with
   ``--ragged --decode-dispatch-pipeline --quantization int4
   --kv-quantization int8``: checked as 5c, and some pure-decode dispatch
   chains off the one before it, the host fetches fewer times than there
   are decode tokens, and each stream's TTFT/ITL is printed beside 5d's,
   with the share of greedy tokens the two agree on.

3g. kernels at Gemma-2-9B's shapes (``GEMMA2_9B_CONFIG``, parsed by the
   port's ``ModelConfig.from_hf_config``: 16/8 heads of 256, soft-cap 50,
   a 4096-token window): K1 on a 2048-token chunk at 4096 over 6144 keys,
   sliding and global; K3 and K4, bf16 and int8, through the same checks
   as in phase 3 (``GEMMA_ATTN``: a mix across the window's edge, window
   floors on the split boundaries, the full batch of 8 x 8192 keys, and
   for K4 a decode step at 4600) with the window and as a global layer;
   each against its plain version in f32 with three planted faults (the
   window one key wider, the soft-cap dropped, the window dropped), with
   repeated bits, timed cold beside its bound, the soft-capped
   yardstick (``torch.compile(flex_attention)``) and SDPA with
   the window as its mask and no soft-cap; K4 also at the ragged server's
   136-row capacity with its f32 scratch allocated and passed in; K5 over
   the tied 3584 x 256000 head and K6 at the five Gemma-2-9B layer shapes
   as in phase 3;
4g. model: phase 4's checks (``check_model``) at the Gemma-2-9B geometry
   (random weights, all 42 layers) in bf16 and in int4 + int8 KV: a
   4600-token prompt and decode steps at positions 4600-4603 through the
   kernels and the plain versions (the window dropped from K1, K3 and K4,
   and in int4 the K5 / K6 faults, planted), the decode program's graphs,
   and one ragged dispatch over the prompt's pool through K4;
5g. serve Gemma-2-9B (``--max-model-len 8192``, 2048 blocks of 16): bf16
   with ``--decode-steps-per-dispatch 8``, int4 + int8 KV with
   ``--ragged``, and int4 + int8 KV split and bf16 ``--ragged``, each
   answering a 4600- and a 300-token prompt posted together, an SSE stream
   and a seeded sampled request twice, with TTFT/ITL, the footprint after
   bring-up and the launches of each path.

3m. kernels at DeepSeek-V2-Lite's shapes (``DEEPSEEK_V2_LITE_CONFIG``: 16
   heads over one latent row of [c_kv 512 | k_pe 64], 640 bf16 lanes or
   768 int8 in the sectioned encoding): K3-MLA (``v_lanes`` 512, and
   ``quant_sections`` (512, 64)) and K4-MLA through the same checks as
   phase 3 (``MLA_ATTN``: an 8-slot mix and 8 x 4096 keys for K3, a
   ragged mix, also at the ragged server's 136-row capacity, and two
   64-row chunks beside 6 decode rows for K4), each against its plain
   version in f32 with planted faults (the last block read as the trash
   block, V read 64 lanes late over bf16 rows, the two sections' scales
   swapped over int8 rows, for K4 the off-by-one causal mask), repeated
   bits, the kernel's own split partials merged in plain PyTorch (and
   with a split left out), timed cold beside its bound, the plain
   version and one ``scaled_dot_product_attention`` call over the
   gathered rows (the first backend that takes the shapes, named); K3-MLA
   also on one 4096-key row, K4-MLA on a pad-row mix (counts not a
   multiple of its 4-row tiles), each row a pad falls on given its own
   key, so that a pad's write reads far above the limit; and the clusters
   of each latent instantiation the card holds at once;
4m. model: phase 4's checks (``check_model``, ``MLA_RUN``) at V2-Lite's
   full width at ``LAYERS``' depth (14 of 27 layers, 64 routed experts of
   which 6 active, 2 shared; random bf16 weights) over a bf16 and an int8
   latent pool: a
   3000-token prompt (prefill is a plain einsum, as in the JAX package)
   and 4 decode steps through K3-MLA, through its plain version in f32
   and with a planted fault, the footprint, a prefill and a decode step
   profiled, the decode program's graphs at K = 1 and K = 8 against
   eager, and (bf16 pool) one ragged dispatch through K4-MLA against its
   plain version and a fault;
5m. serve V2-Lite (``--max-model-len 4096``, 2048 blocks of the engine's
   auto size, 8 slots): bf16 with ``--decode-steps-per-dispatch 8``, bf16
   over ``--kv-quantization int8``, each again with ``--ragged``, each
   answering a 3000- and a 300-token prompt posted together, an SSE stream
   and a seeded sampled request twice, with TTFT/ITL, the footprint after
   bring-up, the graph capture seconds and the launches of each path.
   K4-MLA over int8 rows serves no path (the JAX package gathers there
   too): its entry carries ``"on_main_path": false`` and 0 launches.

3p. kernels at Phi-3-mini-4k's shapes (``PHI3_MINI_4K_CONFIG``, parsed by
   the port's ``ModelConfig.from_hf_config``: 32 heads of 96 over 32 KV
   heads, a 2047-token window on every layer, no soft-cap): K1 on a
   2048-token chunk after a 958-token prefix hit (its live keys end in
   row 61 of a 64-key tile) and on phase 4p's 3000-token prompt in its
   4096 bucket, with the window one key wider and the window dropped
   planted; K2 on phase 3's ring hops and the ring over 2 and 4 shards at
   head dim 96 (``"on_main_path": false``: the ring refuses windows); K3
   and K4, bf16 and int8, through phase 3's checks (``PHI3_ATTN``: a mix
   across the window's edge, window floors on the split boundaries, 8 x
   4096 keys, for K4 a decode step at 3001); each timed cold beside its
   bound and the faster of SDPA (the window in its mask) and
   ``torch.compile(flex_attention)`` (the window's block mask); K5 over
   the untied 3072 x 32064 head and K6 at the three Phi-3-mini layer
   shapes;
4p. model: phase 4's checks (``check_model``, ``PHI3_RUN``) at Phi-3-mini's
   full width at ``LAYERS``' depth (16 of 32 layers, random weights) in
   bf16 and in int4 + int8 KV: a 3000-token prompt (the window binds) and decode steps at
   3000-3003 through the kernels and the plain versions, the window
   dropped from K1, K3 and K4 as the planted faults, the decode program's
   graphs at K = 1 and K = 8 against eager, and one ragged dispatch over
   the prompt's pool through K4;
5p. serve Phi-3-mini (``--max-model-len 4096``, 2048 blocks of 16): bf16
   with ``--decode-steps-per-dispatch 8``, int4 + int8 KV split, and each
   again with ``--ragged``, each answering a 3000- and a 300-token prompt
   posted together, an SSE stream, a seeded sampled request twice and a
   200-token greedy request alone (with its token logprobs, which phase 6
   compares), with TTFT/ITL, the footprint after bring-up, the graph
   capture seconds and the launches of each path.

3q. kernels at Qwen2-7B's shapes (``QWEN2_7B_CONFIG``, parsed by the
   port's ``ModelConfig.from_hf_config``: 28 heads of 128 over 4 KV heads,
   a GQA group of 7, no window): K1 on phase 4q's 6000-token prompt in its
   8192 bucket and on a 2048-row chunk after a 4000-token prefix hit (the
   last KV tile left out planted); K2 on phase 3's ring hops at g = 7
   (``"on_main_path": false``); K3 and K4, bf16 and int8, through phase 3's
   checks (``QWEN2_ATTN``: an 8-slot mix, the split boundaries, 8 x 8192
   keys, for K4 chunks that cross its 9-row tiles with one live chunk and
   with several, every crossed row's own key planted, and the output a
   pad vector would write over it as a planted fault), each also at g = 6,
   5 and 3 at head dim 128 and g = 7 at head dim 64 on one mix
   (``QWEN2_GROUPS``); K5 over the untied 3584 x 152064 head and K6 at
   the four Qwen2-7B layer shapes;
4q. model: phase 4's checks (``check_model``, ``QWEN2_RUN``) at Qwen2-7B's
   width (random weights whose qkv biases are seeded draws as large as the
   projections) in bf16 and in int4 + int8 KV: the 6000-token prompt and
   decode steps at 6000-6003 through the kernels and the plain versions,
   phase 4's planted faults and the qkv biases dropped, the decode
   program's graphs at K = 1 and K = 8 against eager (the step's device
   time beside the floor of reading every weight once), and phase 4's
   ragged dispatches through K4;
5q. serve Qwen2-7B (``--max-model-len 8192``, 2048 blocks of 16, the
   engine's biases drawn live before any graph capture): bf16 with
   ``--decode-steps-per-dispatch 8``, int4 + int8 KV split, and each again
   with ``--ragged``, each answering a 6000- and a 300-token prompt posted
   together, an SSE stream and a seeded sampled request twice, with
   TTFT/ITL, the footprint after bring-up, the graph capture seconds and
   the launches of each path.

6. checkpoint: Phi-3-mini-4k at ``LAYERS["phi3"]`` (16 of 32 layers) as an HF
   model directory under ``build/``: its seed-0 bf16 weights
   (``init_params``) written by the port's ``save_hf_style`` as files of
   at most 2 GiB (several), then loaded back by ``load_params_auto`` in bf16
   and in int4, each tensor (a quantized leaf's ``q`` and ``scale``) held
   bit for bit against ``init_params`` and ``init_params_quantized``, with
   the write and load seconds (the page cache warm from the write), the
   loader's host staging peak and the device peak during each load, held
   to the final tree plus two of the largest checkpoint tensor; then two
   servers load the directory without ``--random-weights`` (bf16 with 8
   decode steps a dispatch, and int4 + int8 KV ``--ragged``), answer 5p's
   requests with their kernels' launches counted, and give a lone greedy
   request (with its token logprobs) and the seeded request exactly as
   their 5p twins do; the directory is deleted.

7. chat: the 8B model at ``LAYERS["8b"]`` with phase 5b's flags
   (``chat_int4_kv8``) served from a directory whose only tokenizer is a
   Llama-3-form ``tokenizer.json`` (``llama3_tokenizer_json``: its Split
   pattern, ``ignore_merges``, the 256 special tokens at 128000-128255)
   with tests/data/chat_templates/llama3.jinja, read by the port's own
   reader and renderer (``chat_phase``): a streamed greedy chat whose
   formatted prompt is ``CHAT_PROMPT`` and whose prompt ids begin 128000,
   128006 and decode back to it; the same request unary and as a
   completion of those ids, all three with the same completion ids (read
   at the engine); a seeded n = 2 chat equal to two n = 1 requests with
   seeds s and s + 1, the prompt counted once in usage; a ~1900-token chat
   with its render and encode ms on the host and its TTFT; the launcher's
   ``run_batch`` over 3 JSONL lines on the live pipeline against the unary
   answers; ``/metrics`` (requests by endpoint, the TTFT count) and
   ``/live``; with the launches of K1, K3-int8, K5 and K6 over the phase.

8. speculation at the 8B width and depth (``spec_phase``; ``SPEC_K`` 4,
   8 slots): K3 bf16 and int8 at the verify program's 40 rows (8 slots of
   ``SPEC_LENS`` keys, 5 rows each over its slot's table), K5 at 40 rows
   and at the row-sampled ragged capacity (136), K6 at N = 40 at the four
   8B shapes, each against its plain version with its planted fault,
   timed beside its bound and library call (entries with ``mode``
   ``spec_verify_rows40``, their launches those of the spec server that
   runs each, K3 bf16's those of the bf16 drafting engines below); then in
   int4 + int8 KV and in bf16: (a) the verify program
   (``check_verify_program``) over 8 prefilled slots: its graph replay
   against eager bit for bit, a stale static input caught, its row (b, t)
   logits against the decode program's step t within phase 4's limit (and
   within ``SPEC_VS_DECODE_MAX``), its kernel path against the plain
   versions with the first row's seq_len one short planted; (a') the
   row-sampled ragged program (``check_row_sampled_program``) at both row
   buckets, a spec span in a seeded top-p slot: the same replay, stale
   input and plain-version checks, with the span's key count one short
   planted in K4; (b) an in-process EngineCore whose drafter proposes a
   reference stream (``OracleDrafter``), first the engine's own plain
   greedy stream, 4 prompts together (``oracle_rounds``): each stream
   must equal its reference to its first difference, which must lie at a
   near tie (a top-2 gap under ``SPEC_NEAR_TIE``), and a stream that left
   it becomes its reference for the next round, until every stream equals
   its reference to the end, every verify dispatch accepting 4 drafts;
   then a drafter wrong at draft 2, from those references, accepting 2;
   (c) the same under ``--ragged`` (the row-sampled program; one request
   alone keeps its spec spans at the 8-row bucket, four fill the capacity
   bucket); (d) a recorded ``--ragged --decode-dispatch-pipeline`` run (an
   oracle request beside a longer one with speculation 0, which chains
   once alone) replayed on the card: ``compare_replay`` empty,
   ``check_log`` and ``check_inputs`` clean; (e) two servers, int4 + int8
   KV with ``--spec-k 4``, split and ``--ragged``, answer 5b's prompts and
   one that repeats a 12-token pattern: some dispatch verified drafts,
   every split verify dispatch a graph replay, a seeded request gives the
   same text twice, ``GET /debug`` lists verifying rows; TTFT/ITL beside
   5b's and 5d's, the share of greedy tokens that agree, drafted /
   accepted / emitted counts. Phase 4m runs (a) at V2-Lite's geometry
   (K3-MLA at 40 rows) in both of its modes.

9. the KV tiers at the 8B width and depth (``tier_phase``): (a) each pool
   row format (the 8B's bf16 rows in 8 wire heads, its int8 rows of 1152
   lanes and V2-Lite's latent rows in bf16 and int8-sectioned, each one
   opaque head) round-trips 31 blocks: a gather on the compute stream, a
   copy into pinned memory on a side stream, a pinned host arena, pinned
   staging, the copy back and an in-place scatter into 31 other blocks;
   each must come back bit for bit, the other blocks untouched and the
   pool tensors unmoved, and the same check must catch the targets
   shifted by one; (b) two servers over a 256-block device pool, a
   512-block host tier and, for the first, a 1536-block disk tier under a
   temporary directory: int4 + int8 KV at K = 8 pipelined, and bf16
   ``--ragged --decode-dispatch-pipeline``. Each serves two conversations
   of three turns (device hits), a 1600-token prompt Y twice (the second
   from its device-resident prefix: the reference), churn that takes Y off
   the device but not the host, then Y again, which must onboard all 99
   prefix blocks from the host and repeat the reference's text, tokens
   and logprobs bit for bit; the first server does the same with a prompt
   X taken off the host too by more churn, restored from disk; (c) the
   first server stops (flushing its host tier to disk), and a new engine
   on the same directory serves X from disk with the same bits; (d) Y's
   restore runs while two other requests decode: a decode dispatch must
   fall inside its onboard window (printed: ITL p50 / max inside and
   outside it, the write-back and onboard GB/s, the arena's pinning
   time); (e) with prefix reuse off, a 600-token request admitted into a
   shattered pool is moved by the defrag pass (the vacated blocks
   overwritten after the move, so a stale table would read garbage) and
   must give the stream of the same run at ``kv_defrag_threshold`` 0,
   on both servers; (f) the ragged server records a cold serving, its
   write-back, a device wipe and its host restore, and the log replays on
   the card with ``compare_replay`` empty. The servers' launch counts
   join the kernels line (``launches_by_path``).

10. KV-aware routing over two workers on the one card (``routed_phase``):
   the port's daemon, two 8B workers (int4 + int8 KV, the same seed,
   phase 7's ``tokenizer.json`` directory at full depth) started through
   the launcher's ``in=dyn://… --protocol tokens`` and the KV-aware
   processor, each a process of its own, beside an in-process server of
   phase 7's shape as the reference. Four prefix groups of 62 blocks: the
   seeds together, then three follow-ups a group one at a time, each of
   which must go to its group's worker with the whole prefix as the
   router's overlap and as that worker's new prefix hits; four streams,
   the first one's worker gets SIGTERM: its key goes, the processor prunes
   its blocks, its streams end in an SSE error event, and four more
   requests finish on the survivor. Every finished stream equals the
   reference's or parts from it at a near tie; each worker launched K1,
   K3-int8, K5 and K6, and their sum is the kernels line's
   ``routed_int4_kv8`` path. Printed: each check's figures, the seeds'
   TTFT beside the follow-ups', each worker's GiB after bring-up.

11. Disaggregated prefill and decode on the one card (``disagg_phase``):
   the 8B at full width and depth, int4 weights + int8 KV, 2048 blocks of
   16, phase 7's ``tokenizer.json`` directory, greedy 32-token streams.
   In one process, over one seeded weight tree: a local engine (the
   reference), a prefill engine behind ``llm/disagg.PrefillWorker`` and
   a decode engine behind ``DisaggEngine``. (11a) four prompts of
   600-3000 tokens over the device plane, the whole payload on the wire
   and the wire layer by layer: every stream equals the reference's bit
   for bit, the decode engine prefills nothing (each plane's K1 launches
   equal the reference's) and the pool keeps its addresses; then each
   prompt twice, all eight at once, as whole payloads. (11d) the
   local fallback with no prefill worker, a layer stream cut after 8 of
   32 layers and re-admitted cold, a short prompt under the threshold and
   a threshold raised through the KV store. (11b) a bf16-KV prefill
   engine feeds the int8-KV decode engine over the device plane (the
   repack); (11c) a ``--ragged`` decode engine over the layer stream:
   both equal their local twins or part at a near tie (printed: where
   and at what gap). 11b reads the cause on one prompt: the repacked rows
   equal the local int8 engine's in layer 0 and part from layer 1 on,
   where each prefill attended over its own pool. 11c's engine, fed the
   same prefills again as whole payloads, repeats its layer-streamed
   streams bit for bit. (11e) the daemon,
   ``in=none out=torch --is-prefill-worker`` and ``in=http out=torch
   --remote-prefill --max-local-prefill-length 512`` as processes: four
   long prompts go remote, four short stay local, every stream equals
   the reference served over HTTP here, and each worker's K1, K3-int8, K5
   and K6 launches are those of its side of the split. 11a-11d's counts
   are the kernels line's ``disagg_int4_kv8`` and
   ``disagg_ragged_int4_kv8`` paths. Printed: each plane's wall seconds,
   the wire's GB/s, each remote TTFT beside its local twin's.

12. The fleet KV fabric on the one card (``fabric_phase``): the 8B at
   full width and depth, int4 weights + int8 KV, host and disk tiers.
   (12a) the C++ data-plane sender's bytes equal the asyncio sender's on
   token frames, a whole 8B KV payload and its layer stream (3000
   tokens), the payloads read back whole through a stream server, STOP
   and KILL; each sender's GB/s. The daemon, a ``--role prefill-publish``
   worker and two ``--kv-fabric`` workers come up as processes beside
   three engines here: D (on the publisher's object root, recorded), its
   device-hit twin T and its cold twin C. (12b) four prompts of
   1600-3000 tokens published (a re-publish writes nothing); D admits
   each plus a 32-token suffix from the object store with T's stream bit
   for bit and prefills the suffix alone. (12c) worker B fetches the
   prefixes worker A served from A's host and disk tiers over the data
   plane (no fallback), with T's streams; T's blocks over the JSON op
   equal them over the data plane and A's; a peer serving torn payloads
   and A's SIGTERM each cost B a recompute with T's cold stream. (12d)
   D's log replays from its carried bytes and from the root. Its launches
   (the engines here and the three workers) are the kernels line's
   ``fabric_int4_kv8`` path. Printed: the object store's write and read
   GB/s, each remote TTFT beside its cold and device-hit twins', B's
   link and what the ``auto`` gate would have decided for each fetch.

Each phase prints its wall seconds (``phase 3q: N s``; each model mode and
server inside one too) and the run ends with all of them on one line. The
model and serve phases run each geometry at the depth of ``LAYERS``: the
published depth, or less for an earlier geometry cut so that the whole
run stays inside its time limit (width, kernels and planted faults stay).

Every split-path decode dispatch, verify dispatch and ragged dispatch of
phases 5-5q, 7 and 8 replays a captured graph; its launches count through
the program's replay accounting.

The line before the last is the kernels' JSON summary (the entries of
3g, 3m, 3p, 3q and 8 carry a ``mode``; each lists its geometry's
``served_paths``, and ``launches`` are those of the first); the last line
is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
L2_FLUSH_BYTES = 256 << 20     # 5x the H100's 50 MB L2

KV_BLOCK = 16
MAX_MODEL_LEN = 2048
# the depth (layers) of each geometry's model and serve phases: its
# published depth, or less where an earlier geometry was cut so that the
# whole run stays inside its time limit (PERF.md lists each cut; width,
# kernels and planted faults are untouched)
LAYERS = {"8b": 32, "gemma2": 21, "mla": 14, "phi3": 16, "qwen2": 14}
SP_TRUE_LEN = 1900             # the sequence-parallel prompt, in a 2048 bucket

# The config.json of google/gemma-2-9b on the Hugging Face hub: 42 layers,
# hidden 3584, 16 query heads over 8 KV heads of 256, a 4096-token window
# on the even layers, soft-caps 50 / 30. The phases 3g-5g parse it with the
# port's ModelConfig.from_hf_config and serve it from a model directory
# that holds it. Gemma2Config ties the embeddings by default and the hub
# file leaves the key out; the port reads an absent key as tied, as HF does,
# where the JAX package reads it as untied, so the tie is written out here
# for both to parse the same model.
GEMMA2_9B_CONFIG = {
    "architectures": ["Gemma2ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "attn_logit_softcapping": 50.0,
    "bos_token_id": 2, "cache_implementation": "hybrid", "eos_token_id": 1,
    "final_logit_softcapping": 30.0, "head_dim": 256,
    "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "gemma2",
    "num_attention_heads": 16, "num_hidden_layers": 42,
    "num_key_value_heads": 8, "pad_token_id": 0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "sliding_window": 4096,
    "sliding_window_size": 4096, "torch_dtype": "float32",
    "use_cache": True, "vocab_size": 256000, "tie_word_embeddings": True}

# The config.json of deepseek-ai/DeepSeek-V2-Lite on the Hugging Face hub
# (its auto_map left out): 27 layers, hidden 2048, 16 heads of MLA (latent
# rank 512, rope 64, nope 128, v 128, no q_lora), the first layer a dense
# MLP of 10944, the rest 64 routed experts of 1408 with 6 active and 2
# shared, yarn rope (factor 40), vocab 102400, untied. The phases 3m-5m
# parse it with the port's ModelConfig.from_hf_config and serve it from a
# model directory that holds it.
DEEPSEEK_V2_LITE_CONFIG = {
    "architectures": ["DeepseekV2ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "aux_loss_alpha": 0.001,
    "bos_token_id": 100000, "eos_token_id": 100001,
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "pretraining_tp": 1, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1.0,
    "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "torch_dtype": "bfloat16", "transformers_version": "4.33.1",
    "use_cache": True, "v_head_dim": 128, "vocab_size": 102400}

# The config.json of microsoft/Phi-3-mini-4k-instruct on the Hugging Face
# hub: 32 layers, hidden 3072, 32 query heads over 32 KV heads of 96 (MHA,
# head dim 96), MLP 8192, a 2047-token window on every layer, default rope
# (theta 10000, no scaling), vocab 32064, untied. The phases 3p-5p parse it
# with the port's ModelConfig.from_hf_config and serve it from a model
# directory that holds it (the 128k variant's longrope factor lists are not
# in the repository; its rope is held against the JAX package on the CPU).
PHI3_MINI_4K_CONFIG = {
    "architectures": ["Phi3ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "embd_pdrop": 0.0, "eos_token_id": 32000,
    "hidden_act": "silu", "hidden_size": 3072, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 4096,
    "model_type": "phi3", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 32,
    "original_max_position_embeddings": 4096, "pad_token_id": 32000,
    "resid_pdrop": 0.0, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000.0, "sliding_window": 2047,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32064}

# The config.json of Qwen/Qwen2-7B-Instruct on the Hugging Face hub: 28
# layers, hidden 3584, 28 query heads over 4 KV heads of 128 (a GQA group
# of 7), MLP 18944, rope theta 1e6, vocab 152064, untied. It carries no
# attention_bias key: both packages default qkv bias on for qwen2, as HF's
# modeling code does; use_sliding_window is false and both packages set no
# window for qwen2. The phases 3q-5q parse it with the port's
# ModelConfig.from_hf_config and serve it from a model directory that holds
# it.
QWEN2_7B_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu",
    "hidden_size": 3584, "initializer_range": 0.02,
    "intermediate_size": 18944, "max_position_embeddings": 32768,
    "max_window_layers": 28, "model_type": "qwen2",
    "num_attention_heads": 28, "num_hidden_layers": 28,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 131072,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 152064}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# wall seconds of each phase (and of each mode and server inside one), in
# the order run
PHASE_S: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Time the block as phase ``name`` and print ``phase NAME: N s``."""
    t0 = time.monotonic()
    yield
    PHASE_S[name] = time.monotonic() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")


def at_depth(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers, width untouched: the one
    cut an earlier geometry takes so that the whole run stays inside its
    time limit (PERF.md lists each); ``serve_phase`` writes the same depth
    into the served config.json."""
    if layers == cfg.num_layers:
        return cfg
    return dataclasses.replace(
        cfg, num_layers=layers,
        layer_types=cfg.layer_types[:layers] if cfg.layer_types else None)


def param_bytes(params) -> int:
    """Device bytes of a parameter tree (a quantized leaf's payload and
    scales) but its embedding table, of which a decode step reads a few
    rows: the least a step reads."""
    n = 0
    for name, t in params.items():
        if name == "embed":
            continue
        for x in ((t.q, t.scale) if hasattr(t, "scale") else (t,)):
            n += x.numel() * x.element_size()
    return n


def time_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).

    ``cold``: overwrite a buffer larger than the 50 MB L2 cache before each
    call and time each call alone, for inputs the main path finds cold
    (decode reads a layer's KV after the other layers' weights have passed
    through L2)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(iters):
        flush.zero_()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


_FLEX = {}


def flex_library_ms(q, k, v, live, softcap: float, scale: float,
                    cold: bool, kernel_options=None) -> tuple:
    """The library yardstick of a soft-capped or windowed attention: one
    call of ``torch.compile(flex_attention)`` over q [B, H, L, Dh] and k/v
    [B, KVH, S, Dh] (GQA) with the score_mod cap * tanh(s / cap) (none for
    a ``softcap`` of 0) and the block mask of ``live`` (a mask_mod of (b,
    h, q_idx, kv_idx)), built before timing, and ``kernel_options``.
    Returns (ms, the call's output [B, H, L, Dh])."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if "fn" not in _FLEX:
        # a recompile per mask is expected; never fall back to eager
        dyn = torch._dynamo.config
        for knob in ("recompile_limit", "cache_size_limit"):
            if hasattr(dyn, knob):
                setattr(dyn, knob, 64)
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    B, _, L, _ = q.shape
    mask = create_block_mask(live, B, None, L, k.shape[2], device=q.device)

    def capped(s, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(s / softcap)
    score_mod = capped if softcap else None

    def call():
        return _FLEX["fn"](q, k, v, score_mod=score_mod, block_mask=mask,
                           scale=scale, enable_gqa=True,
                           kernel_options=kernel_options)
    out = call()
    return time_ms(call, cold=cold), out


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# Each output row (one query row of one head, Dh values) is a convex
# combination of N(0, 1) value rows, so its size falls as 1/sqrt(keys seen):
# O(1) for a row that sees a few keys, ~0.04 for one that sees 2048. A row's
# error is therefore measured against that row's own scale: max |kernel -
# plain| over the row divided by the RMS of the plain row. The plain
# versions round scores to bf16 before the softmax (the kernels keep them in
# f32), both round probabilities and outputs to bf16, so a right kernel
# stays within a few bf16 ulps (2^-8 relative) of the row's largest values.
# A kernel that leaves out the last 64 keys (one KV tile of K1) or reads a
# wrong block for the last table entry of the longest slot (K3) moves the
# rows that see those keys by a sizeable fraction of their RMS. Each case
# below plants such a fault and fails the run unless the limit rejects it.
# The readings on the card, right and faulty, are in PERF.md (Findings).
KERNEL_ROW_REL_TOL = 0.1
FAULT_KEYS = 64                 # K1's KV tile


def row_errors(out, ref, rows) -> tuple:
    """(max abs error, max over the selected rows of max |out - ref| / RMS
    of the plain row); the last axis is Dh."""
    d = (out.float() - ref.float())[rows]
    r = ref.float()[rows]
    rel = d.abs().amax(-1) / r.pow(2).mean(-1).sqrt()
    return d.abs().max().item(), rel.max().item()


def merged_partials_errors(scratch, shape: tuple, live: dict, out,
                           ref) -> tuple:
    """The kernel's own split partials of the rows in ``live`` ({row: its
    live splits}), read from ``scratch`` (``split_scratch_views`` over
    ``shape`` = (rows, KVH, splits, g, Dv)) and merged in plain PyTorch:
    (the row error against the kernel's own output ``out``, and the row
    error against ``ref`` of the same merge with each row's first split
    left out, the planted merge fault)."""
    import torch
    from dynamo_tpu_torch.engine import attention
    rows = sorted(live)
    sel = torch.tensor(rows, device=out.device)
    m, l, acc = (t[sel].clone() for t in
                 attention.split_scratch_views(scratch, *shape))
    for i, r in enumerate(rows):
        n = live[r]
        m[i, :, n:], l[i, :, n:], acc[i, :, n:] = float("-inf"), 0, 0
    _, merged = row_errors(attention.merge_split_partials(m, l, acc),
                           out[sel], slice(None))
    m[:, :, 0], l[:, :, 0], acc[:, :, 0] = float("-inf"), 0, 0
    _, fault = row_errors(attention.merge_split_partials(m, l, acc),
                          ref[sel], slice(None))
    return merged, fault


def check_flash_prefill(cfg, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import flash_prefill_ref
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = MAX_MODEL_LEN                   # the whole block table, M * 16
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = []
    # (T, start_pos, true_len): fresh prompt, prefix hit, padded bucket,
    # and the whole-prompt prefill of phase 4 (1900 tokens in a 2048 bucket)
    for T, start, true_len in ((512, 0, 512), (256, 1024, 256),
                               (512, 0, 300), (MAX_MODEL_LEN, 0, SP_TRUE_LEN)):
        seq_len = start + true_len
        q = torch.randn((T, H, Dh), generator=gen, device=dev).bfloat16()
        k = torch.randn((S, KVH, Dh), generator=gen, device=dev).bfloat16()
        v = torch.randn((S, KVH, Dh), generator=gen, device=dev).bfloat16()
        out = flash_prefill_cuda(q, k, v, scale=scale, start_pos=start,
                                 seq_len=seq_len)
        ref = flash_prefill_ref(q, k, v, scale=scale, start_pos=start,
                                seq_len=seq_len)
        # planted fault: the last KV tile left out
        fault = flash_prefill_cuda(q, k, v, scale=scale, start_pos=start,
                                   seq_len=seq_len - FAULT_KEYS)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"flash_prefill T={T} start={start}: "
                               f"non-finite output")
        err, rel = row_errors(out, ref, slice(0, true_len))
        _, fault_rel = row_errors(fault, ref, slice(0, true_len))
        ms = time_ms(lambda: flash_prefill_cuda(
            q, k, v, scale=scale, start_pos=start, seq_len=seq_len))
        plain_ms = time_ms(lambda: flash_prefill_ref(
            q, k, v, scale=scale, start_pos=start, seq_len=seq_len), iters=5)
        qs = q.transpose(0, 1)[None].contiguous()             # [1, H, T, Dh]
        ks = k[:seq_len].transpose(0, 1)[None].contiguous()   # [1, KVH, s, Dh]
        vs = v[:seq_len].transpose(0, 1)[None].contiguous()
        pos = start + torch.arange(T, device=dev)
        mask = torch.arange(seq_len, device=dev)[None, :] <= pos[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True))
        pairs = sum(min(start + t + 1, seq_len) for t in range(T))
        flops = 4.0 * H * Dh * pairs
        nbytes = 2.0 * (2 * T * H * Dh + 2 * seq_len * KVH * Dh)
        b_ms, b_by = bound(nbytes, flops)
        case = {"T": T, "start_pos": start, "true_len": true_len,
                "max_abs_err": err, "max_row_rel_err": rel,
                "fault_row_rel_err": fault_rel, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by}
        log(f"flash_prefill {json.dumps(case)}")
        check_limit(f"flash_prefill T={T} start={start}", rel,
                    {"last_tile": fault_rel})
        cases.append(case)
    return {"name": "flash_prefill", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "dynamo_tpu/engine/attention.py:220",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **cases[0],
            "cases": cases}


# K2 returns m and l besides the unnormalized acc, and the ring merges them
# as numbers, so they get limits of their own over the rows that see a key:
# |dm| (natural units) and |dl| / l. Kernel and plain version take the same
# exact bf16 products summed in f32 and differ by summation order and the
# kernel's base-2 detour (~1e-5). The planted faults: m returned in the
# kernel's base-2 units (off by 0.44 m), and the last 64-key tile the rows
# can see left out (l off by that tile's share of the row).
PARTIAL_M_ATOL = 1e-3
PARTIAL_L_RTOL = 1e-3
LOG2E = 1.4426950408889634
# K2's ring hops at the 8B shapes, Tl = Sl = 1024 (a 2048-token bucket over
# sp = 2), as (hop, start_pos, seq_len): shard 0's and 1's own chunk, shard
# 1 on shard 0's chunk, shard 0 on shard 1's chunk (dead: every key after
# every query), a padded tail, and a chunk that some rows of one CTA see and
# others do not
PARTIAL_HOPS = [("diagonal", 0, 1024), ("past", 1024, 1024),
                ("dead", -1024, 1024), ("tail", 0, 700),
                ("straddle", -100, 1024)]


def partial_errors(got, ref, seen) -> tuple:
    """(row-relative error of acc / l, max |dm|, max |dl| / l) over the
    (row, head) pairs ``seen`` that see a key."""
    (acc, m, l), (racc, rm, rl) = got, ref
    _, rel = row_errors(acc / l[..., None], racc / rl[..., None], seen)
    return (rel, (m - rm)[seen].abs().max().item(),
            ((l - rl).abs() / rl)[seen].max().item())


def sdpa_with_lse(q, k, v, mask, scale):
    """The library yardstick of K2: one PyTorch call that yields the
    attention output and its log-sum-exp (m + log l),
    ``aten._scaled_dot_product_efficient_attention`` with an additive mask
    broadcast over the heads, over K/V expanded to every query head
    beforehand."""
    import torch
    H, KVH = q.shape[1], k.shape[1]
    q4 = q.transpose(0, 1)[None].contiguous()
    k4, v4 = (x.repeat_interleave(H // KVH, dim=1).transpose(0, 1)[None]
              .contiguous() for x in (k, v))
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
    bias.masked_fill_(~mask, float("-inf"))
    bias = bias[None, None].expand(1, H, *mask.shape)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        q4, k4, v4, bias, True, 0.0, False, scale=scale)


def check_flash_prefill_partial(cfg, dev) -> dict:
    """K2 on PARTIAL_HOPS at the 8B shapes: acc / l row-relative, |dm| and
    |dl| / l against the plain version on the rows that see a key, exact
    zeros and NEG_INF on the rows that do not, two planted faults."""
    import torch
    from dynamo_tpu_torch.engine.attention import (NEG_INF,
                                                   flash_prefill_partial_ref)
    from dynamo_tpu_torch.engine.kernels import flash_prefill_partial_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Tl = MAX_MODEL_LEN // 2
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    q = torch.randn((Tl, H, Dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((Tl, KVH, Dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((Tl, KVH, Dh), generator=gen, device=dev).bfloat16()
    cases = []
    for hop, start, seq_len in PARTIAL_HOPS:
        kw = dict(scale=scale, start_pos=start, seq_len=seq_len)
        got = flash_prefill_partial_cuda(q, k, v, **kw)
        ref = flash_prefill_partial_ref(q, k, v, **kw)
        pos = start + torch.arange(Tl, device=dev)
        seen = (pos >= 0)[:, None].expand(Tl, H)
        keys = max(0, min(seq_len, start + Tl))     # the keys any row sees
        torch.cuda.synchronize()
        if not all(torch.isfinite(x).all() for x in got):
            raise RuntimeError(f"flash_prefill_partial {hop}: non-finite "
                               f"output")
        case = {"hop": hop, "start_pos": start, "seq_len": seq_len,
                "live_rows": int(seen[:, 0].sum())}
        dead = ~seen
        if dead.any():
            exact = bool((got[0][dead] == 0).all() and (got[2][dead] == 0).all()
                         and (got[1][dead] == NEG_INF).all())
            case["dead_rows_exact"] = exact
            if not exact:
                raise RuntimeError(f"flash_prefill_partial {hop}: a row that "
                                   f"sees no key is not (0, NEG_INF, 0)")
        if seen.any():
            fault = flash_prefill_partial_cuda(
                q, k, v, scale=scale, start_pos=start,
                seq_len=keys - FAULT_KEYS)
            rel, dm, dl = partial_errors(got, ref, seen)
            _, base2_dm, _ = partial_errors(
                (got[0], got[1] * LOG2E, got[2]), ref, seen)
            tile_rel, _, tile_dl = partial_errors(fault, ref, seen)
            del fault
            case.update({
                "max_abs_err": (got[0] - ref[0])[seen].abs().max().item(),
                "max_row_rel_err": rel, "max_m_abs_err": dm,
                "max_l_rel_err": dl, "fault_base2_m_abs_err": base2_dm,
                "fault_last_tile_row_rel_err": tile_rel,
                "fault_last_tile_l_rel_err": tile_dl})
            check_limit(f"flash_prefill_partial {hop}", rel,
                        {"last_tile": tile_rel})
            if not (dm <= PARTIAL_M_ATOL and dl <= PARTIAL_L_RTOL):
                raise RuntimeError(f"flash_prefill_partial {hop}: |dm| {dm} "
                                   f"or |dl|/l {dl} over its limit")
            if not (base2_dm > PARTIAL_M_ATOL and tile_dl > PARTIAL_L_RTOL):
                raise RuntimeError(f"flash_prefill_partial {hop}: a planted "
                                   f"fault passes the m/l limits ({base2_dm}, "
                                   f"{tile_dl})")
        else:
            case["max_abs_err"] = (got[0] - ref[0]).abs().max().item()
        del got, ref
        case["ms"] = time_ms(lambda: flash_prefill_partial_cuda(q, k, v, **kw))
        case["plain_ms"] = time_ms(lambda: flash_prefill_partial_ref(
            q, k, v, **kw), iters=5)
        mask = ((torch.arange(Tl, device=dev)[None, :] <= pos[:, None])
                & (torch.arange(Tl, device=dev)[None, :] < seq_len))
        case["library_ms"] = time_ms(sdpa_with_lse(q, k, v, mask, scale))
        case["library"] = ("aten._scaled_dot_product_efficient_attention "
                           "(compute_log_sumexp, additive mask)")
        pairs = sum(max(0, min(start + t + 1, seq_len)) for t in range(Tl))
        nbytes = (2.0 * case["live_rows"] * H * Dh + 2 * 2.0 * keys * KVH * Dh
                  + 4.0 * Tl * H * Dh + 2 * 4.0 * Tl * H)
        case["bound_ms"], case["bound_by"] = bound(nbytes,
                                                   4.0 * H * Dh * pairs)
        if hop == "diagonal":
            # as a ring hop finds it after the layer's projections
            case["cold_ms"] = time_ms(lambda: flash_prefill_partial_cuda(
                q, k, v, **kw), cold=True)
        log(f"flash_prefill_partial {json.dumps(case)}")
        cases.append(case)
    return {"name": "flash_prefill_partial", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "dynamo_tpu/engine/attention.py:436",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL,
            "m_abs_tolerance": PARTIAL_M_ATOL,
            "l_rel_tolerance": PARTIAL_L_RTOL, **cases[0], "cases": cases}


def ring_dropping_one_hop(n: int):
    """``flash_prefill_partial`` with a planted fault for rings of n
    shards: in every ring, shard 1's partial at hop 1 (shard 0's chunk,
    all in its past) comes back as a dead hop."""
    import torch
    from dynamo_tpu_torch.engine.attention import (NEG_INF,
                                                   flash_prefill_partial)
    calls = [0]

    def fn(q, k, v, **kw):
        i = calls[0] % (n * n)       # calls run hop-major: s * n + r
        calls[0] += 1
        acc, m, l = flash_prefill_partial(q, k, v, **kw)
        if i == n + 1:
            return (torch.zeros_like(acc), torch.full_like(m, NEG_INF),
                    torch.zeros_like(l))
        return acc, m, l
    return fn


def check_ring(cfg, dev) -> dict:
    """The ring over sp = 2 and 4 shards of a 2048-token sequence on the
    one card, kv_len 1900, against K1 over the whole sequence; a planted
    fault drops one hop's partial."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    from dynamo_tpu_torch.parallel import ring_attention as ring_mod
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T, kv_len = MAX_MODEL_LEN, SP_TRUE_LEN
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    q = torch.randn((T, H, Dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((T, KVH, Dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((T, KVH, Dh), generator=gen, device=dev).bfloat16()
    ref = flash_prefill_cuda(q, k, v, scale=scale, start_pos=0,
                             seq_len=kv_len)
    k1_ms = time_ms(lambda: flash_prefill_cuda(q, k, v, scale=scale,
                                               start_pos=0, seq_len=kv_len))
    res = {"T": T, "kv_len": kv_len, "k1_ms": k1_ms}
    for sp in (2, 4):
        mesh = make_mesh(sp=sp, devices=[dev] * sp)
        shards = [x.chunk(sp) for x in (q, k, v)]

        def ring():
            return torch.cat(ring_mod.ring_attention(
                *shards, mesh, scale=scale, kv_len=kv_len))
        n0 = kernels.FLASH_PREFILL_PARTIAL.launches
        out = ring()
        launches = kernels.FLASH_PREFILL_PARTIAL.launches - n0
        with swapped((ring_mod, "flash_prefill_partial",
                      ring_dropping_one_hop(sp))):
            fault = ring()
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"ring sp={sp}: non-finite output")
        err, rel = row_errors(out, ref, slice(0, kv_len))
        _, fault_rel = row_errors(fault, ref, slice(0, kv_len))
        case = {"sp": sp, "distinct_cards": len(mesh.distinct_devices),
                "k2_launches": launches, "max_abs_err": err,
                "max_row_rel_err": rel, "fault_dropped_hop_row_rel_err":
                    fault_rel, "ms": time_ms(ring)}
        log(f"ring {json.dumps(case)} [vs K1 over the whole sequence, "
            f"{k1_ms} ms]")
        check_limit(f"ring sp={sp}", rel, {"dropped_hop": fault_rel})
        if launches != sp * sp:
            raise RuntimeError(f"ring sp={sp}: {launches} K2 launches, "
                               f"expected {sp * sp}")
        res[f"sp{sp}"] = case
    return res


def check_limit(what: str, rel: float, faults: dict) -> None:
    """``rel`` within the row limit, and each planted fault of ``faults``
    (name: its row-relative error) above it."""
    if not rel <= KERNEL_ROW_REL_TOL:
        raise RuntimeError(f"{what}: row-relative error {rel} > "
                           f"{KERNEL_ROW_REL_TOL}")
    for name, fault_rel in faults.items():
        if not fault_rel > KERNEL_ROW_REL_TOL:
            raise RuntimeError(f"{what}: the planted fault {name} "
                               f"({fault_rel}) passes the limit "
                               f"{KERNEL_ROW_REL_TOL}")


def shuffled_tables(gen, lens, M: int, bs: int, dev):
    """Tables [len(lens), M] over a random permutation of the pool's blocks
    1.. (block 0 is the trash block), each sequence on the blocks its
    ``lens`` keys need."""
    import torch
    perm = (torch.randperm(len(lens) * M, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((len(lens), M), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    return tables


def pool_inputs(cfg, dev, seed: int, lens, int8: bool, bs: int, M: int,
                n_rows=None) -> tuple:
    """Random K and V pools at the model's shapes (row-quantized for the
    int8 mode; the trash block 0 holds random rows too), sequences of
    ``lens`` keys over a shuffled table of M blocks of ``bs``, and q
    [n_rows or len(lens), H, Dh] bf16. Returns q, k_cache, v_cache,
    tables, lens (int32)."""
    import torch
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = (len(lens) * M + 1) * bs
    k_cache, v_cache = (torch.randn((rows, KVH * Dh), generator=gen,
                                    device=dev).bfloat16() for _ in range(2))
    if int8:
        k_cache, v_cache = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    tables = shuffled_tables(gen, lens, M, bs, dev)
    q = torch.randn((n_rows or len(lens), H, Dh), generator=gen,
                    device=dev).bfloat16()
    return (q, k_cache, v_cache, tables,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def pool_faults(cases, kernel, q, k_cache, v_cache, rows, int8: bool) -> dict:
    """The pool's planted fault beside the trash block: over int8 rows the
    scale lanes of ``rows`` (the longest sequence's last block) zeroed, so
    that every scale reads 2^0 * (1 + 0/256) = 1."""
    from dynamo_tpu_torch.engine.attention import kv_value_lanes
    if not int8:
        return {}
    C = kv_value_lanes(k_cache)
    bad_k, bad_v = k_cache.clone(), v_cache.clone()
    for t in (bad_k, bad_v):
        t[rows, C:C + 2] = 0
    return {"scale_lanes": kernel(kc=bad_k, vc=bad_v)}


@dataclasses.dataclass(frozen=True)
class AttnCases:
    """K3's and K4's phase-3 inputs at one geometry: the table's reach in
    keys; K3's mixed batch, split boundaries and full batch (kv lengths per
    slot); K4's mix, boundaries, full batch and decode step ((rows, kv
    length) per sequence, the trash sequence last); a None case is not run.
    The attention modes: a sliding window (None on a global layer), the
    logit soft-cap (0 for none), MLA's ``v_lanes`` (the latent kernels, one
    row as K and V) and, over an int8 pool, its ``sections``. The gain on q
    (GEMMA_Q_GAIN says why); the plain version runs in f32 on the kernel's
    own bf16 inputs with a gain or in the MLA modes. The pool's block size
    (bf16, int8); the inputs (pool_inputs' signature); the pool's planted
    faults (pool_faults' signature); the kernels-line mode (None: the 8B
    entries); the inputs' seed offset; whether a global layer with no
    soft-cap also times ``torch.compile(flex_attention)`` beside SDPA
    (the yardstick is then the faster); K4-MLA's pad-row mix and K3-MLA's
    one long row (None: not run)."""
    max_len: int
    paged_mix: list
    paged_boundary: Optional[list]
    paged_full: Optional[list]
    ragged_mix: list
    ragged_boundary: Optional[list]
    ragged_full: Optional[list]
    ragged_decode: Optional[list]
    window: Optional[int] = None
    softcap: float = 0.0
    v_lanes: Optional[int] = None
    sections: Optional[tuple] = None
    q_gain: float = 1.0
    block: tuple = (KV_BLOCK, KV_BLOCK)
    inputs: Callable = pool_inputs
    faults: Callable = pool_faults
    mode: Optional[str] = None
    seed: int = 0
    flex: bool = False
    ragged_pad: Optional[list] = None
    paged_single: Optional[list] = None

    @property
    def plain_f32(self) -> bool:
        return self.q_gain != 1.0 or self.v_lanes is not None


# The 8B inputs. K3: the mixed decode batch it has been read on since its
# first version; its split boundaries (128-key chunks) at the 8B table
# width; the full batch, where bytes and not latency decide. K4: a fresh
# 64-row chunk, a 64-row chunk continuing to 1000, a 4-row tail ending at
# 1900, decode rows at 1, 17, 255 and 2048 keys, a slot with no rows (136
# rows = 8 + 2 * 64, the auto capacity of 8 slots at 64 rows per
# sequence); its split boundaries (128-key chunks, 256 for a tile of 5 or
# more rows): decode rows that see 127, 128, 129 and 256 keys, a 20-row
# chunk whose rows straddle the first boundary, a 64-row chunk ending at
# 1100 (four wide tiles over five 256-key splits), a slot with no rows, a
# first decode row; the full ragged batch: two 64-row chunks ending at 2048
# and 6 decode rows at 2048 keys; phase 4's pure-decode ragged step, one
# layer: 8 decode rows at position 300
LLAMA_ATTN = AttnCases(
    max_len=MAX_MODEL_LEN,
    paged_mix=[1, 15, 16, 17, 255, 1000, 2048, 0],
    paged_boundary=[127, 128, 129, 256, 2048, 0],
    paged_full=[2048] * 8,
    ragged_mix=[(64, 64), (64, 1000), (4, 1900), (1, 1), (1, 17), (1, 255),
                (1, 2048), (0, 0), (0, 0)],
    ragged_boundary=[(1, 127), (1, 128), (1, 129), (1, 256), (20, 140),
                     (64, 1100), (0, 0), (1, 1), (0, 0)],
    ragged_full=[(64, 2048), (64, 2048)] + [(1, 2048)] * 6 + [(0, 0)],
    ragged_decode=[(1, 301)] * 8 + [(0, 0)])
RAGGED_MAX_ROWS = 64
# the ragged server's capacity: 8 slots + 2 sequences of 64 rows
RAGGED_CAPACITY = 8 + 2 * RAGGED_MAX_ROWS


def attn_shape(cfg, cases) -> tuple:
    """(query heads, KV heads, query lanes, output lanes) of the kernels:
    a latent row is one KV head as wide as the query
    (``mla.latent_row_lanes`` of a bf16 pool), its output ``v_lanes``."""
    if cases.v_lanes is None:
        return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.head_dim
    from dynamo_tpu_torch.engine.models import mla
    return (cfg.num_heads, 1, mla.latent_row_lanes(cfg, "none"),
            cases.v_lanes)


def attn_scale(cfg, cases) -> float:
    if cases.v_lanes is not None:
        from dynamo_tpu_torch.engine.models import mla
        return mla.softmax_scale(cfg)
    return (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5


def attn_kernel(cases, ragged: bool, int8: bool) -> tuple:
    """(kernels-line name, wrapper, source) of K3 or K4 in ``cases``'
    modes over a bf16 or an int8 pool."""
    from dynamo_tpu_torch.engine import kernels
    pool = "_int8" if int8 else ""
    if cases.v_lanes is not None:
        name = "latent_" + ("ragged" if ragged else "paged") + "_attention"
        return (name + pool, getattr(kernels, name + "_cuda"),
                "dynamo_tpu_torch/csrc/latent_attention.cu")
    name = "ragged_paged_attention" if ragged else "paged_attention"
    return (name + pool, getattr(kernels, name + pool + "_cuda"),
            f"dynamo_tpu_torch/csrc/{name}.cu")


def mark_dead_keys(k_cache, q, tables, seqs, floors, g: int,
                   bs: int = KV_BLOCK) -> None:
    """For each (sequence, query row, window floor >= 0) of ``seqs`` and
    ``floors``, write into the pool row at position ``floor`` of that
    sequence's table, for every KV head, the row's first query head of
    the head's group (an int8 row is requantized): the key a window one
    wider would add, scoring at the cap."""
    import torch
    from dynamo_tpu_torch.engine.attention import (kv_value_lanes,
                                                   quantize_kv_rows)
    C = kv_value_lanes(k_cache)
    for (b, row), f in zip(seqs, floors):
        if f < 0:
            continue
        slot = int(tables[b, f // bs]) * bs + f % bs
        H, Dh = q.shape[1:]
        new = q[row].reshape(H // g, g, Dh)[:, 0].reshape(1, C).to(
            torch.bfloat16)
        k_cache[slot] = (quantize_kv_rows(new)[0]
                         if k_cache.dtype == torch.int8 else new[0])


def plant_own_keys(k_cache, q, tables, starts_l, mix, g: int,
                   bs: int = KV_BLOCK) -> list:
    """The crossed rows of ``mix``, as (sequence, row of its span): each
    row that opens a K4 row tile other than the first where g does not
    divide the tile's 64 query vectors, the row the tile before's pad
    vectors map to (a tile is floor(64 / g) rows). At each, write at the
    row's own position a key equal to its query (mark_dead_keys), so that
    its own key outweighs the others and a pad vector's output, which
    lacks it, moves the row by far more than the limit."""
    from dynamo_tpu_torch.engine.attention import RAGGED_CTA_VECTORS
    if RAGGED_CTA_VECTORS % g == 0:
        return []
    per = RAGGED_CTA_VECTORS // g
    crossed = [(s, r) for s, (n, _) in enumerate(mix)
               for r in range(per, n, per)]
    mark_dead_keys(k_cache, q, tables,
                   [(s, starts_l[s] + r) for s, r in crossed],
                   [mix[s][1] - mix[s][0] + r for s, r in crossed], g, bs)
    return crossed


def pad_vectors_written(out, q, k_cache, v_cache, tables, starts_l, mix,
                        crossed, g: int, **kw):
    """K4's output as a kernel would leave it whose pad vectors wrote:
    each crossed row's (plant_own_keys) heads that the tile before's pad
    vectors map to
    (V % g for V in [R * g, 64), R = 64 // g) computed over that tile's
    keys, which end one before the row's own (the plain version, ``kw``
    its block size and scale)."""
    import torch
    from dynamo_tpu_torch.engine import attention
    per = attention.RAGGED_CTA_VECTORS // g
    heads = sorted({v % g for v in range(per * g,
                                         attention.RAGGED_CTA_VECTORS)})
    bad = out.clone()
    for s, r in crossed:
        n, c = mix[s]
        row = starts_l[s] + r
        lens = torch.tensor([c - n + r], dtype=torch.int32, device=q.device)
        o = attention.paged_attention_ref(q[row:row + 1], k_cache, v_cache,
                                          tables[s:s + 1], lens, **kw)
        for kvh in range(q.shape[1] // g):
            for h in heads:
                bad[row, kvh * g + h] = o[0, kvh * g + h].to(bad.dtype)
    return bad


def latent_pad_crossings(starts_l, mix, TT: int) -> list:
    """K4-MLA's pad rows that fall on rows of q: (sequence, pad row r >=
    its count in its last tile of LATENT_TILE_ROWS rows, the flat row r
    maps to) for each such r whose flat row is below TT (that of another
    sequence, or of none)."""
    from dynamo_tpu_torch.engine.attention import LATENT_TILE_ROWS as R
    return [(s, r, starts_l[s] + r) for s, (n, _) in enumerate(mix) if n
            for r in range(n, -(-n // R) * R) if starts_l[s] + r < TT]


# the planted key's gain over the sum of its row's 16 queries: its score
# then stands ~12 above the random keys' spread of ~0.5 (log units)
MLA_OWN_KEY_GAIN = 30.0


def plant_latent_own_keys(pool, q, tables, starts_l, mix, crossed, bs: int,
                          lanes: int, sections=None) -> None:
    """At each crossed row's (latent_pad_crossings) own position in its
    sequence, a latent row of MLA_OWN_KEY_GAIN x the sum of the row's 16
    queries over the ``lanes`` value lanes (over an int8 pool its
    ``sections`` encoding), so that the row's own key outweighs the
    others and a pad's output, which lacks it, moves the row by far more
    than the limit."""
    import torch
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows_sections
    owner = {starts_l[s] + r: (s, c - n + r)
             for s, (n, c) in enumerate(mix) for r in range(n)}
    for _, _, row in crossed:
        s, pos = owner[row]
        slot = int(tables[s, pos // bs]) * bs + pos % bs
        vals = MLA_OWN_KEY_GAIN * q[row].float().sum(0)[:lanes]
        new = (quantize_kv_rows_sections(vals[None], sections)[0]
               if sections else vals.to(pool.dtype))
        pool[slot] = 0
        pool[slot, :new.shape[0]] = new


def latent_pad_rows_written(out, q, pool, tables, mix, crossed, **kw):
    """K4-MLA's output as a kernel would leave it whose pad rows wrote:
    each crossed row (latent_pad_crossings) as its pad computes it, its
    query over the pad's sequence's keys up to the pad's position (the
    plain version, ``kw`` its block size, scale and modes)."""
    import torch
    from dynamo_tpu_torch.engine import attention
    bad = out.clone()
    for s, r, row in crossed:
        n, c = mix[s]
        lens = torch.tensor([c - n + r + 1], dtype=torch.int32,
                            device=q.device)
        bad[row] = attention.paged_attention_ref(
            q[row:row + 1], pool, None, tables[s:s + 1], lens,
            **kw)[0].to(bad.dtype)
    return bad


def attn_bound(cfg, cases, int8: bool, M: int, rows: int, seqs: int,
               keys: int, pairs: int, scalars: int) -> tuple:
    """K3's / K4's bound: each key a sequence's rows can see read once, for
    K and for V (an int8 row's two scale bytes once per row), or once for
    both from a latent row (an int8 one's sections and their scale
    pairs); q and out; the tables and ``scalars`` int32 per sequence;
    2*H*(dot lanes + output lanes) operations per visible (row, key)."""
    H, KVH, Dq, Dv = attn_shape(cfg, cases)
    if cases.v_lanes is not None:
        dot = sum(cases.sections) if int8 else Dq
        per_key = (dot + 2 * len(cases.sections)) if int8 else 2 * Dq
    else:
        dot = Dq
        per_key = 2 * ((KVH * Dq + 2) if int8 else 2 * KVH * Dq)
    nbytes = (per_key * keys + 2.0 * rows * H * (Dq + Dv)
              + 4.0 * seqs * (M + scalars))
    return bound(nbytes, 2.0 * H * (dot + Dv) * pairs)


def gathered_pages(cfg, cases, k_cache, v_cache, tables, bs: int) -> tuple:
    """Each sequence's pages gathered (an int8 pool's dequantized) as K
    [rows of tables, KVH, M * bs, Dq] and V [..., Dv] bf16, for the
    yardsticks; of a latent pool, K the rows (zero past the sections) and
    V a view of their first ``v_lanes`` lanes."""
    import torch
    from dynamo_tpu_torch.engine.attention import (dequant_kv_rows,
                                                   dequant_kv_rows_sections,
                                                   flat_token_indices)
    _, KVH, Dq, _ = attn_shape(cfg, cases)
    B, T = tables.shape[0], tables.shape[1] * bs
    idx = flat_token_indices(tables, bs)
    if cases.v_lanes is not None:
        rows = k_cache[idx]
        if rows.dtype == torch.int8:
            rows = dequant_kv_rows_sections(rows, cases.sections,
                                            torch.bfloat16)
            rows = torch.nn.functional.pad(rows, (0, Dq - rows.shape[-1]))
        k = rows[:, None]
        return k, k[..., :cases.v_lanes]

    def gather(cache):
        rows = cache[idx]
        if cache.dtype == torch.int8:
            rows = dequant_kv_rows(rows, KVH * Dq, torch.bfloat16)
        return rows.reshape(B, T, KVH, Dq).transpose(1, 2).contiguous()
    return gather(k_cache), gather(v_cache)


def sdpa_yardstick(q, k, v, mask, scale: float) -> dict:
    """One ``scaled_dot_product_attention`` call over q [S, H, L, Dq],
    gathered K [S, KVH, T, Dq] and V [S, KVH, T, Dv] under ``mask`` [S, 1,
    L, T] (one KV head expanded to the H heads as a view, more by
    enable_gqa), on each backend (flash, memory-efficient, cuDNN, math)
    in turn, cold L2: the fastest one that takes these shapes, its time
    and output (``sdpa_ms``, ``sdpa_backend``, ``sdpa_out``), every
    accepting backend's time (``sdpa_backends_ms``) and each refusal's
    text; ``sdpa_ms`` None when every backend refuses. Nothing of the port
    runs here."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = k.shape[1] > 1
    if not gqa:
        k = k.expand(-1, q.shape[1], -1, -1)
        v = v.expand(-1, q.shape[1], -1, -1)
    res = {"sdpa_ms": None, "sdpa_backends_ms": {}, "sdpa_refused": []}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(b=backend):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=gqa)
        try:
            out = call()
            torch.cuda.synchronize()
        except RuntimeError as e:        # this backend refuses the shapes
            res["sdpa_refused"].append(
                f"{backend.name}: {str(e).splitlines()[0][:200]}")
            continue
        ms = time_ms(call, cold=True)
        res["sdpa_backends_ms"][backend.name] = ms
        if res["sdpa_ms"] is None or ms < res["sdpa_ms"]:
            res.update(sdpa_ms=ms, sdpa_backend=backend.name, sdpa_out=out)
        del out
    return res


def paged_library(cfg, cases, q, k_cache, v_cache, tables, seq_lens, bs: int,
                  win_lo=None) -> dict:
    """The yardsticks over pages gathered (and, from an int8 pool,
    dequantized) before timing, every slot padded to the table's width
    under a mask (with ``win_lo``, the window's too); cold L2: SDPA
    (sdpa_yardstick; its output as ``sdpa_out`` [B, H, Dv]), which takes
    no soft-cap, and with a soft-cap flex_attention (flex_library_ms),
    whose output is returned as ``flex_out`` [B, H, Dh]; with a window and
    no soft-cap flex_attention with the window's block mask alone."""
    import torch
    kg, vg = gathered_pages(cfg, cases, k_cache, v_cache, tables, bs)
    kv_pos = torch.arange(kg.shape[2], device=q.device)[None, :]
    mask = kv_pos < seq_lens[:, None]
    if win_lo is not None:
        mask = mask & (kv_pos > win_lo[:, None])
    scale = attn_scale(cfg, cases)
    res = sdpa_yardstick(q[:, :, None, :], kg, vg, mask[:, None, None, :],
                         scale)
    if "sdpa_out" in res:
        res["sdpa_out"] = res["sdpa_out"][:, :, 0]
    res["softcap"] = cases.softcap
    if cases.softcap or cases.window or cases.flex:
        lo = win_lo if win_lo is not None else seq_lens * 0 - 1

        def live(b, h, q_idx, kv_idx):
            return (kv_idx < seq_lens[b]) & (kv_idx > lo[b])
        res["flex_ms"], out = flex_library_ms(q[:, :, None, :], kg, vg, live,
                                              cases.softcap, scale, cold=True)
        res["flex_out"] = out[:, :, 0]
    return res


def ragged_library(cfg, cases, q, k_cache, v_cache, tables, starts_l, mix,
                   bs: int) -> dict:
    """The yardsticks over the sequences padded to [S, H, 64, Dq] against
    pre-gathered (and, int8, dequantized) pages; cold L2: one SDPA call
    (sdpa_yardstick) with a boolean causal-and-length mask (with a window,
    the window's too; padded rows see key 0), which takes no soft-cap, and
    with a soft-cap one flex_attention call (flex_library_ms; padded rows
    see no key; with a window and no soft-cap the block mask alone); their
    outputs as flat rows (``sdpa_out``, ``flex_out``)."""
    import torch
    H = q.shape[1]
    M = tables.shape[1]
    S, dev, Lp, W = len(mix), q.device, RAGGED_MAX_ROWS, cases.window
    qp = torch.zeros((S, H, Lp, q.shape[-1]), dtype=torch.bfloat16,
                     device=dev)
    r = torch.arange(Lp, device=dev)
    kv_pos = torch.arange(M * bs, device=dev)
    mask = torch.zeros((S, 1, Lp, M * bs), dtype=torch.bool, device=dev)
    for s, (st, (n, c)) in enumerate(zip(starts_l, mix)):
        qp[s, :, :n] = q[st:st + n].transpose(0, 1)
        live = ((kv_pos[None, :] <= (c - n + r)[:, None])
                & (kv_pos[None, :] < c) & (r < n)[:, None])
        if W:
            live &= kv_pos[None, :] > (c - n + r - W)[:, None]
        mask[s, 0] = live | ((kv_pos[None, :] == 0) & (r >= n)[:, None])
    kg, vg = gathered_pages(cfg, cases, k_cache, v_cache, tables, bs)
    scale = attn_scale(cfg, cases)

    def flat(out):
        rows = torch.zeros(q.shape[:2] + out.shape[-1:], dtype=out.dtype,
                           device=dev)
        for s, (st, (n, _)) in enumerate(zip(starts_l, mix)):
            rows[st:st + n] = out[s, :, :n].transpose(0, 1)
        return rows
    res = sdpa_yardstick(qp, kg, vg, mask, scale)
    if "sdpa_out" in res:
        res["sdpa_out"] = flat(res["sdpa_out"])
    res["softcap"] = cases.softcap
    if cases.softcap or W or cases.flex:
        n_t = torch.tensor([n for n, _ in mix], device=dev)
        pos0 = torch.tensor([c - n for n, c in mix], device=dev)
        w = W or (M * bs + RAGGED_MAX_ROWS)

        def live_fn(b, h, q_idx, kv_idx):
            return ((q_idx < n_t[b]) & (kv_idx <= pos0[b] + q_idx)
                    & (kv_idx > pos0[b] + q_idx - w))
        # flex's attention kernel for the 64-row tiles: for a query of 64
        # rows its default picks its decoding kernel, far slower here
        res["flex_ms"], out = flex_library_ms(
            qp, kg, vg, live_fn, cases.softcap, scale, cold=True,
            kernel_options={"FORCE_USE_FLEX_ATTENTION": True})
        res["flex_options"] = ", kernel_options FORCE_USE_FLEX_ATTENTION"
        res["flex_out"] = flat(out)
    return res


# the readings beside max_row_rel_err that a case holds to the row limit,
# by pool: the global-layer call, and the library call's output (SDPA, or
# with a soft-cap flex_attention, over a bf16 pool; an int8 pool reaches it
# dequantized to bf16, a rounding of the keys that moves rows at phase
# 3g's scores by up to ~0.09 of their RMS on the card, so there it is only
# reported)
LIMITED = {False: ("global_row_rel_err", "library_row_rel_err"),
           True: ("global_row_rel_err",)}


def yardsticks(case: dict, lib: dict, ref, rows, what: str,
               no_cap_ms=None) -> None:
    """Write the library yardsticks into ``case``, each output held against
    the plain version: SDPA as ``library_ms`` (the fastest backend, named,
    or None with each backend's refusal); with a soft-cap flex_attention's time
    there instead, SDPA and the kernel with the soft-cap off beside it
    labelled 'no softcap'; with a window and no soft-cap the faster of
    SDPA and flex_attention as ``library_ms``, both times beside it."""
    sdpa = (f"scaled_dot_product_attention ({lib['sdpa_backend']} backend, "
            f"the fastest of {sorted(lib['sdpa_backends_ms'])}) over {what}"
            if lib["sdpa_ms"] is not None else
            "no single PyTorch call takes these shapes: "
            + "; ".join(lib["sdpa_refused"]))
    case["sdpa_backends_ms"] = lib["sdpa_backends_ms"]
    if "flex_ms" not in lib:
        case.update(library_ms=lib["sdpa_ms"], library=sdpa)
        if "sdpa_out" in lib:
            _, case["library_row_rel_err"] = row_errors(lib["sdpa_out"], ref,
                                                        rows)
        return
    flex = ("torch.compile(flex_attention) with the block mask"
            + lib.get("flex_options", "") + f", over {what}")
    if not lib.get("softcap"):
        case["library_candidates_ms"] = {"sdpa": lib["sdpa_ms"],
                                         "flex_attention": lib["flex_ms"]}
        if lib["sdpa_ms"] is not None and lib["sdpa_ms"] <= lib["flex_ms"]:
            case.update(library_ms=lib["sdpa_ms"], library=sdpa)
            _, case["library_row_rel_err"] = row_errors(lib["sdpa_out"], ref,
                                                        rows)
        else:
            case.update(library_ms=lib["flex_ms"], library=flex)
            _, case["library_row_rel_err"] = row_errors(lib["flex_out"], ref,
                                                        rows)
        return
    _, case["library_row_rel_err"] = row_errors(lib["flex_out"], ref, rows)
    case.update(library_ms=lib["flex_ms"],
                library="torch.compile(flex_attention) with score_mod "
                        "cap*tanh(s/cap) and the block mask"
                        + lib.get("flex_options", "") + f", over {what}",
                ms_no_softcap=no_cap_ms, library_ms_no_softcap=lib["sdpa_ms"],
                library_no_softcap=sdpa + ", no softcap")


def attn_entry(name: str, source: str, ragged: bool, cases, chunk: int,
               splits: int, case: dict) -> dict:
    """The kernels-line entry of a K3 / K4 check."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": "dynamo_tpu/engine/attention.py:"
                         + ("1255" if ragged else "743"),
             "row_rel_tolerance": KERNEL_ROW_REL_TOL}
    if cases.mode:
        entry.update(mode=cases.mode, window=cases.window,
                     softcap=cases.softcap, q_gain=cases.q_gain)
    if cases.v_lanes is not None:
        entry.update(v_lanes=cases.v_lanes, quant_sections=(
            list(cases.sections) if name.endswith("_int8") else None))
    return {**entry, "chunk_tokens": chunk, "splits": splits, **case}


def check_paged_attention(cfg, dev, int8: bool = False,
                          cases: AttnCases = LLAMA_ATTN) -> dict:
    """K3 (bf16 pool, or int8 rows with in-row scales; in the MLA modes
    K3-MLA over latent rows) in the modes of ``cases``. On the mixed batch
    and the full batch: repeated bits, the planted faults (on a global
    layer the longest slot's last table entry read as the trash block and
    ``cases.faults``; on a sliding layer, over keys planted by
    mark_dead_keys, the window one key wider, the soft-cap dropped and the
    window dropped), and timed with a cold L2 with the bound and the
    library yardsticks. On the mixed batch also: the kernel's own split
    partials of a global-layer call (read from the scratch it was given)
    merged in plain PyTorch against its output, and that merge with one
    split's partial left out as the planted merge fault; and of a sliding
    layer, the same call as a global layer (no floor, and a floor of -1:
    the same bits) against its plain version. The split boundaries (of a
    sliding layer, its floors on them) against the plain version."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels
    name, fn, source = attn_kernel(cases, False, int8)
    H, KVH, Dq, Dv = attn_shape(cfg, cases)
    g, W, cap = H // KVH, cases.window, cases.softcap
    bs = cases.block[int8]
    M = cases.max_len // bs
    # K3's splits of the table's width; K3-MLA's latent_decode_splits(B)
    # of the keys each row sees (its chunk on the device: None here)
    chunk, S = ((None, attention.latent_decode_splits(len(cases.paged_mix)))
                if cases.v_lanes is not None
                else attention.decode_split_plan(M, bs))
    kw = dict(block_size=bs, scale=attn_scale(cfg, cases))
    latent = dict(v_lanes=cases.v_lanes,
                  quant_sections=cases.sections if int8 else None)
    wide = (lambda t: t.float()) if cases.plain_f32 else (lambda t: t)
    pool = (lambda t: t) if int8 else wide

    def run(label: str, lens, seed: int, timed: bool,
            merge: bool = False) -> dict:
        splits = (attention.latent_decode_splits(len(lens)) if chunk is None
                  else S)

        def live_splits(n: int) -> int:
            if chunk is None:
                return attention.latent_split_plan(min(n, M * bs), splits)[1]
            return -(-n // chunk)

        q, k_cache, v_cache, tables, seq_lens = cases.inputs(
            cfg, dev, seed + cases.seed, lens, int8, bs, M)
        if cases.q_gain != 1.0:
            q = (q.float() * cases.q_gain).bfloat16()
        win_lo = None
        if W:
            win_lo = seq_lens - 1 - W
            mark_dead_keys(k_cache, q, tables, [(b, b) for b in
                                                range(len(lens))],
                           win_lo.tolist(), g, bs)
        mode_kw = ({"softcap": cap, "win_lo": win_lo}
                   if cases.v_lanes is None else latent)

        def kernel(qq=q, kc=k_cache, vc=v_cache, tabs=tables, **f):
            pools = (kc,) if vc is None else (kc, vc)
            return fn(qq, *pools, tabs, seq_lens, **{**kw, **mode_kw, **f})

        def plain(w, qq=q, kc=k_cache, vc=v_cache):
            return attention.paged_attention_ref(
                qq, kc, vc, tables, seq_lens, softcap=cap or None, win_lo=w,
                **kw, **latent)
        scratch = (kernels.paged_scratch(q, KVH, M, bs, cases.v_lanes)
                   if merge else None)
        out, again = kernel(), kernel()
        glob = kernel(scratch=scratch, **({"win_lo": None} if W else {}))
        ref = plain(win_lo, wide(q), pool(k_cache),
                    None if v_cache is None else pool(v_cache))
        faults = {}
        if timed and W:
            faults = {"window_off_by_one": kernel(win_lo=win_lo - 1),
                      "dead_splits_counted": glob}
            if cap:
                faults["softcap_dropped"] = kernel(softcap=0.0)
        elif timed:
            # the longest slot's last table entry read as the trash block
            # (which holds other random rows here), and the pool's own
            longest = max(range(len(lens)), key=lambda b: lens[b])
            last = (lens[longest] - 1) // bs
            bad = tables.clone()
            bad[longest, last] = 0
            faults = {"trash_block": kernel(tabs=bad), **cases.faults(
                cases, kernel, q, k_cache, v_cache,
                tables[longest, last].long() * bs
                + torch.arange(bs, device=dev), int8)}
        torch.cuda.synchronize()
        what = f"{name} {cases.mode or ''} {label}"
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{what}: non-finite output")
        if 0 in lens and out[lens.index(0)].abs().max().item() != 0.0:
            raise RuntimeError(f"{what}: zero-length slot is not zero")
        if not torch.equal(out, again):
            raise RuntimeError(f"{what}: two calls gave different bits")
        live = seq_lens > 0
        case = {"B": len(lens), "seq_lens": lens}
        case["max_abs_err"], case["max_row_rel_err"] = row_errors(out, ref,
                                                                  live)
        case["slot_row_rel_err"] = [row_errors(out, ref, b)[1] if n else None
                                    for b, n in enumerate(lens)]
        if faults:
            case["fault_row_rel_err"] = {
                n: row_errors(f, ref, live)[1] for n, f in faults.items()}
            case["repeat_bits_equal"] = True
        gref = ref
        if W and merge:
            # the same call as a global layer: a floor of -1 masks nothing
            gref = plain(None, wide(q), pool(k_cache), pool(v_cache))
            if not torch.equal(glob, kernel(win_lo=torch.full_like(win_lo,
                                                                   -1))):
                raise RuntimeError(f"{what}: a global layer's -1 floor and "
                                   f"no floor gave different bits")
            _, case["global_row_rel_err"] = row_errors(glob, gref, live)
        if merge:
            # the kernel's partials of every slot with two or more live
            # splits, merged in plain PyTorch, against the kernel's own
            # merge; then the planted merge fault, each such slot's first
            # split left out
            (case["kernel_partials_merged_row_rel_err"],
             case["merge_fault_row_rel_err"]) = merged_partials_errors(
                scratch, (len(lens), KVH, splits, g, Dv),
                {b: live_splits(n) for b, n in enumerate(lens)
                 if live_splits(n) > 1}, glob, gref)
        del faults, again, glob, gref, scratch
        if timed:
            case["ms"] = time_ms(kernel, cold=True)
            case["plain_ms"] = time_ms(lambda: plain(win_lo), iters=5,
                                       cold=True)
            lib = paged_library(cfg, cases, q, k_cache, v_cache, tables,
                                seq_lens, bs, win_lo)
            yardsticks(case, lib, ref, live,
                       "pages gathered " + ("and dequantized " if int8
                                            else "")
                       + f"before timing, each slot padded to {M * bs} keys"
                       + (", window in the mask" if W else ""),
                       time_ms(lambda: kernel(softcap=0.0), cold=True)
                       if cap else None)
            del lib
            keys = sum(min(n, W) if W else n for n in lens)
            case["bound_ms"], case["bound_by"] = attn_bound(
                cfg, cases, int8, M, len(lens), len(lens), keys, keys, 1)
            case["bound_share"] = case["bound_ms"] / case["ms"]
        del q, k_cache, v_cache, tables, seq_lens, out, ref
        torch.cuda.empty_cache()
        log(f"{name} {json.dumps({'mode': cases.mode, 'case': label, **case})}")
        check_limit(what, case["max_row_rel_err"],
                    case.get("fault_row_rel_err", {}))
        for k in LIMITED[int8]:
            if k in case:
                check_limit(f"{what} {k}", case[k], {})
        if merge:
            check_limit(f"{what} merge",
                        case["kernel_partials_merged_row_rel_err"],
                        {"first_split_left_out":
                         case["merge_fault_row_rel_err"]})
        return case

    case = run("mix", cases.paged_mix, 3 if int8 else 2, True, merge=True)
    if cases.paged_boundary:
        case["boundary"] = run("boundary", cases.paged_boundary, 5, False)
    if cases.paged_full:
        case["full_batch"] = run("full", cases.paged_full, 6, True)
    if cases.paged_single:
        case["single_row"] = run("single", cases.paged_single, 7, True)
    if cases.v_lanes is not None:
        case["clusters_at_once"] = (
            kernels.LIBRARY.get().dtt_latent_max_active_clusters(int8, 0))
    return attn_entry(name, source, False, cases, chunk, S, case)


def check_ragged_attention(cfg, dev, int8: bool = False,
                           cases: AttnCases = LLAMA_ATTN) -> dict:
    """K4 (bf16 pool, or int8 rows with in-row scales; in the MLA modes
    K4-MLA over latent rows) in the modes of ``cases``. On the mix:
    repeated bits; the planted faults (on a global layer the longest
    sequence's last block read as the trash block, ``cases.faults`` and
    an off-by-one causal mask inside each chunk, its rows one position
    early so each misses its own key; on a sliding layer, over keys
    planted by mark_dead_keys at the decode rows' floors, the window one
    key wider, the soft-cap dropped and the window dropped); the kernel's
    own split partials of a global-layer call (read from the scratch it
    was given, for the rows whose tile has two or more live splits)
    merged in plain PyTorch against its output, and that merge with each
    such row's first split left out as the planted merge fault; of a
    sliding layer, the same call as a global layer (no base, and the
    sentinel base: the same bits) against its plain version; and at the
    ragged server's capacity of 136 rows (q padded with rows no sequence
    owns, which must read zero), timed with the f32 scratch allocated by
    the wrapper and passed in, and its size. The split boundaries against
    the plain version. The mix, the full batch and the pure-decode step
    timed with a cold L2 with their bounds and library yardsticks."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels
    name, fn, source = attn_kernel(cases, True, int8)
    H, KVH, Dq, Dv = attn_shape(cfg, cases)
    g, W, cap = H // KVH, cases.window, cases.softcap
    bs = cases.block[int8]
    M = cases.max_len // bs
    # K4's splits of the table's width; K4-MLA's LATENT_SPLITS of the keys
    # each row tile sees (its chunk on the device: None here)
    tile_rows = (attention.LATENT_TILE_ROWS if cases.v_lanes is not None
                 else None)
    chunk, splits = ((None, attention.LATENT_SPLITS) if tile_rows
                     else attention.decode_split_plan(M, bs))
    kw = dict(block_size=bs, scale=attn_scale(cfg, cases),
              max_rows=RAGGED_MAX_ROWS)
    latent = dict(v_lanes=cases.v_lanes,
                  quant_sections=cases.sections if int8 else None)
    wide = (lambda t: t.float()) if cases.plain_f32 else (lambda t: t)
    pool = (lambda t: t) if int8 else wide
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731

    def run(label: str, mix, seed: int, timed: bool,
            main: bool = False) -> dict:
        TT = sum(n for n, _ in mix)
        q, k_cache, v_cache, tables, ctx = cases.inputs(
            cfg, dev, seed + cases.seed, [c for _, c in mix], int8, bs, M,
            n_rows=TT)
        if cases.q_gain != 1.0:
            q = (q.float() * cases.q_gain).bfloat16()
        starts_l = [sum(n for n, _ in mix[:s]) for s in range(len(mix))]
        starts, counts = i32(starts_l), i32([n for n, _ in mix])
        rows = slice(0, TT)
        win_base = None
        if W:
            win_base = torch.where(counts > 0, ctx - counts - W,
                                   attention.RAGGED_WIN_SENTINEL).to(
                                       torch.int32)
            decode = [s for s, (n, _) in enumerate(mix) if n == 1]
            mark_dead_keys(k_cache, q, tables,
                           [(s, starts_l[s]) for s in decode],
                           [int(win_base[s]) for s in decode], g, bs)
        # where g leaves pad vectors in K4's row tiles (g = 3, 5, 6, 7),
        # each row a pad vector maps to gets its own key planted; on
        # K4-MLA's pad-row mix, each row a pad row falls on
        crossed = []
        if cases.v_lanes is None:
            crossed = plant_own_keys(k_cache, q, tables, starts_l, mix, g, bs)
        elif label == "pad":
            crossed = latent_pad_crossings(starts_l, mix, TT)
            plant_latent_own_keys(k_cache, q, tables, starts_l, mix, crossed,
                                  bs, sum(cases.sections),
                                  cases.sections if int8 else None)
        mode_kw = ({"softcap": cap, "win_base": win_base}
                   if cases.v_lanes is None else latent)

        def kernel(qq=q, kc=k_cache, vc=v_cache, tabs=tables, lens=ctx,
                   **f):
            pools = (kc,) if vc is None else (kc, vc)
            return fn(qq, *pools, tabs, starts, counts, lens,
                      **{**kw, **mode_kw, **f})

        def plain(w, qq=q, kc=k_cache, vc=v_cache):
            return attention.ragged_paged_attention_ref(
                qq, kc, vc, tables, starts, counts, ctx,
                softcap=cap or None, win_base=w, **kw, **latent)
        wide_in = (wide(q), pool(k_cache),
                   None if v_cache is None else pool(v_cache))
        scratch = (kernels.paged_scratch(q, KVH, M, bs, cases.v_lanes,
                                         ragged=True) if main else None)
        out, again = kernel(), kernel()
        glob = kernel(scratch=scratch, **({"win_base": None} if W else {}))
        ref = plain(win_base, *wide_in)
        faults = {}
        if main and W:
            faults = {"window_off_by_one": kernel(win_base=win_base - 1),
                      "dead_splits_counted": glob}
            if cap:
                faults["softcap_dropped"] = kernel(softcap=0.0)
        elif main:
            longest = max(range(len(mix)), key=lambda s: mix[s][1])
            last = (mix[longest][1] - 1) // bs
            bad = tables.clone()
            bad[longest, last] = 0
            faults = {"trash_block": kernel(tabs=bad),
                      "causal_mask_off_by_one": kernel(
                          lens=torch.where(counts > 1, ctx - 1, ctx)),
                      **cases.faults(cases, kernel, q, k_cache, v_cache,
                                     tables[longest, last].long() * bs
                                     + torch.arange(bs, device=dev), int8)}
            if crossed:
                # a pad vector's output written over the row it maps to
                faults["pad_vector_written"] = pad_vectors_written(
                    out, q, k_cache, v_cache, tables, starts_l, mix, crossed,
                    g, block_size=bs, scale=kw["scale"])
        if crossed and cases.v_lanes is not None:
            # a pad row's output written over the row it falls on
            faults["pad_row_written"] = latent_pad_rows_written(
                out, wide_in[0], wide_in[1], tables, mix, crossed,
                block_size=bs, scale=kw["scale"], **latent)
        torch.cuda.synchronize()
        what = f"{name} {cases.mode or ''} {label}"
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{what}: non-finite output")
        if not torch.equal(out, again):
            raise RuntimeError(f"{what}: two calls gave different bits")
        case = {"TT": TT, "mix": mix}
        if crossed:
            case["tile_crossings"] = len(crossed)
        case["max_abs_err"], case["max_row_rel_err"] = row_errors(out, ref,
                                                                  rows)
        case["seq_row_rel_err"] = [
            row_errors(out, ref, slice(st, st + n))[1] if n else None
            for st, (n, _) in zip(starts_l, mix)]
        if faults:
            case["fault_row_rel_err"] = {
                n: row_errors(f, ref, rows)[1] for n, f in faults.items()}
            case["repeat_bits_equal"] = True
        gref = ref
        if W and main:
            # the same call as a global layer: the sentinel masks nothing
            gref = plain(None, *wide_in)
            if not torch.equal(glob, kernel(win_base=torch.full_like(
                    win_base, attention.RAGGED_WIN_SENTINEL))):
                raise RuntimeError(f"{what}: the global sentinel and no "
                                   f"base gave different bits")
            _, case["global_row_rel_err"] = row_errors(glob, gref, rows)
        if main:
            # the kernel's partials of the rows whose tile has two or more
            # live splits, merged in plain PyTorch, against the kernel's
            # own merge; then the planted merge fault, each such row's
            # first split left out
            _, live = attention.ragged_row_plan(starts, counts, ctx, TT, g,
                                                M, bs, tile_rows)
            multi = {r: int(live[r]) for r in range(TT) if live[r] > 1}
            case["multi_split_rows"] = len(multi)
            (case["kernel_partials_merged_row_rel_err"],
             case["merge_fault_row_rel_err"]) = merged_partials_errors(
                scratch, (TT, KVH, splits, g, Dv), multi, glob, gref)
            # the ragged server's capacity: its q always holds 136 rows
            qc = torch.zeros((RAGGED_CAPACITY,) + q.shape[1:], dtype=q.dtype,
                             device=dev)
            qc[:TT] = q
            sc = kernels.paged_scratch(qc, KVH, M, bs, cases.v_lanes,
                                       ragged=True)
            oc = kernel(qq=qc, scratch=sc)
            torch.cuda.synchronize()
            if torch.count_nonzero(oc[TT:]).item():
                raise RuntimeError(f"{what}: rows no sequence owns are not "
                                   f"zero")
            nbytes = 4 * (sc.numel() if sc is not None else 0)
            case["capacity"] = {
                "TT": RAGGED_CAPACITY,
                "max_row_rel_err": row_errors(oc[:TT], ref, rows)[1]}
            if tile_rows:
                # K4-MLA needs no workspace: its partials reach device
                # memory only when room for them is passed in
                case["capacity"].update(
                    scratch_bytes=0, partials_bytes=nbytes,
                    ms=time_ms(lambda: kernel(qq=qc), cold=True),
                    ms_partials_written=time_ms(
                        lambda: kernel(qq=qc, scratch=sc), cold=True))
            else:
                case["capacity"].update(
                    scratch_bytes=nbytes,
                    ms_scratch_allocated=time_ms(lambda: kernel(qq=qc),
                                                 cold=True),
                    ms_scratch_passed_in=time_ms(
                        lambda: kernel(qq=qc, scratch=sc), cold=True))
            del qc, sc, oc
        del faults, again, glob, gref, scratch, wide_in
        if timed:
            case["ms"] = time_ms(kernel, cold=True)
            case["plain_ms"] = time_ms(lambda: plain(win_base), iters=3,
                                       cold=True)
            lib = ragged_library(cfg, cases, q, k_cache, v_cache, tables,
                                 starts_l, mix, bs)
            yardsticks(case, lib, ref, rows,
                       "padded sequences and pre-gathered"
                       + (" dequantized" if int8 else "") + " pages"
                       + (", window in the mask" if W else ""),
                       time_ms(lambda: kernel(softcap=0.0), cold=True)
                       if cap else None)
            del lib
            keys = sum(min(c, W + n - 1) if W and n else c for n, c in mix)
            pairs = sum(min(c - n + i + 1, W) if W else c - n + i + 1
                        for n, c in mix for i in range(n))
            case["bound_ms"], case["bound_by"] = attn_bound(
                cfg, cases, int8, M, TT, len(mix), keys, pairs, 3)
            case["bound_share"] = case["bound_ms"] / case["ms"]
        del q, k_cache, v_cache, tables, out, ref
        torch.cuda.empty_cache()
        log(f"{name} {json.dumps({'mode': cases.mode, 'case': label, **case})}")
        check_limit(what, case["max_row_rel_err"],
                    case.get("fault_row_rel_err", {}))
        for k in LIMITED[int8]:
            if k in case:
                check_limit(f"{what} {k}", case[k], {})
        if main:
            check_limit(f"{what} merge",
                        case["kernel_partials_merged_row_rel_err"],
                        {"first_split_left_out":
                         case["merge_fault_row_rel_err"]})
            check_limit(f"{what} at capacity",
                        case["capacity"]["max_row_rel_err"], {})
        return case

    case = run("mix", cases.ragged_mix, 6 if int8 else 7, True, main=True)
    if cases.ragged_boundary:
        case["boundary"] = run("boundary", cases.ragged_boundary, 8, False)
    if cases.ragged_full:
        case["full_batch"] = run("full", cases.ragged_full, 9, True)
    if cases.ragged_decode:
        case["decode_step"] = run("decode", cases.ragged_decode, 10, True)
    if cases.ragged_pad:
        case["pad_rows"] = run("pad", cases.ragged_pad, 11, False)
    if cases.v_lanes is not None:
        case["clusters_at_once"] = (
            kernels.LIBRARY.get().dtt_latent_max_active_clusters(int8, 1))
    return attn_entry(name, source, True, cases, chunk, splits, case)


def check_lm_head_int8(cfg, dev, rows=(1, 2, 4, 8), primary: int = 8,
                       mode: Optional[str] = None) -> dict:
    """K5 at the 8B head, [4096, 128256] int8, for ``rows`` (one prefill
    row and decode batches of 2, 4 and 8 rows; phase 8: the verify
    program's 40 and the row-sampled ragged program's capacity): repeated
    bits, and the first 128-column strip left out as the planted fault.
    ``mode``: the kernels-line mode of the entry (None: phase 3's)."""
    import torch
    from dynamo_tpu_torch.engine.kernels import lm_head_int8_cuda
    from dynamo_tpu_torch.engine.lm_head import lm_head_int8_ref
    from dynamo_tpu_torch.engine.quant import quantize_array
    D, V = cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    head = quantize_array(torch.randn((D, V), generator=gen, device=dev)
                          * D ** -0.5, keep_axes=(-1,))
    q, scale = head.q, head.scale.reshape(-1).contiguous()
    # the library yardstick reads a bf16 copy of the dequantized head
    w16 = head.dequantize(torch.bfloat16)
    cases = []
    for B in rows:
        x = torch.randn((B, D), generator=gen, device=dev).bfloat16()
        out = lm_head_int8_cuda(x, q, scale)
        again = lm_head_int8_cuda(x, q, scale)
        ref = lm_head_int8_ref(x, q, scale)
        # planted fault: one 128-column strip (the first) left out
        fault = torch.zeros_like(out)
        fault[:, 128:] = lm_head_int8_cuda(x, q[:, 128:].contiguous(),
                                           scale[128:].contiguous())
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"lm_head_int8 B={B}: non-finite output")
        if not torch.equal(out, again):
            raise RuntimeError(f"lm_head_int8 B={B}: two calls gave "
                               f"different bits")
        err, rel = row_errors(out, ref, slice(0, B))
        _, fault_rel = row_errors(fault, ref, slice(0, B))
        del fault, again
        ms = time_ms(lambda: lm_head_int8_cuda(x, q, scale), cold=True)
        plain_ms = time_ms(lambda: lm_head_int8_ref(x, q, scale), iters=5,
                           cold=True)
        lib_ms = time_ms(lambda: torch.matmul(x, w16), cold=True)
        nbytes = 1.0 * D * V + 4.0 * V + 2.0 * B * D + 4.0 * B * V
        b_ms, b_by = bound(nbytes, 2.0 * B * D * V)
        case = {"B": B, "D": D, "V": V, "max_abs_err": err,
                "max_row_rel_err": rel, "fault_row_rel_err": fault_rel,
                "repeat_bits_equal": True,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library": "torch.matmul on a bf16 copy of the dequantized "
                           "head",
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        log(f"lm_head_int8 {json.dumps(case)}")
        check_limit(f"lm_head_int8 B={B}", rel, {"first_strip": fault_rel})
        cases.append(case)
    primary = next(c for c in cases if c["B"] == primary)
    return {"name": "lm_head_int8", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/lm_head_int8.cu",
            "replaces": "dynamo_tpu/engine/lm_head.py:66",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL,
            **({"mode": mode} if mode else {}), **primary, "cases": cases}


def int4pack_yardstick(x, w, ref):
    """One PyTorch call computing x @ dequant(w) for the grouped-int4 weight
    ``w``: ``torch._weight_int4pack_mm`` where this build has it for CUDA
    and it reproduces the plain result, else ``torch.matmul`` on
    pre-dequantized bf16 weights. Returns (fn, name)."""
    import torch
    from dynamo_tpu_torch.engine.quant import unpack_int4_rows
    # torch's layout: uint8 [F, D/2], the even contraction row in the high
    # nibble, values biased by 8, scale and zero point per (group, column)
    u = (unpack_int4_rows(w.q).t().to(torch.int32) + 8)        # [F, D] 0..15
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)],
                     -1).to(torch.bfloat16).contiguous()
    try:
        wp = torch._convert_weight_to_int4pack(
            ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)

        def fn():
            return torch._weight_int4pack_mm(x, wp, 128, sz)
        got = fn().float()
        err = ((got - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if err < 0.05:
            return fn, "torch._weight_int4pack_mm"
        log(f"grouped_int4_matmul: _weight_int4pack_mm differs by {err}")
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"grouped_int4_matmul: _weight_int4pack_mm failed: "
            f"{type(e).__name__}: {str(e)[:200]}")
    w16 = w.dequantize(torch.bfloat16)
    return (lambda: torch.matmul(x, w16),
            "torch.matmul on pre-dequantized bf16 weights")


# K6's cases: the four 8B layer shapes (wq/wo, gate/up, down, wk/wv) at a
# decode row, an 8-slot step, the two sides of the decode/prefill tiling
# edge (16 and 17 rows) and a 512-token prefill bucket
INT4_ROWS = (1, 8, 16, 17, 512)


def check_grouped_int4(cfg, dev, shapes=None, primary_rows: int = 8,
                       mode: Optional[str] = None) -> dict:
    """K6 at the model's layer shapes, ``shapes`` as ((d, f), rows) (by
    default the four 8B shapes for INT4_ROWS): repeated bits, the last
    group's scales read as the first's as a planted fault, and where the
    contraction is split, the kernel's own split partials merged in plain
    PyTorch (within the limit) and merged with one split left out (the
    second planted fault). The entry's numbers are those of the first
    shape at ``primary_rows``; ``mode``: its kernels-line mode."""
    import torch
    from dynamo_tpu_torch.engine.kernels import (grouped_int4_matmul_cuda,
                                                 grouped_int4_scratch)
    from dynamo_tpu_torch.engine.quant import quantize_array_grouped
    from dynamo_tpu_torch.engine.quant_matmul import (
        grouped_int4_matmul_ref, int4_split_plan, merge_int4_split_partials)
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = []
    shapes = shapes or [((d, f), INT4_ROWS)
                        for d, f in ((D, Fi), (Fi, D), (D, KVD), (D, D))]
    for (d, f), rows in shapes:
        w = quantize_array_grouped(torch.randn((d, f), generator=gen,
                                               device=dev) * d ** -0.5)
        bad = w.scale.clone()
        bad[-1] = bad[0]   # planted fault: last group's scales = first's
        for n in rows:
            x = torch.randn((n, d), generator=gen, device=dev).bfloat16()
            splits, per = int4_split_plan(n, d, f)
            scratch = grouped_int4_scratch(x, f)
            out = grouped_int4_matmul_cuda(x, w.q, w.scale, scratch=scratch)
            again = grouped_int4_matmul_cuda(x, w.q, w.scale)
            ref = grouped_int4_matmul_ref(x, w.q, w.scale)
            fault = grouped_int4_matmul_cuda(x, w.q, bad)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"grouped_int4_matmul {d}x{f} N={n}: "
                                   f"non-finite output")
            if not torch.equal(out, again):
                raise RuntimeError(f"grouped_int4_matmul {d}x{f} N={n}: two "
                                   f"calls gave different bits")
            err, rel = row_errors(out, ref, slice(0, n))
            _, fault_rel = row_errors(fault, ref, slice(0, n))
            del fault, again
            case = {"N": n, "D": d, "F": f, "splits": splits,
                    "groups_per_split": per,
                    "ctas": (f // 128) * splits
                    * (1 if n <= 16 else -(-n // 128)),
                    "max_abs_err": err, "max_row_rel_err": rel,
                    "fault_row_rel_err": fault_rel, "repeat_bits_equal": True}
            check_limit(f"grouped_int4_matmul {d}x{f} N={n}", rel,
                        {"last_group_scales": fault_rel})
            if scratch is not None:
                # the kernel's own partials, merged in split order, and
                # merged with the last split left out
                _, merge_rel = row_errors(
                    merge_int4_split_partials(scratch, torch.bfloat16), out,
                    slice(0, n))
                _, drop_rel = row_errors(
                    merge_int4_split_partials(scratch[:-1], torch.bfloat16),
                    ref, slice(0, n))
                case.update({"own_partials_row_rel_err": merge_rel,
                             "fault_dropped_split_row_rel_err": drop_rel})
                check_limit(f"grouped_int4_matmul {d}x{f} N={n} merge",
                            merge_rel, {"dropped_split": drop_rel})
                del scratch
            case["ms"] = time_ms(lambda: grouped_int4_matmul_cuda(
                x, w.q, w.scale), cold=True)
            case["plain_ms"] = time_ms(lambda: grouped_int4_matmul_ref(
                x, w.q, w.scale), iters=5, cold=True)
            lib_fn, case["library"] = int4pack_yardstick(x, w, ref)
            case["library_ms"] = time_ms(lib_fn, cold=True)
            nbytes = (0.5 * d * f + 4.0 * (d // 128) * f + 2.0 * n * d
                      + 2.0 * n * f)
            case["bound_ms"], case["bound_by"] = bound(nbytes,
                                                       2.0 * n * d * f)
            log(f"grouped_int4_matmul {json.dumps(case)}")
            cases.append(case)
        del w, bad
    primary = next(c for c in cases
                   if (c["D"], c["F"], c["N"]) == (D, Fi, primary_rows))
    return {"name": "grouped_int4_matmul", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/grouped_int4_matmul.cu",
            "replaces": "dynamo_tpu/engine/quant_matmul.py:46",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL,
            **({"mode": mode} if mode else {}), **primary, "cases": cases}


# ---------------------------------------------------------------------------
# phase 4: the 8B model through the kernels and through the plain versions
# ---------------------------------------------------------------------------

# bf16 logits of a 32-layer random-weight model, as max |kernel - plain|
# over max |plain|: the two paths round attention at different points in
# every layer (the kernels keep scores in f32), and the differences ride the
# residual stream through 32 bf16 layers. The same comparison is read with a
# planted fault in each kernel of the mode (the prefill's last KV tile left
# out; the decode step's last table entry read as the trash block; the int8
# head's first 256-column strip left out; the grouped-int4 matmul reading
# its last group's scales as the first group's); the limit sits between the
# right and the faulty readings (PERF.md, Findings).
MODEL_REL_TOL = 5e-2

# the modes of phase 4: weight quantization and KV pool
MODEL_MODES = {"bf16": ("none", "none"), "int4_kv8": ("int4", "int8"),
               "int8": ("int8", "none")}


@contextlib.contextmanager
def swapped(*repl):
    """Set ``(module, attribute, value)`` triples for the duration; the
    llama module and ``quant.mm`` call the swapped-in functions in place
    of the kernels' wrappers."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in repl]
    for m, a, v in repl:
        setattr(m, a, v)
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def prefill_without_last_tile(q, k, v, *, scale, start_pos, seq_len, **_):
    """K1 with a planted fault: the last KV tile left out."""
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    return flash_prefill_cuda(q, k, v, scale=scale, start_pos=start_pos,
                              seq_len=max(seq_len - FAULT_KEYS, start_pos + 1))


def decode_without_last_block(q, k_cache, v_cache, block_tables, seq_lens, *,
                              block_size, scale, **_):
    """K3 (either pool) with a planted fault: each slot's last table entry
    read as the trash block."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    tables = block_tables.clone()
    last = (seq_lens.long() - 1).clamp(min=0) // block_size
    tables[torch.arange(tables.shape[0], device=tables.device), last] = 0
    fn = (kernels.paged_attention_int8_cuda if k_cache.dtype == torch.int8
          else kernels.paged_attention_cuda)
    return fn(q, k_cache, v_cache, tables, seq_lens, block_size=block_size,
              scale=scale)


def head_without_first_strip(x, q, scale):
    """K5 with a planted fault: the first 256 vocab columns left out."""
    import torch
    from dynamo_tpu_torch.engine.kernels import lm_head_int8_cuda
    x2 = x[None] if x.dim() == 1 else x
    out = torch.zeros((x2.shape[0], q.shape[1]), dtype=torch.float32,
                      device=x.device)
    out[:, 256:] = lm_head_int8_cuda(x2, q[:, 256:].contiguous(),
                                     scale.reshape(-1)[256:].contiguous())
    return out[0] if x.dim() == 1 else out


def int4_last_group_as_first(x, packed, scale):
    """K6 with a planted fault: the last group's scales read as the first
    group's."""
    from dynamo_tpu_torch.engine.kernels import grouped_int4_matmul_cuda
    bad = scale.clone()
    bad[-1] = bad[0]
    return grouped_int4_matmul_cuda(x, packed, bad)


def ragged_without_last_block(q, k_cache, v_cache, block_tables, seq_starts,
                              seq_counts, seq_lens, *, block_size, scale,
                              max_rows, **_):
    """K4 (either pool) with a planted fault: each sequence's last table
    entry read as the trash block."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    tables = block_tables.clone()
    last = (seq_lens.long() - 1).clamp(min=0) // block_size
    tables[torch.arange(tables.shape[0], device=tables.device), last] = 0
    fn = (kernels.ragged_paged_attention_int8_cuda
          if k_cache.dtype == torch.int8 else kernels.ragged_paged_attention_cuda)
    return fn(q, k_cache, v_cache, tables, seq_starts, seq_counts, seq_lens,
              block_size=block_size, scale=scale, max_rows=max_rows)


# phase 4's ragged dispatches over slots 0-2 of an 8-slot engine, as
# {slot: (row count, first position)}: two fresh 64-row chunks, then a
# mixed dispatch of a decode row, a 64-row chunk continuing a prefix and a
# fresh 8-row chunk
RAGGED_MODEL_DISPATCHES = [{0: (64, 0), 1: (64, 0)},
                           {0: (1, 64), 1: (64, 64), 2: (8, 0)}]
RAGGED_MODES = ("bf16", "int4_kv8")


def ragged_batch(spans, tokens, tables, B: int, dev) -> tuple:
    """The arrays of one ragged dispatch (rows packed in slot order, the
    trash sequence last, as engine/ragged.py packs them): tokens,
    positions, tables, row_slot, starts, counts, sample_rows."""
    import torch
    toks, pos, row_slot = [], [], []
    starts = [0] * (B + 1)
    counts = [0] * (B + 1)
    sample = [0] * (B + 1)
    for slot in sorted(spans):
        n, p0 = spans[slot]
        starts[slot] = len(toks)
        counts[slot] = n
        sample[slot] = len(toks) + n - 1
        toks += tokens[slot][p0:p0 + n]
        pos += list(range(p0, p0 + n))
        row_slot += [slot] * n
    starts[B] = len(toks)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return (torch.tensor(toks, dtype=torch.long, device=dev), i32(pos),
            tables, i32(row_slot), i32(starts), i32(counts), i32(sample))


def ragged_llama(cfg, dev, seed: int, kv_quant: str, **_) -> tuple:
    """Phase 4's ragged dispatches (RAGGED_MODEL_DISPATCHES) over slots 0-2
    of an 8-slot engine, each slot on 24 blocks of its own in a fresh
    pool: (pool, tables, dispatches, slots read)."""
    import torch
    from dynamo_tpu_torch.engine.models import llama
    bs, M, B = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK, 8
    per_slot = 24                      # blocks per slot: 384 tokens
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    tokens = torch.randint(3, cfg.vocab_size, (B, 128), generator=gen,
                           device=dev).tolist()
    tables = torch.zeros((B + 1, M), dtype=torch.int32, device=dev)
    for i in range(B):
        tables[i, :per_slot] = torch.arange(1 + i * per_slot,
                                            1 + (i + 1) * per_slot,
                                            device=dev)
    kv = llama.init_kv_cache(cfg, B * per_slot + 1, bs, dev, torch.bfloat16,
                             quantization=kv_quant)
    return (kv, tables, [ragged_batch(sp, tokens, tables, B, dev)
                         for sp in RAGGED_MODEL_DISPATCHES], 3)


def logit_compare(ref) -> tuple:
    """(max |ref|, a function of logits giving their max |Δ|, that over
    max |ref| and the share of rows whose argmax agrees with ref's)."""
    spread = ref.abs().max().item()

    def compare(logits) -> dict:
        err = (logits - ref).abs().max().item()
        agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return {"max_abs_err": err, "rel_err": err / spread,
                "argmax_agreement": agree}
    return spread, compare


def check_model_limits(what: str, rel: float, faults: dict) -> None:
    """The logits within MODEL_REL_TOL of the plain versions', and each
    planted fault of ``faults`` (name: its relative error) beyond it."""
    if not rel <= MODEL_REL_TOL:
        raise RuntimeError(f"{what}: kernel and plain logits differ by "
                           f"{rel} > {MODEL_REL_TOL}")
    for name, fault_rel in faults.items():
        if not fault_rel > MODEL_REL_TOL:
            raise RuntimeError(f"{what}: the planted fault {name} "
                               f"({fault_rel}) passes the limit "
                               f"{MODEL_REL_TOL}")


def check_ragged_model(params, cfg, mode: str, kv, tables, batches,
                       slots: int, plain_swaps, run, bs: int) -> dict:
    """Phase 4's ragged path: ``batches`` through the model family's
    ``ragged_forward`` over ``kv`` (restored before each run and at the
    end) with the kernels and with the plain versions (``plain_swaps``,
    K4's included), and with ``run``'s planted K4 fault, the first
    ``slots`` slots' logits compared; then one pure-decode ragged dispatch
    of a row per slot of ``tables`` profiled beside the split decode step
    over the same rows."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import family
    model = family(cfg)
    pool = next(iter(kv.values()))
    k4 = run.attn_kernels[1] + ("_int8" if pool.dtype == torch.int8 else "")
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])

    def run_batches():
        restore()
        return torch.cat([model.ragged_forward(params, kv, *b, cfg, bs,
                                               RAGGED_MAX_ROWS)[:slots]
                          for b in batches])     # [dispatches * slots, V]

    fault = run.ragged_fault
    with torch.inference_mode():
        with swapped(*plain_swaps):
            ref = run_batches()
        with swapped((model, "ragged_paged_attention", fault)):
            bad = run_batches()
        kernels.reset_launch_counts()
        got = run_batches()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        profile = profile_ragged_decode(params, kv, cfg, tables,
                                        tables.shape[0] - 1, pool.device, bs)
        restore()
        program = check_ragged_program(params, kv, cfg, tables, batches,
                                       f"{run.label} {mode}", bs)
    torch.cuda.synchronize()
    del snap
    what = f"ragged model {run.label} {mode}"
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise RuntimeError(f"{what}: non-finite logits")
    spread, compare = logit_compare(ref)
    res = {"mode": mode, "launches": launches, "max_abs_ref": spread,
           **compare(got), "planted_faults": {fault.__name__: compare(bad)},
           "decode_dispatch": profile, "program": program}
    log(f"ragged_model {run.label} {json.dumps(res)}")
    want = {k4: cfg.num_layers * len(batches)}
    if {k: launches.get(k, 0) for k in want} != want or any(
            launches.get(k, 0) for k in SPLIT_ATTENTION):
        raise RuntimeError(f"{what}: launches {launches}, expected {want} "
                           f"and no split-path attention")
    check_model_limits(what, res["rel_err"], {
        k: v["rel_err"] for k, v in res["planted_faults"].items()})
    return res


# the ragged program of phases 4-4q (engine/programs.py): a graph per row
# bucket and sampling variant; slot 1 samples (seeded, top-p 0.9) so the
# filtered branch runs, the others are greedy
RAGGED_PROFILE_END = 3000      # PR 13's mixed shape: a chunk ending here


def ragged_program_inputs(batch, tables, B: int) -> dict:
    """The ragged program's host inputs for ``batch`` (``ragged_batch``'s
    tensors: tokens, positions, tables, row_slot, starts, counts,
    sample_rows over the used rows): the rows as packed, dead rows filled
    by the program, slot 1 seeded and sampled."""
    import numpy as np
    tok, pos, _, row_slot, starts, counts, sample = (
        t.cpu().numpy() for t in batch)
    S = B + 1
    temp = np.zeros((S,), np.float32)
    top_p = np.ones((S,), np.float32)
    temp[1], top_p[1] = 0.7, 0.9
    return {"tokens": tok.astype(np.int64), "positions": pos,
            "row_slot": row_slot, "tables": tables.cpu().numpy(),
            "seq_starts": starts, "seq_counts": counts,
            "sample_rows": sample, "seeds": np.arange(S, dtype=np.int64),
            "steps": (pos[sample] + 1).astype(np.int64), "temperature": temp,
            "top_k": np.zeros((S,), np.int64), "top_p": top_p}


def ragged_program_batches(batches, tables, bs: int, dev) -> dict:
    """Phase 4's program inputs: ``decode``, one row a slot of ``tables``
    (B rows: each slot of the last dispatch at its span's last position,
    any other at 300, where no two rows share a pool row); ``mixed``, the
    last dispatch as the model check ran it; ``profile_mixed``, a 64-row
    chunk of slot 0 ending at key min(3000, slot 0's table) beside the
    decode rows of the other slots (V2-Lite: PR 13's mixed shape)."""
    B = tables.shape[0] - 1
    last = batches[-1]
    counts = last[5].tolist()
    sample = last[6].tolist()
    pos = last[1].tolist()
    at = [pos[sample[s]] if counts[s] else 300 for s in range(B)]
    tokens = [[3 + (i + s) % 1000 for i in range(8192)] for s in range(B)]
    decode = {s: (1, at[s]) for s in range(B)}
    end = min(RAGGED_PROFILE_END, int((tables[0] > 0).sum()) * bs)
    mixed = {0: (RAGGED_MAX_ROWS, end - RAGGED_MAX_ROWS)}
    mixed.update({s: (1, at[s]) for s in range(1, B)})
    return {"decode": ragged_batch(decode, tokens, tables, B, dev),
            "mixed": last,
            "profile_mixed": ragged_batch(mixed, tokens, tables, B, dev)}


def profile_ragged_program(prog, inputs: dict) -> dict:
    """One ragged dispatch of ``inputs``, greedy, eager (``run_eager``) and
    replayed: host wall time (mean of 5 calls ending in the host fetch),
    device time and device kernels from the profiler, the hand-written
    kernels' launches of one call, and for the replay its CUDA-event
    time."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    runs = {"eager": lambda: prog.run_eager("greedy", inputs).fetch(),
            "graph": lambda: prog.dispatch("greedy", inputs).fetch()}
    out = {}
    for name, fn in runs.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            fn()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
        before = {k: v.launches for k, v in kernels.KERNELS.items()}
        fn()
        launches = {k: v.launches - before[k]
                    for k, v in kernels.KERNELS.items()
                    if v.launches > before[k]}
        prof = device_profile(fn)
        row = {"rows": prog.bucket(inputs), "wall_ms": wall_ms,
               "device_ms": prof["device_ms"],
               "device_kernels": prof["device_kernels"],
               "device_busy_share": (prof["device_ms"] / wall_ms
                                     if prof["device_busy_share"]
                                     is not None else None),
               "launches": launches,
               "top_kernels_ms": prof["top_kernels_ms"]}
        if name == "graph":
            row["event_ms"] = time_ms(fn, iters=5, warmup=1)
        out[name] = row
    return out


def reserved_gib() -> float:
    """Device memory the caching allocator holds once what nothing uses
    is released (graph pools included)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def check_ragged_program(params, kv, cfg, tables, batches, what: str,
                         bs: int) -> dict:
    """The ragged program over phase 4's weights and pool: at each row
    bucket (``decode``: B rows; ``mixed``: the model check's last
    dispatch at the capacity) a graph replay against the same program run
    eagerly from the same pool (the live slots' tokens, logprobs and
    logits and the pool outside the trash block, bit for bit); a planted
    fault (the static inputs left stale for a second dispatch) that must
    differ from the eager run; the pure-decode batch at both buckets
    (within MODEL_REL_TOL, with the share of equal greedy tokens); two
    chained pure-decode dispatches against two host-fed ones (the same
    tokens); the graphs' memory in the
    program's one pool against each bucket's graph in a pool of its own;
    then wall / device / launches of the decode dispatch and of the
    profiled mixed shape, eager against graphed."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine.programs import RaggedProgram
    dev = next(iter(kv.values())).device
    B, M = tables.shape[0] - 1, tables.shape[1]
    cap = B + 2 * RAGGED_MAX_ROWS
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])

    def program():
        return RaggedProgram(params, kv, cfg, bs, B, M, cap,
                             RAGGED_MAX_ROWS, 0, dev)

    inputs = {k: ragged_program_inputs(b, tables, B)
              for k, b in ragged_program_batches(batches, tables, bs,
                                                 dev).items()}
    res = {"B": B, "capacity": cap}
    r0 = reserved_gib()
    prog = program()
    memory = {}
    for kind in ("mixed", "decode"):
        inp = inputs[kind]
        live = [s for s in range(B) if inp["seq_counts"][s]]
        restore()
        d = prog.dispatch("filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        memory[f"shared_after_{kind}_gib"] = reserved_gib() - r0
        logits = d.logits[live].clone()
        pool = {n: t[:, bs:].clone() for n, t in kv.items()}
        restore()
        e = prog.run_eager("filtered", inp, with_logits=True)
        res[f"{kind}_replay_equals_eager"] = {
            "rows": prog.bucket(inp),
            "tokens": bool((toks[live] == e.toks.cpu().numpy()[live]).all()),
            "logprobs": bool((lps[live]
                              == e.logprobs.cpu().numpy()[live]).all()),
            "logits": torch.equal(logits, e.logits[live]),
            "pool": all(torch.equal(pool[n], kv[n][:, bs:]) for n in kv)}
        del pool, logits, e, d
    # the pure-decode batch at the capacity bucket too: another row count
    # may take other library algorithms, so the two buckets agree within
    # the model limit and by greedy tokens, not bit for bit
    dec = inputs["decode"]
    live = [s for s in range(B) if dec["seq_counts"][s]]
    restore()
    small = prog.run_eager("greedy", dec, with_logits=True).logits[live]
    restore()
    big = prog._run(cap, "greedy", prog._device_inputs(dec),
                    with_logits=True)[2][live]
    _, compare = logit_compare(small)
    res["buckets_agree"] = compare(big)
    del small, big
    # each bucket's graph alone in a pool of its own (a program per graph)
    for kind in ("mixed", "decode"):
        r1 = reserved_gib()
        alone = program()
        restore()
        alone.dispatch("filtered", inputs[kind]).fetch()
        memory[f"own_pool_{kind}_gib"] = reserved_gib() - r1
        del alone
    res["graph_memory"] = memory
    # the planted fault: a second dispatch whose inputs never reach the
    # graph (its static inputs keep the first dispatch's tokens)
    other = {k: v.copy() for k, v in dec.items()}
    other["tokens"] = other["tokens"] + 1000
    restore()
    prog.dispatch("filtered", dec).fetch()
    upload = prog._upload
    prog._upload = lambda inputs: None
    try:
        restore()
        stale = prog.dispatch("filtered", other,
                              with_logits=True).logits[live].clone()
    finally:
        prog._upload = upload
    restore()
    right = prog.run_eager("filtered", other, with_logits=True).logits[live]
    res["planted_stale_inputs_caught"] = not torch.equal(stale, right)
    del stale, right
    # two pure-decode dispatches, the second chained off the first's device
    # tokens, against the same two fed from the host
    starts = dec["seq_starts"][:B]

    def second(tokens=None):
        nxt = {k: v.copy() for k, v in dec.items()}
        nxt["positions"][starts] += 1
        nxt["steps"][:B] += 1
        if tokens is not None:
            nxt["tokens"][starts] = tokens
        return nxt
    mask = np.zeros((cap,), bool)
    mask[starts] = True
    srows = np.zeros((cap,), np.int64)
    srows[starts] = np.arange(B)
    restore()
    d1 = prog.dispatch("filtered", dec)
    d2 = prog.dispatch("filtered", {**second(), "chain_mask": mask,
                                    "srows": srows}, chain=d1.toks)
    chained = (d1.fetch()[0][:B], d2.fetch()[0][:B])
    restore()
    h1 = prog.dispatch("filtered", dec).fetch()[0][:B]
    h2 = prog.dispatch("filtered", second(h1)).fetch()[0][:B]
    res["chained_equals_host_fed"] = bool((chained[0] == h1).all()
                                          and (chained[1] == h2).all())
    restore()
    res["profile"] = {k: profile_ragged_program(prog, inputs[k])
                      for k in ("decode", "profile_mixed")}
    restore()
    res["captures"], res["replays"] = prog.captures, prog.replays
    res["capture_s"] = prog.capture_s
    del snap, prog
    bad = [k for k, v in res.items() if v is False
           or (isinstance(v, dict) and any(x is False for x in v.values()))]
    if not res["buckets_agree"]["rel_err"] <= MODEL_REL_TOL:
        bad.append("buckets_agree")
    log(f"ragged_program {what} {json.dumps(res)}")
    if bad:
        raise RuntimeError(f"ragged program {what}: {bad} failed")
    return res


# phase 4's sequence-parallel prefill: the pool rows the prompt wrote, as
# max |sp - whole-prompt| over max |whole-prompt| per side (k, v), the
# int8 pool's rows dequantized first. The rows of layer 0 are equal (same
# projections of the same embeddings); later layers inherit the attention
# rounding differences of the layers before, as the logits do.
SP_POOL_REL_TOL = 5e-2
# the ring-hop fault (shard 1 loses shard 0's chunk in every layer) must
# move the logits by more than this
SP_FAULT_MIN_REL = 0.15


def pool_rows(kv, rows, C: int):
    """The pool's k and v rows ``rows`` of every layer in f32 (int8 rows
    dequantized)."""
    import torch
    from dynamo_tpu_torch.engine.attention import dequant_kv_rows
    out = []
    for name in ("k", "v"):
        r = kv[name][:, rows]
        out.append(dequant_kv_rows(r, C, torch.float32)
                   if r.dtype == torch.int8 else r.float())
    return out


def check_model_sp(params, cfg, dev, seed: int) -> dict:
    """``prefill_forward_sp`` (sp = 2 on the one card, bucket 2048,
    true_len 1900) through K2 against ``prefill_forward`` through K1, over
    a bf16 pool and an int8 pool: logits, the prompt's pool rows, the K2
    launch count (32 layers x sp^2 hops), a planted ring-hop fault; then
    wall and device time of each prefill (bf16 pool)."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.parallel import ring_attention as ring_mod
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    sp, bs, M = 2, KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    T, true_len = MAX_MODEL_LEN, SP_TRUE_LEN
    mesh = make_mesh(sp=sp, devices=[dev] * sp)
    log(f"sp mesh: {sp} shards over {len(mesh.distinct_devices)} distinct "
        f"card(s)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    tokens = torch.randint(3, cfg.vocab_size, (T,), generator=gen, device=dev)
    table = torch.arange(1, M + 1, dtype=torch.int32, device=dev)
    rows = torch.arange(bs, bs + true_len, device=dev)   # blocks 1.. hold it
    C = cfg.num_kv_heads * cfg.head_dim
    out = {}
    for kv_quant in ("none", "int8"):
        def run(use_sp: bool, kv=None):
            if kv is None:
                kv = llama.init_kv_cache(cfg, M + 1, bs, dev, torch.bfloat16,
                                         quantization=kv_quant)
            if use_sp:
                logits = llama.prefill_forward_sp(params, kv, tokens, table,
                                                  true_len, cfg, bs, mesh)
            else:
                logits = llama.prefill_forward(params, kv, tokens, table, 0,
                                               true_len, cfg, bs)
            return logits, kv

        with torch.inference_mode():
            ref, kv_ref = run(False)
            kernels.reset_launch_counts()
            got, kv_sp = run(True)
            launches = {k: v.launches for k, v in kernels.KERNELS.items()
                        if v.launches}
            with swapped((ring_mod, "flash_prefill_partial",
                          ring_dropping_one_hop(sp))):
                fault, _ = run(True)
            pool = [(a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(pool_rows(kv_sp, rows, C),
                                    pool_rows(kv_ref, rows, C))]
            del kv_ref, kv_sp
            timing = {}
            if kv_quant == "none":
                # each prefill again over one pool (its writes repeat):
                # wall time (mean of 3) and one profiled call
                _, kv = run(False)
                for name, use_sp in (("whole_prompt_k1", False),
                                     ("sp_ring_k2", True)):
                    run(use_sp, kv)
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    for _ in range(3):
                        run(use_sp, kv)
                    torch.cuda.synchronize()
                    wall_ms = 1e3 * (time.monotonic() - t0) / 3
                    prof = device_profile(lambda: run(use_sp, kv))
                    timing[name] = {"wall_ms": wall_ms, **prof}
                del kv
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
            raise RuntimeError(f"model sp {kv_quant}: non-finite logits")
        spread = ref.abs().max().item()
        rel = (got - ref).abs().max().item() / spread
        fault_rel = (fault - ref).abs().max().item() / spread
        res = {"kv": kv_quant, "sp": sp, "bucket": T, "true_len": true_len,
               "launches": launches, "max_abs_ref": spread, "rel_err": rel,
               "argmax_equal": bool(got.argmax() == ref.argmax()),
               "pool_rel_err_k_v": pool,
               "planted_fault_dropped_hop_rel_err": fault_rel,
               "prefill": timing}
        log(f"model_sp {json.dumps(res)}")
        want = {"flash_prefill_partial": cfg.num_layers * sp * sp}
        if ({k: launches.get(k, 0) for k in want} != want
                or launches.get("flash_prefill", 0)):
            raise RuntimeError(f"model sp {kv_quant}: launches {launches}, "
                               f"expected {want} and no K1")
        if not rel <= MODEL_REL_TOL:
            raise RuntimeError(f"model sp {kv_quant}: sp and whole-prompt "
                               f"logits differ by {rel} > {MODEL_REL_TOL}")
        if not max(pool) <= SP_POOL_REL_TOL:
            raise RuntimeError(f"model sp {kv_quant}: pool rows differ by "
                               f"{pool} > {SP_POOL_REL_TOL}")
        if not fault_rel > SP_FAULT_MIN_REL:
            raise RuntimeError(f"model sp {kv_quant}: the dropped-hop fault "
                               f"({fault_rel}) does not move the logits by "
                               f"more than {SP_FAULT_MIN_REL}")
        out[kv_quant] = res
    return out


def profile_ragged_decode(params, kv, cfg, tables, B: int, dev,
                          bs: int = KV_BLOCK) -> dict:
    """One pure-decode ragged dispatch of B rows (one per slot, each at
    position 300 of its own blocks) beside the split decode step over the
    same rows: wall time (mean of 5), device time, busy share, kernels."""
    import torch
    from dynamo_tpu_torch.engine.models import family
    model = family(cfg)
    pos = 300
    toks = torch.arange(3, 3 + B, dtype=torch.long, device=dev)
    positions = torch.full((B,), pos, dtype=torch.int32, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    row_slot = i32(list(range(B)))
    starts = i32(list(range(B)) + [B])
    counts = i32([1] * B + [0])
    sample = i32(list(range(B)) + [0])

    def ragged():
        return model.ragged_forward(params, kv, toks, positions, tables,
                                    row_slot, starts, counts, sample, cfg,
                                    bs, RAGGED_MAX_ROWS)

    def split():
        return model.decode_forward(params, kv, toks, positions,
                                    tables[:B].contiguous(), cfg, bs)

    out = {}
    for name, step in (("ragged", ragged), ("split", split)):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
        prof = device_profile(step)
        if prof["device_busy_share"] is not None:
            prof["device_busy_share"] = prof["device_ms"] / wall_ms
        out[name] = {"wall_ms": wall_ms, **prof}
    return out


def profile_decode_step(params, kv, cfg, table, B: int, M: int,
                        pos: int, block_size: int = KV_BLOCK) -> dict:
    """Where one decode step's time goes (one live slot of B): host wall
    time of the model family's ``decode_forward`` against the device time
    the profiler attributes to kernels, and the top kernels by device
    time."""
    import torch
    from dynamo_tpu_torch.engine.models import family
    dev = next(iter(kv.values())).device
    toks = torch.zeros((B,), dtype=torch.long, device=dev)
    pos_t = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos_t[0] = pos
    tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
    tables[0] = table

    def step():
        return family(cfg).decode_forward(params, kv, toks, pos_t, tables,
                                          cfg, block_size)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 5
    t0 = time.monotonic()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / n
    prof = device_profile(step)
    if prof["device_busy_share"] is not None:   # against the 5-step mean
        prof["device_busy_share"] = prof["device_ms"] / wall_ms
    return {"wall_ms": wall_ms, **prof}


def device_profile(fn) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler): total,
    the kernel count and the top kernels, with the call's wall time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    rows, launches = [], 0   # device kernels only: operator rows repeat
    # [ms, kernels] of each hand-written kernel of a call, either pool: K1,
    # K2, K3's two kernels (the merge is launched early, by programmatic
    # dependent launch, so its time includes its wait for the split kernel
    # and the two overlap), K4, K5 and K6 (both tilings), and the latent
    # kernel (K3-MLA on a decode step, K4-MLA on a ragged dispatch)
    names = {"k1": ("flash_prefill_kernel",),
             "k2": ("flash_prefill_partial_kernel",),
             "k3_split": ("paged_attention_split_kernel",),
             "k3_merge": ("paged_attention_merge_kernel",),
             "k4": ("ragged_attention_kernel",),
             "k5": ("lm_head_int8_kernel",),
             "k6": ("int4_decode_kernel", "int4_prefill_kernel"),
             "mla": ("latent_attention_kernel",)}
    mine = {part: [0.0, 0] for part in names}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3, e.key))
            launches += e.count
            for part, acc in mine.items():
                if any(n in e.key for n in names[part]):
                    acc[0] += t / 1e3
                    acc[1] += e.count
    rows.sort(reverse=True)
    device_ms = sum(t for t, _ in rows)
    return {"profiled_wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_busy_share": device_ms / wall_ms if rows else None,
            "device_kernels": launches if rows else "not measured",
            **{f"{part}_ms_kernels": acc if rows else "not measured"
               for part, acc in mine.items()},
            "top_kernels_ms": [[k[:60], t] for t, k in rows[:6]]}


# the decode program of phase 4 (engine/programs.py): K steps per dispatch
PROGRAM_K = 8


def program_inputs(pos: int, table, B: int, M: int,
                   second_table=None) -> dict:
    """One dispatch's host inputs: slot 0 greedy over ``table`` at
    ``pos``; with ``second_table`` slot 1 too, sampled with a seed and
    top-p 0.9 (so the filtered branch runs); the other slots inactive."""
    import numpy as np
    tables = np.zeros((B, M), np.int32)
    tables[0] = table.cpu().numpy()
    inp = dict(tokens=np.array([11, 12] + [0] * (B - 2), np.int64),
               positions=np.zeros((B,), np.int32), tables=tables,
               seeds=np.arange(B, dtype=np.int64),
               steps0=np.zeros((B,), np.int64),
               temperature=np.zeros((B,), np.float32),
               top_k=np.zeros((B,), np.int64),
               top_p=np.ones((B,), np.float32))
    inp["positions"][0] = inp["steps0"][0] = pos
    if second_table is not None:
        tables[1] = second_table.cpu().numpy()
        inp["positions"][1] = inp["steps0"][1] = pos
        inp["temperature"][1], inp["top_p"][1] = 0.7, 0.9
    return inp


def check_decode_program(params, kv, cfg, table, B: int, M: int,
                         pos: int, mode: str,
                         block_size: int = KV_BLOCK) -> dict:
    """The decode program over the 8B weights and the pool phase 4 filled:
    a graph replay against the same program run eagerly from the same
    pool (tokens, logprobs, logits of the live slots and the pool rows
    outside the trash block, bit for bit) at K = 1 and K = 8; K = 8
    against eight K = 1 dispatches (the same tokens); a planted fault
    (the static inputs left stale for a second dispatch) that must differ
    from the eager run; then wall / device / launches per token of the
    eager step, the graphed K = 1 step and the K = 8 dispatch, one live
    slot of B, greedy."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine.programs import DecodeProgram
    dev = next(iter(kv.values())).device
    n_used = int((table > 0).sum().item())
    second = torch.zeros_like(table)
    second[:n_used] = torch.arange(1 + n_used, 1 + 2 * n_used, device=dev)
    prog = DecodeProgram(params, kv, cfg, block_size, B, M, PROGRAM_K, 0,
                         dev)
    inp = program_inputs(pos, table, B, M, second)
    live = [0, 1]
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])

    res = {}
    for K in (1, PROGRAM_K):
        restore()
        d = prog.dispatch(K, "filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool = {n: t[:, block_size:].clone() for n, t in kv.items()}
        restore()
        e = prog.run_eager(K, "filtered", inp, with_logits=True)
        same = {"tokens": bool((toks[:, live] == e.toks.cpu().numpy()
                                [:, live]).all()),
                "logprobs": bool((lps[:, live] == e.logprobs.cpu().numpy()
                                  [:, live]).all()),
                "logits": torch.equal(logits[:, live], e.logits[:, live]),
                "pool": all(torch.equal(pool[n], kv[n][:, block_size:])
                            for n in kv)}
        res[f"k{K}_replay_equals_eager"] = same
        del pool, logits, e
    # K = 8 against eight K = 1 dispatches fed on the host
    restore()
    toks8, _ = prog.dispatch(PROGRAM_K, "filtered", inp).fetch()
    restore()
    step = {k: v.copy() for k, v in inp.items()}
    toks1 = []
    for _ in range(PROGRAM_K):
        t, _ = prog.dispatch(1, "filtered", step).fetch()
        toks1.append(t[0])
        step["tokens"] = t[0].copy()
        step["positions"][live] += 1
        step["steps0"][live] += 1
    res["k8_equals_eight_k1"] = bool(
        (toks8[:, live] == np.stack(toks1)[:, live]).all())
    # the planted fault: a second dispatch whose inputs never reach the
    # graph (its static inputs keep the first dispatch's tokens)
    other = {k: v.copy() for k, v in inp.items()}
    other["tokens"] = other["tokens"] + 1000
    restore()
    prog.dispatch(1, "filtered", inp, with_logits=True).fetch()
    upload = prog._upload
    prog._upload = lambda inputs: None
    try:
        restore()
        stale = prog.dispatch(1, "filtered", other,
                              with_logits=True).logits.clone()
    finally:
        prog._upload = upload
    restore()
    right = prog.run_eager(1, "filtered", other, with_logits=True).logits
    res["planted_stale_inputs_caught"] = not torch.equal(
        stale[:, live], right[:, live])
    del stale, right
    restore()
    del snap
    res["profile"] = profile_program(prog, pos, table, B, M)
    res["captures"], res["replays"] = prog.captures, prog.replays
    res["capture_s"] = prog.capture_s
    bad = [k for k, v in res.items() if v is False
           or (isinstance(v, dict) and False in v.values())]
    log(f"program {mode} {json.dumps(res)}")
    if bad:
        raise RuntimeError(f"decode program {mode}: {bad} failed")
    return res


def profile_program(prog, pos: int, table, B: int, M: int) -> dict:
    """Per token (one live slot of B, greedy): host wall time (mean of 5
    calls ending in the host fetch), device time and device kernels from
    the profiler, and for a replay its CUDA-event time, of the eager
    step, the graphed K = 1 step and the K = 8 dispatch."""
    import torch
    inp = program_inputs(pos, table, B, M)
    runs = {"eager_k1": (1, lambda: prog.run_eager(1, "greedy",
                                                   inp).fetch()),
            "graph_k1": (1, lambda: prog.dispatch(1, "greedy",
                                                  inp).fetch()),
            f"graph_k{PROGRAM_K}": (PROGRAM_K, lambda: prog.dispatch(
                PROGRAM_K, "greedy", inp).fetch())}
    out = {}
    for name, (K, fn) in runs.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            fn()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
        prof = device_profile(fn)
        row = {"wall_ms_per_token": wall_ms / K,
               "device_ms_per_token": (prof["device_ms"] / K
                                       if prof["device_kernels"]
                                       != "not measured" else
                                       "not measured"),
               "device_kernels_per_token": (prof["device_kernels"] / K
                                            if prof["device_kernels"]
                                            != "not measured" else
                                            "not measured"),
               "device_busy_share": (prof["device_ms"] / wall_ms
                                     if prof["device_kernels"]
                                     != "not measured" else None),
               "kernel_ms_kernels": {k[:-len("_ms_kernels")]: v
                                     for k, v in prof.items()
                                     if k.endswith("_ms_kernels")}}
        if name.startswith("graph"):
            row["event_ms_per_token"] = time_ms(fn, iters=5, warmup=1) / K
        out[name] = row
    return out


def check_sampling_noise(cfg, dev) -> dict:
    """The sampler's Gumbel noise (JAX's threefry, in plain PyTorch) for
    one and for eight sampled rows over the 8B vocabulary: CUDA-event time
    and the kernels one draw launches."""
    import torch
    from dynamo_tpu_torch.engine.sampling import gumbel_noise, make_slot_key
    res = {}
    for b in (1, 8):
        keys = [make_slot_key(0, 7 + i, 100) for i in range(b)]
        ms = time_ms(lambda: gumbel_noise(cfg.vocab_size, keys, dev))
        prof = device_profile(lambda: gumbel_noise(cfg.vocab_size, keys,
                                                   dev))
        res[f"rows_{b}"] = {"ms": ms, "device_ms": prof["device_ms"],
                            "device_kernels": prof["device_kernels"]}
    log(f"sampling_noise {json.dumps(res)}")
    return res


@dataclasses.dataclass(frozen=True)
class ModelRun:
    """One geometry's phase-4 run: a ``prompt``-token prompt in a
    ``bucket``-token bucket, then ``steps`` decode steps, over tables
    reaching ``max_len`` keys in blocks of ``block`` (bf16, int8 pool); K1's
    planted fault (None: the family's prefill runs no kernel) and K3's
    (functions with the wrappers' signatures); the ragged dispatches
    (``ragged``: a function of (cfg, dev, seed, kv_quant, kv=, table=,
    tokens=, n_blocks=) giving a pool, tables, dispatches and the slots to
    read) and K4's planted fault; whether bf16 also runs the
    sequence-parallel prefill (K2); how the plain attention versions run
    (``plain`` wraps each); the kernels-line names of K3 and K4 (``_int8``
    added over an int8 pool); whether each mode also runs phase 8a's
    verify program (``check_verify_program``)."""
    label: str
    prompt: int
    bucket: int
    steps: int
    max_len: int
    prefill_fault: Optional[Callable]
    decode_fault: Callable
    ragged: Callable
    ragged_fault: Callable
    sp: bool
    block: tuple = (KV_BLOCK, KV_BLOCK)
    plain: Callable = lambda ref: ref
    attn_kernels: tuple = ("paged_attention", "ragged_paged_attention")
    verify: bool = False


LLAMA_RUN = ModelRun("8B", 300, 512, 4, MAX_MODEL_LEN,
                     prefill_without_last_tile, decode_without_last_block,
                     ragged_llama, ragged_without_last_block, True)


def check_model(cfg, dev, seed: int, mode: str, run: ModelRun) -> dict:
    """Phase 4 (4g, 4m) in one mode of SERVE_MODES: the model of ``cfg``
    (random weights, every layer) prefills ``run.prompt`` tokens and
    decodes ``run.steps`` steps through the kernels, through their plain
    versions, and with a planted fault in each kernel of the mode (``run``'s
    K1 and K3 faults; K5's first strip left out; K6's last group's scales
    read as the first's; with qkv bias, the biases, drawn live by
    live_qkv_biases, dropped); each kernel's launches; the footprint; one
    prefill and one eager decode step profiled; the decode program
    (check_decode_program); in the modes of RAGGED_MODES, ``run``'s ragged
    dispatches (check_ragged_model); in bf16 where ``run.sp``, the
    sequence-parallel prefill (check_model_sp)."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels, lm_head, quant
    from dynamo_tpu_torch.engine import quant_matmul
    from dynamo_tpu_torch.engine.models import family
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.engine.weights import init_params
    model = family(cfg)
    weights, kv_quant = SERVE_MODES[mode]
    int8_kv = kv_quant == "int8"
    t0 = time.monotonic()
    if weights == "none":
        params = init_params(cfg, seed, dev, torch.bfloat16)
    else:
        params = init_params_quantized(cfg, seed, dev, torch.bfloat16,
                                       bits=4 if weights == "int4" else 8)
    if cfg.attention_bias:
        live_qkv_biases(params, seed)
    torch.cuda.synchronize()
    log(f"model {run.label} {mode}: random weights on the card in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    bs, B = run.block[int8_kv], 8
    M = run.max_len // bs
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(3, cfg.vocab_size, (run.bucket,), generator=gen,
                           device=dev)
    forced = torch.randint(3, cfg.vocab_size, (run.steps,), generator=gen,
                           device=dev)
    table = torch.zeros((M,), dtype=torch.int32, device=dev)
    # the prompt, the decode steps, the profiled step, the program's
    # 8-step dispatches; the pool holds a second slot's blocks as many
    n_blocks = -(-(run.prompt + run.steps + 2 + PROGRAM_K) // bs)
    table[:n_blocks] = torch.arange(1, 1 + n_blocks, device=dev)
    kv = model.init_kv_cache(cfg, 2 * n_blocks + 1, bs, dev, torch.bfloat16,
                             quantization=kv_quant)
    footprint = torch.cuda.memory_allocated() / 2**30

    def prefill(p=params):
        return model.prefill_forward(p, kv, tokens, table, 0, run.prompt,
                                     cfg, bs)

    def forward(p=params):
        for t in kv.values():
            t.zero_()
        out = [prefill(p)[None]]
        toks = torch.zeros((B,), dtype=torch.long, device=dev)
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        tables = torch.zeros((B, M), dtype=torch.int32, device=dev)
        tables[0] = table
        for i in range(run.steps):
            toks[0] = forced[i]
            pos[0] = run.prompt + i
            out.append(model.decode_forward(p, kv, toks, pos, tables, cfg,
                                            bs)[:1])
        return torch.cat(out)                      # [1 + steps, V]

    # each kernel of the mode: (module, attribute, plain version, fault)
    slots = [(model, "paged_attention",
              run.plain(attention.paged_attention_ref), run.decode_fault)]
    if run.prefill_fault is not None:
        slots.insert(0, (model, "flash_prefill", attention.flash_prefill_ref,
                         run.prefill_fault))
    if weights != "none":
        slots.append((model, "lm_head_int8", lm_head.lm_head_int8_ref,
                      head_without_first_strip))
    if weights == "int4":
        slots.append((quant, "grouped_int4_matmul",
                      quant_matmul.grouped_int4_matmul_ref,
                      int4_last_group_as_first))
    ragged = None
    with torch.inference_mode():
        with swapped(*((m, a, plain) for m, a, plain, _ in slots)):
            ref = forward()
        faults = {}
        for m, a, _, fault in slots:
            with swapped((m, a, fault)):
                faults[fault.__name__] = forward()
        if cfg.attention_bias:
            faults["qkv_bias_dropped"] = forward(without_qkv_bias(params))
        kernels.reset_launch_counts()
        t1 = time.monotonic()
        got = forward()
        torch.cuda.synchronize()
        forward_s = time.monotonic() - t1
        launches = {k: v.launches for k, v in kernels.KERNELS.items()
                    if v.launches}
        t1 = time.monotonic()
        prefill()
        torch.cuda.synchronize()
        prefill_profile = {"wall_ms": 1e3 * (time.monotonic() - t1),
                           **device_profile(prefill)}
        decode_step = profile_decode_step(params, kv, cfg, table, B, M,
                                          run.prompt + run.steps, bs)
        program = check_decode_program(params, kv, cfg, table, B, M,
                                       run.prompt + run.steps + 1,
                                       f"{run.label} {mode}", bs)
        verify = None
        if run.verify:
            # phase 8a at this geometry: K3 (K3-MLA) at B·(k + 1) rows
            verify = check_verify_program(
                params, cfg, dev, seed, mode, run.label, bs, run.max_len,
                [(m, a, plain) for m, a, plain, _ in slots
                 if a != "flash_prefill"])
        if mode in RAGGED_MODES:
            # the same weights through the ragged path: K4 in place of K1
            # and K3, every other kernel as above
            plain_swaps = [(m, a, plain) for m, a, plain, _ in slots
                           if a not in ("flash_prefill", "paged_attention")]
            plain_swaps.append((model, "ragged_paged_attention",
                                run.plain(
                                    attention.ragged_paged_attention_ref)))
            ragged = check_ragged_model(
                params, cfg, mode, *run.ragged(cfg, dev, seed, kv_quant,
                                               kv=kv, table=table,
                                               tokens=tokens,
                                               n_blocks=n_blocks),
                plain_swaps, run, bs)
    torch.cuda.synchronize()
    what = f"model {run.label} {mode}"
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise RuntimeError(f"{what}: non-finite logits")
    spread, compare = logit_compare(ref)
    res = {"model": run.label, "mode": mode, "weights": weights,
           "kv": kv_quant, "block_size": bs, "prompt": run.prompt,
           "bucket": run.bucket,
           "decode_positions": [run.prompt, run.prompt + run.steps - 1],
           "footprint_gib": footprint, "launches": launches,
           "decode_floor_ms": param_bytes(params) / PEAK_HBM_BYTES * 1e3,
           "forward_s": forward_s, "max_abs_ref": spread, **compare(got),
           "planted_faults": {k: compare(v) for k, v in faults.items()},
           "prefill_profile": prefill_profile, "decode_step": decode_step,
           "program": program, "verify": verify, "ragged": ragged}
    log(f"model {json.dumps(res)}")
    del got, ref, faults, kv
    if run.sp and mode == "bf16":
        # the same weights through the sequence-parallel prefill (K2)
        res["sp"] = check_model_sp(params, cfg, dev, seed)
    del params
    gc.collect()          # the decode program's graphs hold their pools
    torch.cuda.empty_cache()
    forwards = 1 + run.steps
    want = {run.attn_kernels[0] + ("_int8" if int8_kv else ""):
            run.steps * cfg.num_layers}
    if run.prefill_fault is not None:
        want["flash_prefill"] = cfg.num_layers
    if weights != "none":
        want["lm_head_int8"] = forwards
    if weights == "int4":
        # every layer matmul passes the grouped kernel's shape rule
        want["grouped_int4_matmul"] = 7 * cfg.num_layers * forwards
    if {k: launches.get(k, 0) for k in want} != want:
        raise RuntimeError(f"{what}: launches {launches}, expected {want}")
    check_model_limits(what, res["rel_err"], {
        k: v["rel_err"] for k, v in res["planted_faults"].items()})
    return res


# ---------------------------------------------------------------------------
# phases 3g and 4g: the Gemma-2-9B geometry
# ---------------------------------------------------------------------------

# Gemma-2-9B's whole context: 512 blocks of 16 tokens a sequence
GEMMA_MAX_LEN = 8192
GEMMA_M = GEMMA_MAX_LEN // KV_BLOCK
# the kernel entries of the new modes (head dim 256, soft-cap, window) and
# of K5 / K6 at the Gemma-2-9B widths
GEMMA_MODE = "gemma2_dh256_softcap_window"
GEMMA_SHAPES_MODE = "gemma2_9b_shapes"
# Phase 3g scales q so that the scores (std ~6 in natural units) reach the
# bend of the 50 soft-cap, where dropping it moves a row by more than the
# limit; the plain version then runs in f32 on the same bf16 inputs, since
# its bf16 form rounds such scores by up to ~0.1 before the softmax, more
# than the kernels' own error. Every case plants three faults that the
# row-relative limit must reject: the window one key wider (">=" for ">"),
# the soft-cap dropped, and the window dropped (the tiles and splits below
# it run and are counted). At such scores one extra key of 4096 carries
# weight only where it happens to score highest, which a prefill's 32768
# rows show and a decode batch's 128 do not: K3 and K4 therefore plant, at
# the first position below each decode row's window, a key equal to that
# row's query (mark_dead_keys), which the off-by-one fault must weigh.
GEMMA_Q_GAIN = 6.0
GEMMA_WINDOW = GEMMA2_9B_CONFIG["sliding_window"]
# phase 4g: a 4600-token prompt (the window binds in prefill: its last rows
# see 4096 of the 4600 keys) in a 4608-token bucket, then 4 decode steps
GEMMA_PROMPT, GEMMA_BUCKET, GEMMA_STEPS = 4600, 4608, 4
# K3 and K4 at Gemma-2-9B's heads over the 8192-key table. K3: a mix across
# the window's edge (and a short slot, a single key, a zero-length slot);
# window floors on the split boundaries (first live keys 127, 128, 129 and
# 256); the full batch of 8 x 8192 keys. K4: a 48-row chunk ending at 6000
# (its rows' floors 1856-1903), decode rows on both sides of the window's
# edge and at the table's end, a 16-row chunk ending at 4200 (floors across
# the edge), a short decode row, a slot with no rows; the split boundaries
# of 8B's mix moved from keys seen to window floors; two 64-row chunks and
# 6 decode rows at 8192 keys; 8 decode rows at phase 4g's first decode
# position
GEMMA_ATTN = AttnCases(
    max_len=GEMMA_MAX_LEN,
    paged_mix=[4095, 4096, 4097, 6000, 8192, 100, 1, 0],
    paged_boundary=[GEMMA_WINDOW + n for n in (127, 128, 129, 256)]
    + [GEMMA_MAX_LEN, 0],
    paged_full=[GEMMA_MAX_LEN] * 8,
    ragged_mix=[(48, 6000), (1, 4095), (1, 4096), (1, 4097), (1, 8192),
                (16, 4200), (1, 100), (0, 0), (0, 0)],
    ragged_boundary=[(1, GEMMA_WINDOW + 127), (1, GEMMA_WINDOW + 128),
                     (1, GEMMA_WINDOW + 129), (1, GEMMA_WINDOW + 256),
                     (20, GEMMA_WINDOW + 140), (64, GEMMA_MAX_LEN), (0, 0),
                     (1, 1), (0, 0)],
    ragged_full=[(64, GEMMA_MAX_LEN)] * 2 + [(1, GEMMA_MAX_LEN)] * 6
    + [(0, 0)],
    ragged_decode=[(1, GEMMA_PROMPT + 1)] * 8 + [(0, 0)],
    window=GEMMA_WINDOW, softcap=GEMMA2_9B_CONFIG["attn_logit_softcapping"],
    q_gain=GEMMA_Q_GAIN, mode=GEMMA_MODE, seed=20)


def gemma_config():
    from dynamo_tpu_torch.engine.config import ModelConfig
    return ModelConfig.from_hf_config(GEMMA2_9B_CONFIG)


def check_window_flash_prefill(cfg, dev, mode: str, chunks, q_gain: float,
                               seed: int) -> dict:
    """K1 in a windowed model's modes (``cfg``'s heads, window and
    soft-cap) on ``chunks``, each (T, start_pos, true_len, sliding): the
    rows at positions start_pos .. start_pos + T - 1 over start_pos + T
    keys of which start_pos + true_len are live, on a sliding layer (the
    window) or a global one; q scaled by ``q_gain``, the plain version in
    f32. Planted faults: the soft-cap dropped, and on a sliding layer the
    window one key wider and the window dropped (a global layer with no
    soft-cap: the last KV tile left out). Timed (with and without
    the soft-cap) beside flex_attention with the soft-cap (without one: the
    faster of flex_attention and SDPA) and SDPA without it, both with the
    causal (and window) mask."""
    import torch
    import torch.nn.functional as F
    from dynamo_tpu_torch.engine.attention import flash_prefill_ref
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    H, KVH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W, cap = cfg.sliding_window, cfg.attn_logit_softcap or 0.0
    scale = (cfg.query_pre_attn_scalar or Dh) ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cases = []
    for T, start, true_len, sliding in chunks:
        S, seq_len = start + T, start + true_len
        window = W if sliding else 0
        q = (torch.randn((T, H, Dh), generator=gen, device=dev)
             * q_gain).bfloat16()
        k, v = (torch.randn((S, KVH, Dh), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        kw = dict(scale=scale, start_pos=start, seq_len=seq_len)
        pos = start + torch.arange(T, device=dev)
        kv_pos = torch.arange(S, device=dev)
        qs = q.transpose(0, 1)[None].contiguous()
        ks, vs = (x.transpose(0, 1)[None].contiguous() for x in (k, v))

        def kernel(**f):
            return flash_prefill_cuda(q, k, v, **{**kw, "window": window,
                                                  "softcap": cap, **f})
        out, again = kernel(), kernel()
        ref = flash_prefill_ref(q.float(), k.float(), v.float(),
                                sliding=sliding, window=W,
                                softcap=cap or None, **kw)
        faults = {"softcap_dropped": kernel(softcap=0.0)} if cap else {}
        if sliding:
            faults["window_off_by_one"] = kernel(window=W + 1)
            faults["dead_tiles_counted"] = kernel(window=0)
        if not faults:
            # a global layer with no soft-cap: the last KV tile left out
            faults["last_tile"] = kernel(seq_len=seq_len - FAULT_KEYS)
        torch.cuda.synchronize()
        rows = slice(0, true_len)
        what = (f"flash_prefill {mode} T={T} start={start} "
                f"sliding={sliding}")
        if not torch.isfinite(out[rows]).all():
            raise RuntimeError(f"{what}: non-finite output")
        if not torch.equal(out, again):
            raise RuntimeError(f"{what}: two calls gave different bits")
        err, rel = row_errors(out, ref, rows)
        fault_rel = {n: row_errors(f, ref, rows)[1]
                     for n, f in faults.items()}
        del faults, again, out
        ms = time_ms(kernel)
        ms_nocap = time_ms(lambda: kernel(softcap=0.0)) if cap else None
        plain_ms = time_ms(lambda: flash_prefill_ref(
            q, k, v, sliding=sliding, window=W, softcap=cap or None, **kw),
            iters=3)
        mask = (kv_pos[None, :] <= pos[:, None]) & (kv_pos[None, :] < seq_len)
        if sliding:
            mask &= kv_pos[None, :] > (pos - W)[:, None]
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True))
        w = window or S

        def live(b, h, q_idx, kv_idx):
            return ((kv_idx <= start + q_idx) & (kv_idx < seq_len)
                    & (kv_idx > start + q_idx - w))
        flex_ms, flex_out = flex_library_ms(qs, ks, vs, live, cap, scale,
                                            cold=False)
        _, flex_rel = row_errors(flex_out[0].transpose(0, 1), ref, rows)
        pairs = int(mask[rows].sum().item())
        lo = max(start - W + 1, 0) if sliding else 0
        nbytes = 2.0 * (2 * true_len * H * Dh + 2 * (seq_len - lo) * KVH * Dh)
        b_ms, b_by = bound(nbytes, 4.0 * H * Dh * pairs)
        masked = "the causal" + (" and window" if sliding else "")
        flex = f"torch.compile(flex_attention) with {masked} block mask"
        sdpa = f"scaled_dot_product_attention with {masked} mask"
        case = {"mode": mode, "T": T, "start_pos": start,
                "true_len": true_len, "seq_len": seq_len, "sliding": sliding,
                "window": W, "softcap": cap, "H": H, "KVH": KVH, "Dh": Dh,
                "q_gain": q_gain, "max_abs_err": err, "max_row_rel_err": rel,
                "fault_row_rel_err": fault_rel, "repeat_bits_equal": True,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
        if cap:
            case.update(library_ms=flex_ms, library="torch.compile("
                        f"flex_attention) with score_mod cap*tanh(s/cap) and "
                        f"{masked} block mask", library_row_rel_err=flex_rel,
                        ms_no_softcap=ms_nocap, library_ms_no_softcap=sdpa_ms,
                        library_no_softcap=sdpa + ", no softcap")
        else:
            # SDPA's output is not kept; flex's is held to the limit
            case.update(library_candidates_ms={"sdpa": sdpa_ms,
                                               "flex_attention": flex_ms},
                        library_ms=min(sdpa_ms, flex_ms),
                        library=sdpa if sdpa_ms <= flex_ms else flex,
                        library_row_rel_err=flex_rel)
        del mask, flex_out, ref, q, k, v, qs, ks, vs
        log(f"flash_prefill {json.dumps(case)}")
        check_limit(what, rel, fault_rel)
        check_limit(f"{what} library_row_rel_err", flex_rel, {})
        cases.append(case)
    torch.cuda.empty_cache()
    return {"name": "flash_prefill", "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "dynamo_tpu/engine/attention.py:220",
            "row_rel_tolerance": KERNEL_ROW_REL_TOL, **cases[0],
            "cases": cases}


def check_gemma_kernels(cfg, dev) -> list:
    """Phase 3g: K1, K3 and K4 in Gemma-2's modes, then K5 (the tied int8
    head, 3584 x 256000) and K6 at the Gemma-2-9B widths."""
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    QD, KVD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    # a 2048-token chunk at positions 4096-6143 over 6144 keys, soft-capped,
    # on a sliding layer (its first 1-2047 keys are dead for some rows) and
    # on a global layer
    chunks = [(2048, 4096, 2048, True), (2048, 4096, 2048, False)]
    entries = [check_window_flash_prefill(cfg, dev, GEMMA_MODE, chunks,
                                          GEMMA_Q_GAIN, 21),
               check_paged_attention(cfg, dev, cases=GEMMA_ATTN),
               check_paged_attention(cfg, dev, int8=True, cases=GEMMA_ATTN),
               check_ragged_attention(cfg, dev, cases=GEMMA_ATTN),
               check_ragged_attention(cfg, dev, int8=True, cases=GEMMA_ATTN)]
    head = check_lm_head_int8(cfg, dev)
    int4 = check_grouped_int4(cfg, dev, shapes=[
        ((D, QD), (1, 8)), ((D, KVD), (1, 8)), ((D, Fi), (1, 8, 512)),
        ((QD, D), (1, 8)), ((Fi, D), (1, 8))])
    for e in (head, int4):
        e["mode"] = GEMMA_SHAPES_MODE
    return entries + [head, int4]




def prefill_without_window(q, k, v, *, scale, start_pos, seq_len,
                           softcap=None, **_):
    """K1 with a planted fault: every layer global (the tiles below a
    sliding layer's window run and count)."""
    from dynamo_tpu_torch.engine.kernels import flash_prefill_cuda
    return flash_prefill_cuda(q, k, v, scale=scale, start_pos=start_pos,
                              seq_len=seq_len, softcap=softcap or 0.0)


def decode_without_window(q, k_cache, v_cache, block_tables, seq_lens, *,
                          block_size, scale, softcap=None, **_):
    """K3 (either pool) with a planted fault: every layer global."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    fn = (kernels.paged_attention_int8_cuda if k_cache.dtype == torch.int8
          else kernels.paged_attention_cuda)
    return fn(q, k_cache, v_cache, block_tables, seq_lens,
              block_size=block_size, scale=scale, softcap=softcap or 0.0)


def ragged_without_window(q, k_cache, v_cache, block_tables, seq_starts,
                          seq_counts, seq_lens, *, block_size, scale,
                          max_rows, softcap=None, **_):
    """K4 (either pool) with a planted fault: every layer global."""
    import torch
    from dynamo_tpu_torch.engine import kernels
    fn = (kernels.ragged_paged_attention_int8_cuda
          if k_cache.dtype == torch.int8 else kernels.ragged_paged_attention_cuda)
    return fn(q, k_cache, v_cache, block_tables, seq_starts, seq_counts,
              seq_lens, block_size=block_size, scale=scale,
              max_rows=max_rows, softcap=softcap or 0.0)


def ragged_over_prompt(prompt: int, M: int) -> Callable:
    """The ragged dispatch of a long-prompt run (4g, 4p) over the pool its
    ``prompt``-token prompt wrote: slot 0's decode row at position
    ``prompt`` and slot 1's 64-row chunk ending at ``prompt`` rounded down
    to a block, continuing the prompt's blocks before it (a prefix hit)
    into blocks of its own: a ModelRun ``ragged`` function giving (pool,
    tables, dispatches, slots read)."""
    def ragged(cfg, dev, seed: int, kv_quant: str, kv, table, tokens,
               n_blocks: int) -> tuple:
        import torch
        B = 2
        shared = (prompt - RAGGED_MAX_ROWS) // KV_BLOCK
        p1 = shared * KV_BLOCK
        tables = torch.zeros((B + 1, M), dtype=torch.int32, device=dev)
        tables[0] = table
        tables[1, :shared] = table[:shared]
        own = -(-(p1 + RAGGED_MAX_ROWS) // KV_BLOCK) - shared
        tables[1, shared:shared + own] = torch.arange(
            1 + n_blocks, 1 + n_blocks + own, device=dev)
        toks = tokens.tolist()
        batch = ragged_batch({0: (1, prompt), 1: (RAGGED_MAX_ROWS, p1)},
                             [toks + [7], toks], tables, B, dev)
        return kv, tables, [batch], B
    return ragged


# phase 4g: the window dropped from K1, K3 and K4 as their planted faults
# (the ragged dispatch: slot 0's decode row at 4600, slot 1's 64-row chunk
# at 4528-4591 continuing the prompt's first 283 blocks)
GEMMA_RUN = ModelRun("gemma2", GEMMA_PROMPT, GEMMA_BUCKET, GEMMA_STEPS,
                     GEMMA_MAX_LEN, prefill_without_window, decode_without_window,
                     ragged_over_prompt(GEMMA_PROMPT, GEMMA_M),
                     ragged_without_window, False)


# ---------------------------------------------------------------------------
# phases 3m-5m: DeepSeek-V2-Lite (MLA)
# ---------------------------------------------------------------------------

# the MLA servers' max length, and the engine's auto block size by KV pool
# (EngineConfig.auto_kv_block_size: 16 for bf16 rows, 32 for int8)
MLA_MAX_LEN = 4096
MLA_BLOCK = (16, 32)
# q_lat and q_pe at 0.1 of the rows' scale, k_pe 8x c (post-rope k_pe is
# unnormalized, c_kv RMS-normed): the scores of a 4096-key row then spread
# over a few units, and swapping the two sections' scales moves every row
MLA_Q_STD, MLA_PE_GAIN = 0.1, 8.0
# the lanes by which the V-lanes fault rolls query and rows
MLA_V_LATE = 64
# phase 4m: a 3000-token prompt (bucket 4096), 4 decode steps
MLA_PROMPT, MLA_BUCKET, MLA_STEPS = 3000, 4096, 4


def mla_config():
    from dynamo_tpu_torch.engine.config import ModelConfig
    return ModelConfig.from_hf_config(DEEPSEEK_V2_LITE_CONFIG)


def latent_inputs(cfg, dev, seed: int, lens, int8: bool, bs: int, M: int,
                  n_rows=None) -> tuple:
    """pool_inputs for the MLA modes: one latent pool of random rows (c ~
    N(0, 1), k_pe ~ N(0, MLA_PE_GAIN^2); bf16 rows zero-padded to
    ``mla.latent_row_lanes``, or their sectioned int8 encoding) and
    queries [n_rows or len(lens), H, query lanes] = [q_lat | q_pe | 0]
    bf16. Returns q, pool, None (the pool is K and V), tables, lens."""
    import torch
    from dynamo_tpu_torch.engine.attention import quantize_kv_rows_sections
    from dynamo_tpu_torch.engine.models import mla
    rank, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = (len(lens) * M + 1) * bs
    vals = torch.randn((rows, rank + dr), generator=gen, device=dev)
    vals[:, rank:] *= MLA_PE_GAIN
    W = mla.latent_row_lanes(cfg, "int8" if int8 else "none")
    pool = torch.zeros((rows, W), device=dev,
                       dtype=torch.int8 if int8 else torch.bfloat16)
    if int8:
        enc = quantize_kv_rows_sections(vals, (rank, dr))
        pool[:, :enc.shape[1]] = enc
    else:
        pool[:, :rank + dr] = vals.bfloat16()
    del vals
    tables = shuffled_tables(gen, lens, M, bs, dev)
    q = torch.randn((n_rows or len(lens), cfg.num_heads,
                     mla.latent_row_lanes(cfg, "none")), generator=gen,
                    device=dev) * MLA_Q_STD
    q[..., rank + dr:] = 0
    return (q.bfloat16(), pool, None, tables,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def v_lanes_late(q, pool) -> tuple:
    """The latent kernels' fault over bf16 rows: q and the rows rolled by
    MLA_V_LATE lanes, so that the scores stay and V becomes the lanes
    MLA_V_LATE on."""
    import torch
    return (torch.roll(q, -MLA_V_LATE, -1).contiguous(),
            torch.roll(pool, -MLA_V_LATE, -1).contiguous())


def sections_swapped(pool, sections: tuple):
    """The latent kernels' fault over int8 rows: the two sections' scale
    pairs (the lanes after the sections' values) swapped."""
    s = sum(sections)
    bad = pool.clone()
    bad[:, s:s + 2], bad[:, s + 2:s + 4] = pool[:, s + 2:s + 4], pool[:, s:s + 2]
    return bad


def latent_faults(cases, kernel, q, pool, _, rows, int8: bool) -> dict:
    """pool_faults for the MLA modes: over bf16 rows V taken MLA_V_LATE
    lanes late (v_lanes_late), over int8 rows the two sections' scales
    swapped (sections_swapped)."""
    if int8:
        return {"section_scales_swapped": kernel(
            kc=sections_swapped(pool, cases.sections))}
    qq, pp = v_lanes_late(q, pool)
    return {f"v_lanes_off_by_{MLA_V_LATE}": kernel(qq=qq, kc=pp)}


# K3-MLA and K4-MLA at V2-Lite's shapes (16 heads over one latent row of
# [c_kv | k_pe], the output the c_kv lanes). K3: a mix of 8 slots across
# the chunk boundaries, 3000 and 4096 keys and an empty slot; the full
# batch of 8 x 4096 keys. K4: a mix of two 64-row chunks, a 4-row tail
# ending at 3000 and decode rows (135 rows, padded to the server's 136
# for the capacity case); two 64-row chunks and 6 decode rows at up to
# 4096 keys; the pad-row mix: counts of 6, 3, 1, 7 and 2 rows, whose last
# tiles' pad rows fall on the first rows of the next sequence (7 rows); K3
# on one 4096-key row among 8 slots whose other 7 are empty, the graphed
# decode step's shape with one live slot
MLA_ATTN = AttnCases(
    max_len=MLA_MAX_LEN,
    paged_mix=[1, 127, 128, 129, 1000, 3000, 4096, 0],
    paged_boundary=None,
    paged_full=[MLA_MAX_LEN] * 8,
    ragged_mix=[(64, 64), (64, 1000), (4, 3000), (1, 1), (1, 129),
                (1, 4096), (0, 0), (0, 0)],
    ragged_boundary=None,
    ragged_full=[(64, 4096), (64, 2048)] + [(1, 4096)] * 6 + [(0, 0)],
    ragged_decode=None,
    v_lanes=DEEPSEEK_V2_LITE_CONFIG["kv_lora_rank"],
    sections=(DEEPSEEK_V2_LITE_CONFIG["kv_lora_rank"],
              DEEPSEEK_V2_LITE_CONFIG["qk_rope_head_dim"]),
    block=MLA_BLOCK, inputs=latent_inputs, faults=latent_faults, mode="mla",
    seed=40,
    ragged_pad=[(6, 500), (3, 1001), (1, 4096), (7, 64), (2, 2000), (0, 0)],
    paged_single=[MLA_MAX_LEN] + [0] * 7)


def latent_plain_f32(ref):
    """The plain version ``ref`` (``paged_attention_ref`` or
    ``ragged_paged_attention_ref``) with the dispatcher's signature, run
    in f32 on the kernel's own bf16 query and rows and cast back: 4m's
    reference, so that only the kernel's roundings (bf16 probabilities
    into P.V, a bf16 output) separate the two model runs."""
    import torch

    def plain(q, k_cache, v_cache, *args, **kw):
        pool = k_cache if k_cache.dtype == torch.int8 else k_cache.float()
        return ref(q.float(), pool, None, *args, **kw).to(q.dtype)
    return plain


def decode_latent_fault(q, k_cache, v_cache, block_tables, seq_lens, *,
                        block_size, scale, v_lanes=None, quant_sections=None,
                        **_):
    """K3-MLA with a planted fault: V MLA_V_LATE lanes late over bf16
    rows (v_lanes_late), the sections' scales swapped over int8 rows
    (sections_swapped)."""
    from dynamo_tpu_torch.engine import kernels
    if quant_sections is not None:
        pool = sections_swapped(k_cache, quant_sections)
    else:
        q, pool = v_lanes_late(q, k_cache)
    return kernels.latent_paged_attention_cuda(
        q, pool, block_tables, seq_lens, block_size=block_size, scale=scale,
        v_lanes=v_lanes, quant_sections=quant_sections)


def ragged_latent_v_late(q, k_cache, v_cache, block_tables, seq_starts,
                         seq_counts, seq_lens, *, block_size, scale,
                         max_rows, v_lanes=None, **_):
    """K4-MLA with a planted fault: V MLA_V_LATE lanes late
    (v_lanes_late)."""
    from dynamo_tpu_torch.engine import kernels
    return kernels.latent_ragged_attention_cuda(
        *v_lanes_late(q, k_cache), block_tables, seq_starts, seq_counts,
        seq_lens, block_size=block_size, scale=scale, max_rows=max_rows,
        v_lanes=v_lanes)


def ragged_mla(cfg, dev, seed: int, kv_quant: str, kv, table, tokens,
               n_blocks: int) -> tuple:
    """One ragged dispatch over the pool phase 4m's prompt and decode steps
    wrote: slot 0's next row and a fresh 64-row chunk on slot 1's blocks:
    (pool, tables, dispatches, slots read)."""
    import torch
    B = 2
    tables = torch.zeros((B + 1, table.shape[0]), dtype=torch.int32,
                         device=dev)
    tables[0] = table
    tables[1, :n_blocks] = torch.arange(1 + n_blocks, 1 + 2 * n_blocks,
                                        device=dev)
    toks = tokens.tolist()
    batch = ragged_batch({0: (1, MLA_PROMPT + MLA_STEPS),
                          1: (RAGGED_MAX_ROWS, 0)}, [toks, toks], tables, B,
                         dev)
    return kv, tables, [batch], B


# phase 4m: prefill is a plain einsum (no K1); K3-MLA's fault by pool;
# the ragged dispatch over the prompt's pool through K4-MLA (bf16 pool: an
# int8 pool's ragged rows gather, as in the JAX package)
MLA_RUN = ModelRun("V2-Lite", MLA_PROMPT, MLA_BUCKET, MLA_STEPS, MLA_MAX_LEN,
                   None, decode_latent_fault, ragged_mla,
                   ragged_latent_v_late, False, block=MLA_BLOCK,
                   plain=latent_plain_f32,
                   attn_kernels=("latent_paged_attention",
                                 "latent_ragged_attention"), verify=True)


# ---------------------------------------------------------------------------
# phases 3p-5p: Phi-3-mini (head dim 96, a window on every layer)
# ---------------------------------------------------------------------------

# Phi-3-mini-4k's whole context: 256 blocks of 16 tokens a sequence (at a
# max length of 2047 or less the engine would drop the window)
PHI3_MAX_LEN = 4096
PHI3_M = PHI3_MAX_LEN // KV_BLOCK
PHI3_WINDOW = PHI3_MINI_4K_CONFIG["sliding_window"]
# the kernel entries of head dim 96 with the window, and of K5 / K6 at the
# Phi-3-mini widths
PHI3_MODE = "phi3_dh96_window"
PHI3_SHAPES_MODE = "phi3_mini_shapes"
# q scaled as in phase 3g (GEMMA_Q_GAIN says why): with no soft-cap the
# scores then reach a std of ~6, at which the window one key wider moves a
# row whose planted key (mark_dead_keys) scores highest
PHI3_Q_GAIN = 6.0
# phase 4p: a 3000-token prompt in a 4096-token bucket (the window binds in
# prefill: its last rows see 2047 of the 3000 keys), then 4 decode steps
PHI3_PROMPT, PHI3_BUCKET, PHI3_STEPS = 3000, 4096, 4
# K1 at head dim 96: a 2048-token chunk after a 958-token prefix hit, whose
# live keys end in row 61 of the last 64-key tile (rows 60-63 of a tile are
# the ones a row mapping that assumes Dh / 8 divides the 128 threads would
# leave stale), and phase 4p's prompt in its bucket
PHI3_PREFILL = [(2048, 958, 2048, True), (PHI3_BUCKET, 0, PHI3_PROMPT, True)]
# K3 and K4 at Phi-3-mini's heads (32 of 96 over 32 KV heads, g = 1) over
# the 4096-key table, as GEMMA_ATTN's cases are built: K3's mix across the
# window's edge, window floors on the split boundaries, the full batch of
# 8 x 4096 keys; K4's mix of a 48-row chunk ending at 3000, decode rows on
# both sides of the window's edge and at the table's end, a 16-row chunk
# ending at 2200, its split boundaries, two 64-row chunks and 6 decode rows
# at 4096 keys, and 8 decode rows at phase 4p's first decode position
PHI3_ATTN = AttnCases(
    max_len=PHI3_MAX_LEN,
    paged_mix=[2047, 2048, 2049, 3000, 4096, 100, 1, 0],
    paged_boundary=[PHI3_WINDOW + n for n in (127, 128, 129, 256)]
    + [PHI3_MAX_LEN, 0],
    paged_full=[PHI3_MAX_LEN] * 8,
    ragged_mix=[(48, 3000), (1, 2047), (1, 2048), (1, 2049), (1, 4096),
                (16, 2200), (1, 100), (0, 0), (0, 0)],
    ragged_boundary=[(1, PHI3_WINDOW + 127), (1, PHI3_WINDOW + 128),
                     (1, PHI3_WINDOW + 129), (1, PHI3_WINDOW + 256),
                     (20, PHI3_WINDOW + 140), (64, PHI3_MAX_LEN), (0, 0),
                     (1, 1), (0, 0)],
    ragged_full=[(64, PHI3_MAX_LEN)] * 2 + [(1, PHI3_MAX_LEN)] * 6
    + [(0, 0)],
    ragged_decode=[(1, PHI3_PROMPT + 1)] * 8 + [(0, 0)],
    window=PHI3_WINDOW, q_gain=PHI3_Q_GAIN, mode=PHI3_MODE, seed=30)


def phi3_config():
    from dynamo_tpu_torch.engine.config import ModelConfig
    return ModelConfig.from_hf_config(PHI3_MINI_4K_CONFIG)


def check_phi3_kernels(cfg, dev) -> list:
    """Phase 3p: K1 with the window at head dim 96 (PHI3_PREFILL); K2 on
    phase 3's ring hops and the ring over 2 and 4 shards at head dim 96
    (no served path: the ring refuses windows, and only the 128k variant,
    whose longrope factors are not in the repository, drops its window);
    K3 and K4, bf16 and int8, through phase 3's checks (PHI3_ATTN); then K5
    (the untied int8 head, 3072 x 32064, a vocab that is not a multiple of
    128) and K6 at the Phi-3-mini layer shapes."""
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    k2 = check_flash_prefill_partial(cfg, dev)
    k2["ring"] = check_ring(cfg, dev)
    k2.update(mode=PHI3_MODE, on_main_path=False)
    entries = [check_window_flash_prefill(cfg, dev, PHI3_MODE, PHI3_PREFILL,
                                          PHI3_Q_GAIN, 31), k2,
               check_paged_attention(cfg, dev, cases=PHI3_ATTN),
               check_paged_attention(cfg, dev, int8=True, cases=PHI3_ATTN),
               check_ragged_attention(cfg, dev, cases=PHI3_ATTN),
               check_ragged_attention(cfg, dev, int8=True, cases=PHI3_ATTN)]
    head = check_lm_head_int8(cfg, dev)
    # q, k, v and o are D -> D (MHA), gate and up D -> Fi, down Fi -> D
    int4 = check_grouped_int4(cfg, dev, shapes=[
        ((D, D), (1, 8)), ((D, Fi), (1, 8, 512)), ((Fi, D), (1, 8))])
    for e in (head, int4):
        e["mode"] = PHI3_SHAPES_MODE
    return entries + [head, int4]


# phase 4p: the window dropped from K1, K3 and K4 as their planted faults;
# the ragged dispatch: slot 0's decode row at 3000, slot 1's 64-row chunk
# at 2928-2991 continuing the prompt's first 183 blocks
PHI3_RUN = ModelRun("phi3", PHI3_PROMPT, PHI3_BUCKET, PHI3_STEPS,
                    PHI3_MAX_LEN, prefill_without_window,
                    decode_without_window,
                    ragged_over_prompt(PHI3_PROMPT, PHI3_M),
                    ragged_without_window, False)


# ---------------------------------------------------------------------------
# phases 3q-5q: Qwen2-7B (a GQA group of 7, qkv bias)
# ---------------------------------------------------------------------------

# Qwen2-7B's table: 512 blocks of 16 tokens a sequence (K3's and K4's
# scratch is sized from the table width, so not its 32768 positions)
QWEN2_MAX_LEN = 8192
QWEN2_M = QWEN2_MAX_LEN // KV_BLOCK
# the kernel entries of the GQA group 7 (K1-K4; K3 and K4 also at the other
# groups of QWEN2_GROUPS), and of K5 / K6 at the Qwen2-7B widths
QWEN2_MODE = "qwen2_g7"
QWEN2_SHAPES_MODE = "qwen2_7b_shapes"
# phase 4q: a 6000-token prompt in its 8192-token bucket, then 4 decode
# steps
QWEN2_PROMPT, QWEN2_BUCKET, QWEN2_STEPS = 6000, 8192, 4
# K1 at g = 7: phase 4q's prompt in its bucket, and a 2048-row chunk after
# a 4000-token prefix hit (2000 rows live)
QWEN2_PREFILL = [(QWEN2_BUCKET, 0, QWEN2_PROMPT, False),
                 (2048, 4000, 2000, False)]
# K3 and K4 at Qwen2-7B's heads (28 of 128 over 4 KV heads, g = 7) over the
# 8192-key table. K3: an 8-slot mix, its split boundaries, the full batch
# of 8 x 8192 keys. K4 takes 9 rows a tile (63 of its 64 query vectors;
# the 64th a pad that must write nothing): its mix holds a fresh 64-row
# prompt and a fresh 20-row one (tiles with one live chunk: the direct
# write) and 30 rows continuing to 1000 keys (tiles with several: the
# partials), each crossing tiles, beside decode rows up to the table's end;
# its split boundaries; two 64-row chunks and 6 decode rows at 8192 keys;
# 8 decode rows at phase 4q's first decode position
QWEN2_ATTN = AttnCases(
    max_len=QWEN2_MAX_LEN,
    paged_mix=[1, 17, 255, 1000, 4097, 6000, QWEN2_MAX_LEN, 0],
    paged_boundary=[127, 128, 129, 256, QWEN2_MAX_LEN, 0],
    paged_full=[QWEN2_MAX_LEN] * 8,
    ragged_mix=[(64, 64), (30, 1000), (20, 20), (1, 1), (1, 255),
                (1, 6000), (1, QWEN2_MAX_LEN), (0, 0), (0, 0)],
    ragged_boundary=[(1, 127), (1, 128), (1, 129), (1, 256), (20, 140),
                     (64, QWEN2_MAX_LEN), (0, 0), (1, 1), (0, 0)],
    ragged_full=[(64, QWEN2_MAX_LEN)] * 2 + [(1, QWEN2_MAX_LEN)] * 6
    + [(0, 0)],
    ragged_decode=[(1, QWEN2_PROMPT + 1)] * 8 + [(0, 0)],
    mode=QWEN2_MODE, seed=40, flex=True)
# the other groups K3 and K4 compile since this slice, as (g, H, KVH, Dh):
# Qwen2-1.5B's 6 (at Dh 128 here), Qwen2.5-14B's and -32B's 5,
# Llama-3.2-3B's 3, and 7 at Dh 64 (Qwen2-0.5B); one mix each over a
# 2048-key table, K4's tiles crossed as above (10, 12, 21 and 9 rows a
# tile), SDPA alone as the yardstick (a flex_attention compile per shape
# would cost the run more than these cases)
QWEN2_GROUPS = [(6, 12, 2, 128), (5, 40, 8, 128), (3, 24, 8, 128),
                (7, 14, 2, 64)]
QWEN2_GROUP_ATTN = dataclasses.replace(
    QWEN2_ATTN, max_len=MAX_MODEL_LEN,
    paged_mix=[1, 17, 129, 255, 700, 1000, MAX_MODEL_LEN, 0],
    paged_boundary=None, paged_full=None,
    ragged_mix=[(64, 64), (30, 1000), (20, 20), (1, 1), (1, 255),
                (1, MAX_MODEL_LEN), (0, 0), (0, 0)],
    ragged_boundary=None, ragged_full=None, ragged_decode=None,
    mode="qwen2_groups", seed=50, flex=False)
# the readings kept of each other group's case in its g = 7 entry
GROUP_KEYS = ("max_row_rel_err", "fault_row_rel_err", "tile_crossings",
              "ms", "plain_ms", "library_ms", "library", "bound_ms",
              "bound_by")
# the biases' scale in the random weights (init_params draws them 0, the
# JAX init rule): as large as the projections (matmuls N(0, 1/fan_in) give
# q, k and v of ~N(0, 1)), so that dropping them moves the logits past the
# limit, as real Qwen2 checkpoints' k biases do
QWEN2_BIAS_STD = 1.0


def heads_interleaved(attr: str) -> Callable:
    """The attention function ``attention.<attr>`` (K1's or K3's, as the
    model calls it) with a planted GQA fault: query head h reads KV head h
    % KVH, the interleaved mapping, in place of h // g. The query heads are
    permuted so that the kernel serves the wrong mapping, and the output
    permuted back. Over a long prompt every key carries ~1/6000 of a row,
    so a fault that drops a tile or a block moves the logits less than
    their own rounding; this one moves every row."""
    def fault(q, k, *args, **kw):
        import torch
        from dynamo_tpu_torch.engine import attention
        H, Dh = q.shape[1], q.shape[2]
        KVH = (k.shape[1] if k.dim() == 3
               else attention.kv_value_lanes(k) // Dh)
        g = H // KVH
        src = torch.tensor([(j % g) * KVH + j // g for j in range(H)],
                           device=q.device)
        dst = torch.tensor([(h % KVH) * g + h // KVH for h in range(H)],
                           device=q.device)
        out = getattr(attention, attr)(q[:, src].contiguous(), k, *args,
                                       **kw)
        return out[:, dst].contiguous()
    fault.__name__ = f"{attr}_heads_interleaved"
    return fault


def qwen2_config():
    from dynamo_tpu_torch.engine.config import ModelConfig
    return ModelConfig.from_hf_config(QWEN2_7B_CONFIG)


def live_qkv_biases(params, seed: int) -> None:
    """Overwrite the zero q, k and v biases of random weights with seeded
    draws of QWEN2_BIAS_STD, in place (a served engine's weights too, before
    its decode graphs are captured)."""
    import torch
    dev = params["layers.bq"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    for name in ("layers.bq", "layers.bk", "layers.bv"):
        t = params[name]
        t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                * QWEN2_BIAS_STD)


def without_qkv_bias(params) -> dict:
    """The planted fault of phase 4q: the qkv biases dropped."""
    import torch
    return {**params, **{n: torch.zeros_like(params[n]) for n in
                         ("layers.bq", "layers.bk", "layers.bv")}}


def check_qwen2_kernels(cfg, dev) -> list:
    """Phase 3q: K1 at g = 7 (QWEN2_PREFILL, the last KV tile left out
    planted); K2 on phase 3's ring hops at g = 7 (no served path: the sp
    ring is the 8B path's); K3 and K4, bf16 and int8, through phase 3's
    checks at g = 7 (QWEN2_ATTN; K4 with the pad vectors' planted fault),
    each also at the groups of QWEN2_GROUPS (QWEN2_GROUP_ATTN); then K5
    (the untied int8 head, 3584 x 152064) and K6 at the Qwen2-7B layer
    shapes."""
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    k2 = check_flash_prefill_partial(cfg, dev)
    k2.update(mode=QWEN2_MODE, on_main_path=False)
    entries = [check_window_flash_prefill(cfg, dev, QWEN2_MODE,
                                          QWEN2_PREFILL, 1.0, 41), k2]
    for check in (check_paged_attention, check_ragged_attention):
        for int8 in (False, True):
            e = check(cfg, dev, int8=int8, cases=QWEN2_ATTN)
            e["other_groups"] = {}
            for g, H, KVH, Dh in QWEN2_GROUPS:
                other = check(dataclasses.replace(
                    cfg, num_heads=H, num_kv_heads=KVH, head_dim=Dh), dev,
                    int8=int8, cases=QWEN2_GROUP_ATTN)
                e["other_groups"][f"g{g}_h{H}_kvh{KVH}_dh{Dh}"] = {
                    k: other[k] for k in GROUP_KEYS if k in other}
            entries.append(e)
    head = check_lm_head_int8(cfg, dev)
    # q and o are D -> D, k and v D -> 512 (the narrowest K6 output
    # served), gate and up D -> Fi, down Fi -> D
    int4 = check_grouped_int4(cfg, dev, shapes=[
        ((D, D), (1, 8)), ((D, KVD), (1, 8)), ((D, Fi), (1, 8, 512)),
        ((Fi, D), (1, 8))])
    for e in (head, int4):
        e["mode"] = QWEN2_SHAPES_MODE
    return entries + [head, int4]


# phase 4q: K1 and K3 with the query heads mapped to the KV heads
# interleaved (heads_interleaved), K4's last block read as the trash block,
# the qkv biases dropped; the ragged dispatches of phase 4 (two fresh
# 64-row chunks, then a decode row, a chunk continuing a prefix and a fresh
# one: each chunk crosses K4's 9-row tiles)
QWEN2_RUN = ModelRun("qwen2", QWEN2_PROMPT, QWEN2_BUCKET, QWEN2_STEPS,
                     QWEN2_MAX_LEN, heads_interleaved("flash_prefill"),
                     heads_interleaved("paged_attention"), ragged_llama,
                     ragged_without_last_block, False)


# ---------------------------------------------------------------------------
# phase 5: the HTTP server at the 8B width
# ---------------------------------------------------------------------------


# the words the smoke run's tokenizers hold whole
WORDS = ("the of and to in is that for it as with was on be by at this from "
         "are or an which one all would there their what so up out if about "
         "who get go me when make can like time no just him know take "
         "people into year your good some could them see other than then "
         "now look only come its over think also back after use two how our "
         "work first well way even new want because any these give day most "
         "us").split()


def write_model_dir(path: str, cfg, hf=None) -> None:
    """config.json (``hf``, else the 8B geometry's) + a SentencePiece
    tokenizer covering all of the vocab: control pieces (Llama's <unk>,
    <s>, </s>, also for a phi3 or qwen2 ``hf``, whose end of text is a
    control piece at its eos id; with another ``hf``, Gemma's <pad>, <eos>, <bos>, <unk>
    at its ids 0-3), the 256 byte pieces, some letters and words, then
    synthetic pieces up to the vocab size."""
    from dynamo_tpu_torch.llm.sp_model import (BYTE, CONTROL, NORMAL,
                                               UNKNOWN, write_model_proto)
    if hf is None or hf.get("model_type") in ("phi3", "qwen2"):
        pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
                  ("</s>", 0.0, CONTROL)]
        ids = dict(unk_id=0, bos_id=1,
                   eos_id=2 if hf is None else hf["eos_token_id"])
    else:
        pieces = [("<pad>", 0.0, CONTROL), ("<eos>", 0.0, CONTROL),
                  ("<bos>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN)]
        ids = dict(unk_id=3, bos_id=hf["bos_token_id"],
                   eos_id=hf["eos_token_id"],
                   pad_id=hf.get("pad_token_id", 0))
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    pieces += [("▁" + w, -2.0, NORMAL) for w in WORDS]
    pieces += [(c, -6.0, NORMAL) for c in
               "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "0123456789.,;:!?'\"-()▁"]
    i = 0
    while len(pieces) < cfg.vocab_size:
        pieces.append((f"▁t{i}", -12.0, NORMAL))
        i += 1
    for name in ("bos_id", "eos_id"):   # DeepSeek's, Phi-3's eos past the bytes
        if ids[name] >= 4:
            pieces[ids[name]] = (f"<{name[:3]}>", 0.0, CONTROL)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(write_model_proto(pieces, **ids))
    if hf is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f)
        return
    hf = {"model_type": "llama", "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "head_dim": cfg.head_dim,
          "max_position_embeddings": cfg.max_position_embeddings,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)


def http_request(port: int, path: str, body: Optional[dict] = None,
                 timeout: float = 600,
                 on_event: Optional[Callable] = None) -> dict:
    """GET ``path`` (no body) or POST ``body`` to it. A JSON answer comes
    back as ``response``; an SSE answer as its ``events`` (the port's
    ``SseParser``: data, event, comments), the arrival time of each data
    event and whether it ended in [DONE]; ``on_event`` sees each event as
    it arrives."""
    import http.client
    from dynamo_tpu_torch.llm.protocols.sse import SseParser
    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status,
               "request_id": resp.getheader("X-Request-Id")}
        if resp.status != 200:
            raise RuntimeError(f"{path}: HTTP {resp.status}: "
                               f"{resp.read()[:500]!r}")
        if resp.getheader("Content-Type") != "text/event-stream":
            raw = resp.read()
            out["response"] = (json.loads(raw) if path.startswith("/v1")
                               else raw.decode())
            out["latency_s"] = time.monotonic() - t0
            return out
        parser, events, times, done = SseParser(), [], [], False
        while not done:
            line = resp.readline()
            if not line:
                break
            for ev in parser.push(line.decode()):
                if ev.is_done:
                    done = True
                    break
                events.append(ev)
                times.append(time.monotonic() - t0)
                if on_event is not None:
                    on_event(ev)
        out.update(events=events, times=times, done=done,
                   latency_s=time.monotonic() - t0)
        return out
    finally:
        conn.close()


def http_completion(port: int, body: dict, timeout: float = 600) -> dict:
    """POST /v1/completions; for ``stream`` bodies, the SSE chunks and the
    arrival time of each. Returns the parsed result plus client-side
    timings."""
    res = http_request(port, "/v1/completions", body, timeout)
    if "events" not in res:
        return {"response": res["response"], "latency_s": res["latency_s"]}
    data = [(e, t) for e, t in zip(res["events"], res["times"]) if e.data]
    return {"chunks": [json.loads(e.data) for e, _ in data],
            "times": [t for _, t in data], "done": res["done"],
            "latency_s": res["latency_s"]}


def check_stream(name: str, res: dict, max_tokens: int,
                 want_usage: bool) -> dict:
    if not res["done"]:
        raise RuntimeError(f"{name}: SSE stream did not end in [DONE]")
    usage = [c["usage"] for c in res["chunks"] if c.get("usage")]
    finish = [c["choices"][0]["finish_reason"] for c in res["chunks"]
              if c.get("choices") and c["choices"][0].get("finish_reason")]
    if finish != ["length"]:
        raise RuntimeError(f"{name}: finish reasons {finish}")
    if want_usage and (not usage
                       or usage[-1]["completion_tokens"] != max_tokens):
        raise RuntimeError(f"{name}: usage {usage} != {max_tokens} tokens")
    if not want_usage and usage:
        raise RuntimeError(f"{name}: usage sent without include_usage")
    t = [tm for c, tm in zip(res["chunks"], res["times"])
         if c.get("choices") and c["choices"][0].get("text")]
    itl = [b - a for a, b in zip(t, t[1:])]
    return {"ttft_ms": 1e3 * t[0] if t else None,
            "itl_ms_mean": 1e3 * sum(itl) / len(itl) if itl else None,
            "itl_ms_max": 1e3 * max(itl) if itl else None,
            "text_chunks": len(t), "latency_s": res["latency_s"],
            # each token's text, for comparing two servers (not printed)
            "_texts": [c["choices"][0].get("text") for c in res["chunks"]
                       if c.get("choices")]}


def check_unary(name: str, res: dict, max_tokens: int) -> dict:
    out = res["response"]
    ch = out.get("choices") or []
    if (out.get("object") != "text_completion" or len(ch) != 1
            or not isinstance(ch[0].get("text"), str)
            or ch[0].get("finish_reason") != "length"
            or out.get("usage", {}).get("completion_tokens") != max_tokens):
        raise RuntimeError(f"{name}: malformed response {out}")
    return {"latency_s": res["latency_s"], "text": ch[0]["text"][:60],
            # the whole text and token logprobs, for comparing two servers
            # (not printed)
            "_text": ch[0]["text"],
            "_logprobs": (ch[0].get("logprobs") or {}).get(
                "token_logprobs")}


# the kernels each served path must launch
PATH_KERNELS = {
    "bf16": ("flash_prefill", "paged_attention"),
    "int4_kv8": ("flash_prefill", "paged_attention_int8", "lm_head_int8",
                 "grouped_int4_matmul"),
    "ragged": ("ragged_paged_attention",),
    "ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                        "grouped_int4_matmul"),
    "sp": ("flash_prefill_partial", "flash_prefill", "paged_attention"),
    "dispatch": ("flash_prefill", "paged_attention_int8", "lm_head_int8",
                 "grouped_int4_matmul"),
    "ragged_pipeline": ("ragged_paged_attention_int8", "lm_head_int8",
                        "grouped_int4_matmul"),
    "gemma2_bf16": ("flash_prefill", "paged_attention"),
    "gemma2_ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                               "grouped_int4_matmul"),
    "gemma2_int4_kv8": ("flash_prefill", "paged_attention_int8",
                        "lm_head_int8", "grouped_int4_matmul"),
    "gemma2_ragged": ("ragged_paged_attention",),
    "mla_bf16_k8": ("latent_paged_attention",),
    "mla_kv8": ("latent_paged_attention_int8",),
    "mla_ragged": ("latent_ragged_attention",),
    # an int8 latent pool's ragged rows gather (as in the JAX package): no
    # kernel of this list serves them
    "mla_ragged_kv8": (),
    "phi3_bf16_k8": ("flash_prefill", "paged_attention"),
    "phi3_int4_kv8": ("flash_prefill", "paged_attention_int8",
                      "lm_head_int8", "grouped_int4_matmul"),
    "phi3_ragged": ("ragged_paged_attention",),
    "phi3_ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                             "grouped_int4_matmul"),
    "qwen2_bf16_k8": ("flash_prefill", "paged_attention"),
    "qwen2_int4_kv8": ("flash_prefill", "paged_attention_int8",
                       "lm_head_int8", "grouped_int4_matmul"),
    "qwen2_ragged": ("ragged_paged_attention",),
    "qwen2_ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                              "grouped_int4_matmul"),
    "phi3_ckpt_bf16_k8": ("flash_prefill", "paged_attention"),
    "phi3_ckpt_ragged_int4_kv8": ("ragged_paged_attention_int8",
                                  "lm_head_int8", "grouped_int4_matmul"),
    "chat_int4_kv8": ("flash_prefill", "paged_attention_int8",
                      "lm_head_int8", "grouped_int4_matmul"),
    "spec_int4_kv8": ("flash_prefill", "paged_attention_int8",
                      "lm_head_int8", "grouped_int4_matmul"),
    "spec_ragged_int4_kv8": ("ragged_paged_attention_int8", "lm_head_int8",
                             "grouped_int4_matmul"),
    "tier_int4_kv8": ("flash_prefill", "paged_attention_int8",
                      "lm_head_int8", "grouped_int4_matmul"),
    "tier_ragged_bf16": ("ragged_paged_attention",),
    "routed_int4_kv8": ("flash_prefill", "paged_attention_int8",
                        "lm_head_int8", "grouped_int4_matmul"),
    "disagg_int4_kv8": ("flash_prefill", "paged_attention_int8",
                        "lm_head_int8", "grouped_int4_matmul"),
    "disagg_ragged_int4_kv8": ("flash_prefill",
                               "ragged_paged_attention_int8",
                               "lm_head_int8", "grouped_int4_matmul"),
    "fabric_int4_kv8": ("flash_prefill", "paged_attention_int8",
                        "lm_head_int8", "grouped_int4_matmul"),
}
# the Gemma-2-9B servers (5g): bf16 on the split path with 8 decode steps a
# dispatch, int4 + int8 KV with --ragged, and so that every kernel mode of
# phase 3g serves, int4 + int8 KV on the split path and bf16 with --ragged
GEMMA_PATHS = ("gemma2_bf16", "gemma2_ragged_int4_kv8", "gemma2_int4_kv8",
               "gemma2_ragged")
# the DeepSeek-V2-Lite servers (5m): bf16 weights over a bf16 pool with 8
# decode steps a dispatch and over an int8 pool, each again with --ragged
MLA_PATHS = ("mla_bf16_k8", "mla_kv8", "mla_ragged", "mla_ragged_kv8")
# the Phi-3-mini servers (5p): bf16 with 8 decode steps a dispatch and int4
# + int8 KV on the split path, each again with --ragged
PHI3_PATHS = ("phi3_bf16_k8", "phi3_int4_kv8", "phi3_ragged",
              "phi3_ragged_int4_kv8")
# the Qwen2-7B servers (5q): as Phi-3-mini's
QWEN2_PATHS = ("qwen2_bf16_k8", "qwen2_int4_kv8", "qwen2_ragged",
               "qwen2_ragged_int4_kv8")
# the Phi-3-mini checkpoint servers (6), each loading the directory that
# phase 6 writes, and the random-weights server of 5p whose lone greedy
# and seeded requests it must answer with the same tokens
CKPT_TWINS = {"phi3_ckpt_bf16_k8": "phi3_bf16_k8",
              "phi3_ckpt_ragged_int4_kv8": "phi3_ragged_int4_kv8"}
CKPT_PATHS = tuple(CKPT_TWINS)
# the 8B chat server (7), over a tokenizer.json directory
CHAT_PATHS = ("chat_int4_kv8",)
# the 8B speculation servers (8e): --spec-k 4 on 5b's and 5d's flags
SPEC_PATHS = ("spec_int4_kv8", "spec_ragged_int4_kv8")
# the tiered servers (9b): 5b's weights and pool (int4 + int8 KV) on the
# split path at K = 8 pipelined with a host and a disk tier, and bf16
# --ragged --decode-dispatch-pipeline with a host tier; each with a device
# pool smaller than its traffic's working set
TIER_PATHS = ("tier_int4_kv8", "tier_ragged_bf16")
TIER_DEVICE_BLOCKS, TIER_HOST_BLOCKS, TIER_DISK_BLOCKS = 256, 512, 1536
# the traffic: X and Y 1600-token prompts (100 blocks), two conversations
# of three turns (600, +200, +200 tokens), churn of 1000-token requests 3
# at a time (62 blocks written back each, 64 held: no preemption), and two
# decoders of 200 tokens beside Y's restore (9d). After X, 9 churn
# requests write back 558 blocks: more than the host holds, so X leaves it
# for the disk; after Y, 5 write back 310, fewer than the 412 older host
# blocks, while holding 320 device blocks, more than the device pool
TIER_PROMPT, TIER_TURNS, TIER_CHURN = 1600, (600, 200, 200), 1000
TIER_CHURN1, TIER_CHURN2 = 9, 5
TIER_TOKENS, TIER_DECODE_TOKENS = 16, 200
# the round trips (9a): 31 blocks of a 64-block pool, into 31 others
TIER_RT_BLOCKS = 64
# the routed graph (10): two int4 + int8 KV workers of phase 7's shape
# behind the KV-aware processor; its launches are the two workers' sum
ROUTED_PATH = "routed_int4_kv8"
# the disaggregated paths (11a-11d, in one process): a prefill engine (K1,
# K5, K6) hands each prompt's KV to a decode engine (K3-int8, K5, K6), and
# in 11c to a --ragged one (K4-int8 instead of K3-int8)
DISAGG_PATH = "disagg_int4_kv8"
DISAGG_RAGGED_PATH = "disagg_ragged_int4_kv8"
DISAGG_PATHS = (DISAGG_PATH, DISAGG_RAGGED_PATH)
# the fleet KV fabric (12): the in-process engines and the three worker
# processes of phase 12 (the publisher, A and B), summed
FABRIC_PATH = "fabric_int4_kv8"
FABRIC_PATHS = (FABRIC_PATH,)
# the paths that phase 5 does not serve: those of the geometries after the
# 8B one, of the checkpoint, of chat, of speculation, of the KV tiers, of
# the routed graph, of disaggregation and of the fabric
LATER_PATHS = (GEMMA_PATHS + MLA_PATHS + PHI3_PATHS + QWEN2_PATHS
               + CKPT_PATHS + CHAT_PATHS + SPEC_PATHS + TIER_PATHS
               + (ROUTED_PATH,) + DISAGG_PATHS + FABRIC_PATHS)
# the sequence-parallel server (5e): sp = 2 shards on the one card
SERVE_SP = 2
# each served path's weights and KV pool (MODEL_MODES), and whether it
# serves with --ragged
SERVE_PATHS = {"bf16": ("bf16", False), "int4_kv8": ("int4_kv8", False),
               "ragged": ("bf16", True),
               "ragged_int4_kv8": ("int4_kv8", True), "sp": ("bf16", False),
               "dispatch": ("int4_kv8", False),
               "ragged_pipeline": ("int4_kv8", True),
               "gemma2_bf16": ("bf16", False),
               "gemma2_ragged_int4_kv8": ("int4_kv8", True),
               "gemma2_int4_kv8": ("int4_kv8", False),
               "gemma2_ragged": ("bf16", True),
               "mla_bf16_k8": ("bf16", False),
               "mla_kv8": ("bf16_kv8", False),
               "mla_ragged": ("bf16", True),
               "mla_ragged_kv8": ("bf16_kv8", True),
               "phi3_bf16_k8": ("bf16", False),
               "phi3_int4_kv8": ("int4_kv8", False),
               "phi3_ragged": ("bf16", True),
               "phi3_ragged_int4_kv8": ("int4_kv8", True),
               "qwen2_bf16_k8": ("bf16", False),
               "qwen2_int4_kv8": ("int4_kv8", False),
               "qwen2_ragged": ("bf16", True),
               "qwen2_ragged_int4_kv8": ("int4_kv8", True),
               "phi3_ckpt_bf16_k8": ("bf16", False),
               "phi3_ckpt_ragged_int4_kv8": ("int4_kv8", True),
               "chat_int4_kv8": ("int4_kv8", False),
               "spec_int4_kv8": ("int4_kv8", False),
               "spec_ragged_int4_kv8": ("int4_kv8", True)}
# the served paths' (weights, KV pool): phase 4's modes, and bf16 weights
# over an int8 pool (5m)
SERVE_MODES = {**MODEL_MODES, "bf16_kv8": ("none", "int8")}
# the dispatch modes' server (5f): K = 8 steps a dispatch, pipelined, lane
# prefill of admissions of up to 128 un-cached tokens into a busy batch,
# prompts prefilled in chunks of 512
DISPATCH_K, DISPATCH_CHUNK, DISPATCH_LANE = 8, 512, 128
DISPATCH_FLAGS = ["--decode-steps-per-dispatch", str(DISPATCH_K),
                  "--decode-dispatch-pipeline",
                  "--lane-prefill-max-tokens", str(DISPATCH_LANE),
                  "--prefill-chunk", str(DISPATCH_CHUNK)]
# the split path's attention kernels: on a ragged path every admission and
# decode step goes through K4 (or K4-MLA), so these launch 0 times there
SPLIT_ATTENTION = ("flash_prefill", "paged_attention", "paged_attention_int8",
                   "latent_paged_attention", "latent_paged_attention_int8")
# the tiered servers' dispatch flags (9b)
TIER_FLAGS = {
    "tier_int4_kv8": ["--decode-steps-per-dispatch", str(DISPATCH_K),
                      "--decode-dispatch-pipeline"],
    "tier_ragged_bf16": ["--ragged", "--ragged-max-seq-rows",
                         str(RAGGED_MAX_ROWS), "--decode-dispatch-pipeline"]}


def serve_phase(cfg, seed: int, card: str, path: str) -> tuple:
    """Serve from a temporary model directory (the 8B config, or on a
    gemma2 path Gemma-2-9B's config.json, on an mla path DeepSeek-V2-Lite's,
    on a phi3 path Phi-3-mini-4k's, on a qwen2 path Qwen2-7B's, at
    ``cfg``'s depth, + a tokenizer) under phase ``path``. Returns (launch
    counts, per-request report)."""
    import tempfile
    family = path.split("_")[0]
    hf = {"gemma2": GEMMA2_9B_CONFIG, "mla": DEEPSEEK_V2_LITE_CONFIG,
          "phi3": PHI3_MINI_4K_CONFIG, "qwen2": QWEN2_7B_CONFIG}.get(family)
    if hf is not None:
        hf = {**hf, "num_hidden_layers": cfg.num_layers}
    with phase(f"serve {path}"), tempfile.TemporaryDirectory(
            prefix="dtt-serve-") as tmp:
        model_dir = os.path.join(tmp, {
            "gemma2": "gemma2-9b-random",
            "mla": "deepseek-v2-lite-random",
            "phi3": "phi3-mini-4k-random",
            "qwen2": "qwen2-7b-random"}.get(family, "llama3-8b-random"))
        write_model_dir(model_dir, cfg, hf)
        return _serve(cfg, seed, card, model_dir, path)


def start_server(args, core, pipeline=None) -> tuple:
    """Run the launcher's ``serve`` on an event loop of its own in a
    thread, until it listens (``args.http_port`` is then its port).
    Returns (the loop, a function that stops the server and its thread)."""
    import asyncio
    import threading
    from dynamo_tpu_torch.launch import run as launcher
    ready = threading.Event()
    loop = asyncio.new_event_loop()
    holder = {}

    def runner():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(
            launcher.serve(args, core, ready, pipeline=pipeline))
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        except BaseException as e:  # noqa: BLE001 — reported below
            holder["error"] = e
        finally:
            ready.set()          # never leave the main thread waiting

    th = threading.Thread(target=runner, name="http-server", daemon=True)
    th.start()
    if not ready.wait(300) or "error" in holder:
        raise RuntimeError(f"serve: server not ready: {holder.get('error')}")

    def stop():
        if "task" in holder:
            loop.call_soon_threadsafe(holder["task"].cancel)
        th.join(120)
        if th.is_alive():
            raise RuntimeError("serve: server thread did not stop")
        loop.close()
    return loop, stop


def _serve(cfg, seed: int, card: str, model_dir: str, path: str) -> tuple:
    import gc
    import threading
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.launch import run as launcher
    from dynamo_tpu_torch.parallel.sharding import make_mesh
    mode, ragged = SERVE_PATHS[path]
    weights, kv_quant = SERVE_MODES[mode]
    gemma = path.startswith("gemma2")
    mla = path.startswith("mla")
    phi3 = path.startswith("phi3")
    qwen2 = path.startswith("qwen2")
    # the first id past the tokenizer's control and byte pieces
    lo = 260 if gemma or mla else 259
    max_len = (GEMMA_MAX_LEN if gemma else MLA_MAX_LEN if mla
               else PHI3_MAX_LEN if phi3 else QWEN2_MAX_LEN if qwen2
               else MAX_MODEL_LEN)
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir]
        # a checkpoint server loads the directory's weights
        + ([] if path in CKPT_PATHS else ["--random-weights"])
        + ["--http-host", "127.0.0.1", "--http-port", "0",
         "--max-model-len", str(max_len),
         # an MLA engine picks its block size (16 bf16, 32 int8)
         "--kv-block-size", "0" if mla else str(KV_BLOCK),
         "--num-kv-blocks", "2048",
         "--max-num-seqs", "8", "--device", "cuda",
         "--quantization", weights, "--kv-quantization", kv_quant]
        + (["--ragged", "--ragged-max-seq-rows", str(RAGGED_MAX_ROWS)]
           if ragged else [])
        + (DISPATCH_FLAGS if path == "dispatch" else [])
        + (["--decode-dispatch-pipeline"] if path == "ragged_pipeline"
           else [])
        + (["--spec-k", str(SPEC_K)] if path in SPEC_PATHS else [])
        + (["--decode-steps-per-dispatch", str(DISPATCH_K)]
           if path in ("gemma2_bf16", "mla_bf16_k8", "phi3_bf16_k8",
                       "qwen2_bf16_k8", "phi3_ckpt_bf16_k8")
           else []))
    launcher.parse_io(args.io)
    # what earlier phases left for the collector (a decode program's
    # graphs) is freed first, so the footprint below is this server's
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    mesh = None
    if path == "sp":
        mesh = make_mesh(sp=SERVE_SP, devices=["cuda:0"] * SERVE_SP)
        log(f"serve sp: {SERVE_SP} shards over "
            f"{len(mesh.distinct_devices)} distinct card(s)")
    core = launcher.build_core(args, mesh=mesh)
    if cfg.attention_bias:
        # the random weights' biases drawn live, before any graph capture
        live_qkv_biases(core.params, seed)
    log(f"serve {path}: engine core built in {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # which prefill each admission took: (true_len, start_pos) per call
    prefills = {"sp": [], "plain": []}
    orig_sp, orig_plain = llama.prefill_forward_sp, llama.prefill_forward

    def sp_prefill(*a, **kw):
        prefills["sp"].append((a[4], 0))
        return orig_sp(*a, **kw)

    def plain_prefill(*a, **kw):
        prefills["plain"].append((a[5], a[4]))
        return orig_plain(*a, **kw)
    _, stop_server = start_server(args, core)
    port = args.http_port
    name = launcher.model_name(args)
    # bring-up: a short greedy and a short sampled request, so that the
    # decode program's graphs (greedy and filtered sampling) are captured
    # before the measured requests; the capture time is reported
    warm = np.random.default_rng(seed + 2).integers(
        lo, cfg.vocab_size, size=16).tolist()
    t0 = time.monotonic()
    for extra in ({"temperature": 0}, {"temperature": 0.7, "top_p": 0.9,
                                       "seed": 2}):
        http_completion(port, {"model": name, "prompt": warm,
                               "max_tokens": 4,
                               "nvext": {"ignore_eos": True}, **extra})
    # the split path's graphs are the decode program's, a ragged path's
    # the ragged program's (a pure-decode and a mixed bucket, greedy and
    # filtered sampling)
    graphs = core.ragged_program if ragged else core.program
    bring_up = {"warm_requests_s": time.monotonic() - t0,
                "graph_captures": graphs.captures,
                "graph_capture_s": graphs.capture_s,
                "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    rng = np.random.default_rng(seed)
    mk = lambda n: rng.integers(lo, cfg.vocab_size, size=n).tolist()  # noqa: E731
    max_tokens = 32
    greedy = {"model": name, "max_tokens": max_tokens, "temperature": 0,
              "nvext": {"ignore_eos": True}}
    sampled = {"model": name, "prompt": "the time of the people who work to "
               "make a good day", "max_tokens": max_tokens,
               "temperature": 0.7, "top_p": 0.9, "seed": 1,
               "nvext": {"ignore_eos": True}}
    if gemma:
        # past the 4096-token window, and a short one beside it
        prompts = {"p4600": mk(GEMMA_PROMPT), "p300": mk(300)}
    elif mla:
        prompts = {"p3000": mk(MLA_PROMPT), "p300": mk(300)}
    elif phi3:
        # past the 2047-token window, and a short one beside it
        prompts = {"p3000": mk(PHI3_PROMPT), "p300": mk(300)}
    elif qwen2:
        prompts = {"p6000": mk(QWEN2_PROMPT), "p300": mk(300)}
    elif mode == "bf16":
        prompts = {"p100": mk(100), "p700": mk(700), "p1500": mk(1500),
                   "p1900": mk(1900)}
    else:
        prompts = {"p700": mk(700), "p1900": mk(1900)}
    if path in SPEC_PATHS:
        # 5b's prompts, and one that repeats a 12-token pattern (from a
        # generator of its own, so that the later prompts stay 5b's):
        # random weights repeat tokens too, which the prompt-lookup
        # drafter finds
        prompts["rep300"] = np.random.default_rng(seed + 4).integers(
            lo, cfg.vocab_size, size=12).tolist() * 25
    five_f = path in ("dispatch", "ragged_pipeline")
    if five_f:
        # 5b's prompts and a 1500-token one (2, 4 and 3 chunks of 512),
        # and a 64-token stream posted once a slot decodes: it rides the
        # batch as a lane
        extra = np.random.default_rng(seed + 1)
        prompts["p1500"] = extra.integers(259, cfg.vocab_size,
                                          size=1500).tolist()
        lane_prompt = extra.integers(259, cfg.vocab_size, size=64).tolist()
        # a lane needs a slot whose admission is complete (its first token
        # fetched, as in the JAX engine; on the ragged path, its prompt
        # consumed): the engine's completion (the ragged harvest) sets
        # this, and the three long prompts decode 64 tokens, so that the
        # lane request lands while they still decode
        decoding = threading.Event()
        hook = "_harvest_ragged" if ragged else "_complete_admissions"
        complete = getattr(core, hook)

        def completed(*a):
            complete(*a)
            if any(x is not None and x.ready and x.lane_prompt is None
                   for x in core.slots):
                decoding.set()
        setattr(core, hook, completed)
    report = {"bring_up": bring_up}
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(swapped((llama, "prefill_forward_sp", sp_prefill),
                                    (llama, "prefill_forward",
                                     plain_prefill)))
        kernels.reset_launch_counts()
        pool = core.kv_manager.pool
        # concurrent greedy streams of mixed prompt lengths
        with ThreadPoolExecutor(len(prompts) + 1) as ex:
            n_tokens = {k: 2 * max_tokens if five_f else max_tokens
                        for k in prompts}
            futs = {k: ex.submit(http_completion, port, {
                **greedy, "prompt": p, "stream": True,
                "max_tokens": n_tokens[k],
                "stream_options": {"include_usage": True}})
                for k, p in prompts.items()}
            if five_f:
                def lane_request():
                    # posted once a slot decodes (no polling: a thread
                    # that spins on the slot list takes the GIL from the
                    # engine's loop)
                    if not decoding.wait(300):
                        raise RuntimeError("lane64: no slot decoded")
                    return http_completion(port, {
                        **greedy, "prompt": lane_prompt, "stream": True,
                        "stream_options": {"include_usage": True}})
                futs["lane64"] = ex.submit(lane_request)
            for k, f in futs.items():
                report[k] = check_stream(k, f.result(),
                                         n_tokens.get(k, max_tokens), True)
        # one more SSE stream, usage not requested
        report["sse"] = check_stream("sse", http_completion(port, {
            **greedy, "prompt": mk(200), "stream": True}), max_tokens, False)
        if mode == "bf16" and not (gemma or mla or phi3 or qwen2):
            # a repeated prompt: its full blocks hit the prefix cache, so
            # the prefill runs only the tail, at start_pos > 0
            hits0 = pool.match_hits
            report["prefix_repeat"] = check_unary(
                "prefix_repeat", http_completion(
                    port, {**greedy, "prompt": prompts["p700"]}), max_tokens)
            hit_blocks = pool.match_hits - hits0
            if hit_blocks < 700 // KV_BLOCK:
                raise RuntimeError(f"prefix_repeat: {hit_blocks} prefix "
                                   f"blocks hit, expected {700 // KV_BLOCK}")
            report["prefix_repeat"]["hit_blocks"] = hit_blocks
        # a seeded sampled text prompt
        report["sampled_text"] = check_unary(
            "sampled_text", http_completion(port, sampled), max_tokens)
        if phi3:
            # a greedy request alone, with its token logprobs: a
            # checkpoint server (phase 6) must repeat it
            lone = np.random.default_rng(seed + 3).integers(
                lo, cfg.vocab_size, size=200).tolist()
            report["lone_greedy"] = check_unary(
                "lone_greedy", http_completion(port, {
                    **greedy, "prompt": lone, "logprobs": 1}), max_tokens)
        if path != "bf16":
            # sampling is keyed by (seed, request seed, step) alone: the
            # same seeded request gives the same text again
            again = check_unary("sampled_again", http_completion(
                port, sampled), max_tokens)
            if again["text"] != report["sampled_text"]["text"]:
                raise RuntimeError(f"sampled_text: a seeded request gave "
                                   f"{again['text']!r} after "
                                   f"{report['sampled_text']['text']!r}")
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        if ragged:
            m = core.metrics()
            prog = core.ragged_program
            report["ragged_metrics"] = {
                "dispatches": core.ragged_dispatches,
                "graph_replays": prog.replays,
                "graph_captures": prog.captures,
                "graph_capture_s": prog.capture_s,
                "chained_dispatches": core.ragged_chained_dispatches,
                "host_roundtrips": core.host_roundtrips,
                "host_stall_s": core.host_stall_s,
                "decode_tokens": core.total_decode_tokens,
                "mixed_dispatches": core.ragged_mixed_dispatches,
                "prefill_rows": core.ragged_prefill_rows_total,
                "decode_rows": core.ragged_decode_rows_total,
                "capacity": core.cfg.ragged_max_tokens,
                "ragged_fill_ratio": m.ragged_fill_ratio,
                "ragged_mixed_ratio": m.ragged_mixed_ratio,
                "ragged_dispatches_saved_total":
                    m.ragged_dispatches_saved_total}
        if path == "sp":
            report["prefills"] = {k: sorted(v) for k, v in prefills.items()}
        if path in SPEC_PATHS:
            report["spec_metrics"] = spec_server_metrics(core, port, ragged)
        if path == "dispatch":
            report["dispatch_metrics"] = {
                "lane_admissions": core.lane_admissions,
                "host_roundtrips": core.host_roundtrips,
                "host_stall_s": core.host_stall_s,
                "decode_tokens": core.total_decode_tokens,
                "prefill_tokens": core.total_prefill_tokens,
                "graph_captures": core.program.captures,
                "graph_capture_s": core.program.capture_s,
                "graph_replays": core.program.replays,
                "prefill_calls": list(prefills["plain"])}
    finally:
        stack.close()
        stop_server()
    for k, v in report.items():
        shown = {a: b for a, b in v.items() if not a.startswith("_")}
        log(f"request {path} {k} {json.dumps(shown)} [{card}]")
    log(f"serve {path}: launches {json.dumps(launches)}")
    for k in PATH_KERNELS[path]:
        if launches[k] <= 0:
            raise RuntimeError(f"serve {path}: kernel {k} was never "
                               f"launched")
    if ragged:
        split = {k: launches[k] for k in SPLIT_ATTENTION if launches[k]}
        if split:
            raise RuntimeError(f"serve {path}: split-path attention "
                               f"launched on the ragged path: {split}")
        rm = report["ragged_metrics"]
        if rm["mixed_dispatches"] <= 0:
            raise RuntimeError(f"serve {path}: no dispatch mixed prefill "
                               f"and decode rows")
        # every ragged dispatch on the card is a graph replay
        if rm["dispatches"] - rm["graph_replays"] != 0:
            raise RuntimeError(f"serve {path}: {rm['dispatches']} ragged "
                               f"dispatches, {rm['graph_replays']} replays")
        log(f"serve {path}: ragged dispatches {rm['dispatches']}, graph "
            f"replays {rm['graph_replays']}, eager 0, captures "
            f"{rm['graph_captures']} in {rm['graph_capture_s']:.2f} s")
    if path == "sp":
        check_sp_dispatch(cfg, prefills, launches)
    if path == "dispatch":
        check_dispatch_modes(cfg, report["dispatch_metrics"], launches)
    if path == "ragged_pipeline":
        check_ragged_pipeline(report["ragged_metrics"])
    if path in SPEC_PATHS:
        check_spec_server(path, report["spec_metrics"])
    del core
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def spec_server_metrics(core, port: int, ragged: bool) -> dict:
    """8e: a spec server's speculation counters, its verify program's
    graph replays (split path), and what ``GET /debug`` shows: the
    records by kind and the verifying ones (``verify`` rows, or ``ragged``
    rows with n_spec > 0)."""
    raw = http_request(port, "/debug?last=512")["response"]
    # this server's engine among the process's recorders (phase 8's
    # in-process engines may not be collected yet)
    last = json.loads(json.dumps(core.flight.dump(last=1)))
    mine = [fr for fr in json.loads(raw)["flight_recorders"].values()
            if fr["stats"]["records_total"] == core.flight.records_total
            and fr["records"][-1:] == last]
    if len(mine) != 1:
        raise RuntimeError(f"/debug: {len(mine)} recorders match the "
                           f"server's engine")
    recs = mine[0]["records"]
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    verifying = [r for r in recs if r["kind"] == "verify"
                 or (r["kind"] == "ragged" and r.get("n_spec", 0) > 0)]
    m = core.metrics()
    return {"spec_dispatches": core.spec_dispatches,
            "drafted": core.spec_drafted_tokens,
            "accepted": core.spec_accepted_tokens,
            "emitted": core.spec_emitted_tokens,
            "acceptance_rate": m.spec_acceptance_rate,
            "accepted_per_step": m.spec_accepted_per_step,
            "verify_replays": (None if ragged
                               else core.verify_program.replays),
            "verify_captures": (None if ragged
                                else core.verify_program.captures),
            "debug_kinds": kinds, "debug_verifying_rows": len(verifying),
            "debug_example": verifying[-1] if verifying else None}


def check_spec_server(path: str, m: dict) -> None:
    """8e: some dispatch verified drafts, each verify dispatch of the
    split path was a graph replay, and ``/debug`` lists verifying rows."""
    if m["spec_dispatches"] <= 0 or m["drafted"] <= 0:
        raise RuntimeError(f"serve {path}: no dispatch verified a draft")
    if (m["verify_replays"] is not None
            and m["verify_replays"] != m["spec_dispatches"]):
        raise RuntimeError(f"serve {path}: {m['spec_dispatches']} verify "
                           f"dispatches, {m['verify_replays']} replays")
    if m["debug_verifying_rows"] <= 0:
        raise RuntimeError(f"serve {path}: /debug shows no verifying row "
                           f"({m['debug_kinds']})")


def check_sp_dispatch(cfg, prefills: dict, launches: dict) -> None:
    """5e: the prompts of at least sp_min_prefill_tokens (512) with no
    prefix hit took the ring (p700, p1500, p1900); p100, the 200-token SSE
    prompt, the sampled text and the prefix-cached repeat took the
    whole-prompt prefill; K2 launched 32 x sp^2 per ring prefill and K1 32
    per other prefill."""
    sp_lens = sorted(n for n, _ in prefills["sp"])
    plain = prefills["plain"]
    if sp_lens != [700, 1500, 1900]:
        raise RuntimeError(f"serve sp: the ring prefilled {sp_lens}, "
                           f"expected [700, 1500, 1900]")
    if (100 not in [n for n, _ in plain]
            or not any(start > 0 for _, start in plain)):
        raise RuntimeError(f"serve sp: p100 or the prefix-cached repeat did "
                           f"not take the whole-prompt prefill: {plain}")
    want = {"flash_prefill_partial": cfg.num_layers * SERVE_SP ** 2
            * len(sp_lens), "flash_prefill": cfg.num_layers * len(plain)}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"serve sp: launches {launches}, expected {want}")


def check_dispatch_modes(cfg, m: dict, launches: dict) -> None:
    """5f: some admission rode the decode batch as a lane; the 700-, 1500-
    and 1900-token prompts prefilled in 2, 3 and 4 chunks of 512 (every
    other admission in one call) and K1 launched 32 times a call; the
    host fetched fewer times than a quarter of the decode tokens."""
    if m["lane_admissions"] <= 0:
        raise RuntimeError("serve dispatch: no lane admission")
    groups = []                   # one admission's prefill calls
    for true_len, start in m["prefill_calls"]:
        if start == 0 or not groups:
            groups.append([])
        groups[-1].append(true_len)
    chunks = {sum(g): len(g) for g in groups if sum(g) > DISPATCH_CHUNK}
    if chunks != {700: 2, 1500: 3, 1900: 4}:
        raise RuntimeError(f"serve dispatch: chunked prefills {chunks}, "
                           f"expected {{700: 2, 1500: 3, 1900: 4}}")
    want = cfg.num_layers * len(m["prefill_calls"])
    if launches["flash_prefill"] != want:
        raise RuntimeError(f"serve dispatch: {launches['flash_prefill']} "
                           f"K1 launches for {len(m['prefill_calls'])} "
                           f"prefill calls, expected {want}")
    if not m["host_roundtrips"] < m["decode_tokens"] / 4:
        raise RuntimeError(f"serve dispatch: {m['host_roundtrips']} host "
                           f"fetches for {m['decode_tokens']} decode tokens")


def check_ragged_pipeline(m: dict) -> None:
    """5r: some pure-decode ragged dispatch chained off the one before it,
    and the host fetched fewer times than there were decode tokens."""
    if m["chained_dispatches"] <= 0:
        raise RuntimeError("serve ragged_pipeline: no dispatch chained")
    if not m["host_roundtrips"] < m["decode_tokens"]:
        raise RuntimeError(f"serve ragged_pipeline: {m['host_roundtrips']} "
                           f"host fetches for {m['decode_tokens']} decode "
                           f"tokens")


def compare_servers(card: str, base: dict, other: dict, path: str,
                    base_path: str = "bf16") -> None:
    """Print each streamed request's TTFT and ITL on ``path`` beside the
    ``base_path`` server's for the same prompts, and the share of token
    texts the two greedy streams agree on (a number, not a gate: random
    weights give near-uniform logits, where a last-bit difference can
    decide a token)."""
    for k, v in other.items():
        if "_texts" not in v or "_texts" not in base.get(k, {}):
            continue
        a, b = base[k]["_texts"], v["_texts"]
        agree = sum(x == y for x, y in zip(a, b)) / max(len(a), 1)
        row = {"ttft_ms": [base[k]["ttft_ms"], v["ttft_ms"]],
               "itl_ms_mean": [base[k]["itl_ms_mean"], v["itl_ms_mean"]],
               "greedy_token_agreement": agree}
        log(f"request {base_path}-vs-{path} {k} {json.dumps(row)} "
            f"[{card}]")


# phase 6: the Phi-3-mini checkpoint, written as files of at most
# CKPT_FILE_BYTES of tensors (several, so the multi-file path runs)
CKPT_FILE_BYTES = 2 << 30


def tree_bytes(params) -> int:
    """Device bytes of a parameter tree (a quantized leaf's payload and
    scales)."""
    n = 0
    for t in params.values():
        for x in ((t.q, t.scale) if hasattr(t, "q") else (t,)):
            n += x.numel() * x.element_size()
    return n


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape hold the same bits."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(as_int[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


def check_checkpoint_load(model_dir: str, ref: dict, dev, card: str,
                          quantization: str) -> dict:
    """Load ``model_dir`` with ``load_params_auto`` under ``quantization``
    and hold every tensor (a quantized leaf's ``q`` and ``scale``) bit for
    bit against ``ref``; time the load, read the loader's host staging
    peak and the device peak above what was allocated before, and hold
    the device peak to the final tree plus two of the largest checkpoint
    tensor."""
    import torch
    from dynamo_tpu_torch.engine.weights import (load_accounting,
                                                 load_params_auto)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    with load_accounting() as acct:
        got, _ = load_params_auto(model_dir, device=dev,
                                  dtype=torch.bfloat16,
                                  quantization=quantization)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    if set(got) != set(ref):
        raise RuntimeError(f"checkpoint {quantization}: keys "
                           f"{sorted(set(got) ^ set(ref))} differ")
    for k, want in ref.items():
        pairs = ([(got[k].q, want.q), (got[k].scale, want.scale)]
                 if hasattr(want, "q") else [(got[k], want)])
        if hasattr(want, "q") and (got[k].group, got[k].packed4) != (
                want.group, want.packed4):
            raise RuntimeError(f"checkpoint {quantization}: {k} encoding")
        for a, b in pairs:
            if not same_bits(a, b):
                raise RuntimeError(f"checkpoint {quantization}: {k} is not "
                                   f"bit-equal to the seeded weights")
    final = tree_bytes(got)
    limit = final + 2 * acct.largest_tensor
    row = {"quantization": quantization, "load_s": load_s,
           "read_gb_per_s": acct.total / load_s / 1e9,
           "bytes_read": acct.total,
           "staging_peak_bytes": acct.peak,
           "largest_tensor_bytes": acct.largest_tensor,
           "device_peak_bytes": peak, "final_tree_bytes": final,
           "device_peak_limit_bytes": limit,
           "page_cache": "warm (read right after the write)"}
    log(f"checkpoint load {json.dumps(row)} [{card}]")
    if peak > limit:
        raise RuntimeError(f"checkpoint {quantization}: device peak {peak} "
                           f"bytes over the final tree {final} + 2 x the "
                           f"largest tensor {acct.largest_tensor}")
    if acct.peak > 2 * acct.largest_tensor:
        raise RuntimeError(f"checkpoint {quantization}: host staging "
                           f"{acct.peak} bytes")
    del got
    return row


def checkpoint_phase(cfg, dev, seed: int, card: str, by_path: dict) -> None:
    """Phase 6: write Phi-3-mini's seeded bf16 weights (``init_params``)
    as an HF model directory under ``build/`` with the port's writer, load
    it back in bf16 and in int4 (held bit for bit against ``init_params``
    and ``init_params_quantized``), serve it without ``--random-weights``
    on the split bf16 path and on the ragged int4 + int8 KV path, and hold
    each server's lone greedy and seeded requests to its 5p twin's; the
    directory is deleted at the end."""
    import shutil
    import tempfile
    import torch
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.engine.weights import init_params, save_hf_style
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dtt-ckpt-", dir=os.path.join(ROOT, "build"))
    try:
        model_dir = os.path.join(tmp, "phi3-mini-4k-ckpt")
        with phase("6 write"):
            write_model_dir(model_dir, cfg, {**PHI3_MINI_4K_CONFIG,
                                             "num_hidden_layers":
                                                 cfg.num_layers})
            ref = init_params(cfg, seed, dev, torch.bfloat16)
            t0 = time.monotonic()
            paths = save_hf_style(ref, cfg, model_dir,
                                  max_file_bytes=CKPT_FILE_BYTES)
            write_s = time.monotonic() - t0
            n = sum(os.path.getsize(p) for p in paths)
            row = {"files": len(paths), "bytes": n, "write_s": write_s,
                   "gb_per_s": n / write_s / 1e9,
                   "disk_free_bytes": shutil.disk_usage(tmp).free}
            log(f"checkpoint write {json.dumps(row)} [{card}]")
        with phase("6 load bf16"):
            check_checkpoint_load(model_dir, ref, dev, card, "none")
        del ref
        with phase("6 load int4"):
            ref = init_params_quantized(cfg, seed, dev, torch.bfloat16,
                                        include_embed=True, bits=4)
            check_checkpoint_load(model_dir, ref, dev, card, "int4")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        for path, twin in CKPT_TWINS.items():
            with phase(f"serve {path}"):
                by_path[path] = _serve(cfg, seed, card, model_dir, path)
            got, want = by_path[path][1], by_path[twin][1]
            for k in ("lone_greedy", "sampled_text"):
                if (got[k]["_text"], got[k]["_logprobs"]) != (
                        want[k]["_text"], want[k]["_logprobs"]):
                    raise RuntimeError(
                        f"serve {path}: {k} gave {got[k]['_text']!r}, the "
                        f"random-weights server {twin} "
                        f"{want[k]['_text']!r}")
            log(f"serve {path}: lone greedy and seeded requests equal "
                f"{twin}'s [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: chat at the 8B width, through a tokenizer.json directory
# ---------------------------------------------------------------------------

CHAT_PATH = CHAT_PATHS[0]
# Llama-3's pre-tokenizer split (its tokenizer.json's Split pattern)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
LLAMA3_BOS, LLAMA3_EOS = 128000, (128001, 128009)
# the named special tokens by their offset past the 128000 of the BPE
# vocabulary (Llama-3's ids); the others of the 256 are
# reserved_special_token_{k}
LLAMA3_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
                   6: "<|start_header_id|>", 7: "<|end_header_id|>",
                   9: "<|eot_id|>"}
CHAT_MESSAGES = [{"role": "system", "content": "You are a terse assistant."},
                 {"role": "user",
                  "content": "Name the capital of France in one word."}]
# CHAT_MESSAGES through llama3.jinja, spelled out
CHAT_PROMPT = ("<|begin_of_text|><|start_header_id|>system<|end_header_id|>"
               "\n\nYou are a terse assistant.<|eot_id|>"
               "<|start_header_id|>user<|end_header_id|>\n\nName the "
               "capital of France in one word.<|eot_id|>"
               "<|start_header_id|>assistant<|end_header_id|>\n\n")
CHAT_MAX_TOKENS = 32
CHAT_LONG_TOKENS = 1900        # the long chat prompt, about
CHAT_TTFT_S = 10.0             # a limit on every chat TTFT (a hang detector)
CHAT_ENCODE_MS = 2000.0        # the long prompt's cold encode on the host


def llama3_tokenizer_json(vocab: int = 128000) -> dict:
    """A byte-level BPE ``tokenizer.json`` in Llama-3's form: its Split
    pattern before a regex-less ByteLevel, ``ignore_merges``, string-form
    merges, ``<|begin_of_text|>`` added by the post-processor, and 256
    special tokens after the ``vocab`` of the BPE model (at 128000-128255
    for Llama-3's 128000). The merges build each of ``WORDS`` (alone,
    after a space and capitalized) left to right; the vocabulary is padded
    with synthetic tokens to ``vocab``."""
    from dynamo_tpu_torch.llm.bpe_model import BYTE_CHAR
    tokens = {BYTE_CHAR[b]: b for b in range(256)}
    merges, seen = [], set()
    for w in WORDS:
        for form in (w, BYTE_CHAR[ord(" ")] + w, w.capitalize()):
            cur = form[0]
            for ch in form[1:]:
                if (cur, ch) not in seen:
                    seen.add((cur, ch))
                    merges.append(f"{cur} {ch}")
                cur += ch
                tokens.setdefault(cur, len(tokens))
    i = 0
    while len(tokens) < vocab:
        tokens.setdefault(f"ĠW{i}", len(tokens))
        i += 1
    k = 0
    added = []
    for tid in range(vocab, vocab + 256):
        content = LLAMA3_SPECIALS.get(tid - vocab)
        if content is None:
            content = f"<|reserved_special_token_{k}|>"
            k += 1
        added.append({"id": tid, "content": content, "single_word": False,
                      "lstrip": False, "rstrip": False, "normalized": False,
                      "special": True})
    bos = LLAMA3_SPECIALS[0]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {**byte_level, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {**byte_level, "trim_offsets": False},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [vocab],
                                      "tokens": [bos]}}}]},
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": tokens, "merges": merges}}


def write_chat_model_dir(path: str, cfg) -> None:
    """An 8B model directory whose only tokenizer is ``tokenizer.json``
    (``llama3_tokenizer_json``): config.json with bos 128000,
    generation_config.json with eos [128001, 128009], and
    tokenizer_config.json holding tests/data/chat_templates/llama3.jinja."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(ROOT, "tests", "data", "chat_templates",
                           "llama3.jinja")) as f:
        template = f.read().rstrip("\n")
    files = {
        "config.json": {
            "model_type": "llama", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": False, "bos_token_id": LLAMA3_BOS,
            "eos_token_id": LLAMA3_EOS[0]},
        "generation_config.json": {"bos_token_id": LLAMA3_BOS,
                                   "eos_token_id": list(LLAMA3_EOS)},
        "tokenizer_config.json": {
            "chat_template": template,
            "bos_token": LLAMA3_SPECIALS[0],
            "eos_token": LLAMA3_SPECIALS[9]},
        "tokenizer.json": llama3_tokenizer_json(cfg.vocab_size - 256),
    }
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)


def chat_stream_stats(name: str, res: dict, ids: list) -> dict:
    """A streamed chat answer: its text, annotations, TTFT and ITL; fails
    unless it ended in [DONE] with finish reason "length" after
    ``CHAT_MAX_TOKENS`` tokens (``ids``, the engine's)."""
    if not res["done"]:
        raise RuntimeError(f"{name}: SSE stream did not end in [DONE]")
    chunks = [json.loads(e.data) for e in res["events"] if e.data]
    notes = {e.event: json.loads(e.comments[0]) for e in res["events"]
             if e.data is None and e.event and e.comments}
    finish = [c["choices"][0]["finish_reason"] for c in chunks
              if c.get("choices") and c["choices"][0].get("finish_reason")]
    if finish != ["length"] or len(ids) != CHAT_MAX_TOKENS:
        raise RuntimeError(f"{name}: finish {finish}, {len(ids)} tokens")
    t = [tm for e, tm in zip(res["events"], res["times"]) if e.data
         and (json.loads(e.data).get("choices") or [{}])[0]
         .get("delta", {}).get("content")]
    itl = [b - a for a, b in zip(t, t[1:])]
    if not t or t[0] > CHAT_TTFT_S:
        raise RuntimeError(f"{name}: TTFT {t[:1]} s")
    return {"ttft_ms": 1e3 * t[0],
            "itl_ms_mean": 1e3 * sum(itl) / len(itl) if itl else None,
            "itl_ms_max": 1e3 * max(itl) if itl else None,
            "text": "".join(c["choices"][0]["delta"].get("content") or ""
                            for c in chunks if c.get("choices")),
            "notes": notes}


def metric_samples(text: str) -> dict:
    """The Prometheus text exposition as {(name, labels): value}."""
    import re
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r'([^{ ]+)(?:\{(.*)\})? (\S+)$', line)
        labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def chat_phase(cfg, seed: int, card: str, base: dict) -> tuple:
    """Phase 7: the 8B model (``cfg``'s depth, random weights, phase 5b's
    int4 + int8 KV flags) served from ``write_chat_model_dir``'s directory,
    whose only tokenizer is ``tokenizer.json``, driven through chat:

    1. a streamed greedy chat with the token_ids and formatted_prompt
       annotations: the prompt is ``CHAT_PROMPT``, its ids begin 128000,
       128006, and the port's tokenizer decodes them back to it;
    2. the same request unary, and as a completion of those ids: the three
       give the same completion ids (read at the engine);
    3. a seeded chat with n = 2, whose choices are two n = 1 requests with
       seeds s and s + 1 and whose usage counts the prompt once;
    4. a chat prompt of about 1900 tokens: render and encode ms on the host
       (cold and warm), and its TTFT;
    5. the launcher's ``run_batch`` over 3 JSONL lines on the live
       pipeline: each response is the unary greedy answer to its messages;
    6. ``/metrics``: requests by endpoint as sent, the TTFT histogram's
       count as the streamed requests; ``/live`` answers 200.

    Returns (launch counts over the phase, report); ``base`` is phase 5b's
    report, whose p700 TTFT / ITL are printed beside the chat's."""
    import asyncio
    import tempfile
    import torch
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.launch import run as launcher
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import (OpenAIPreprocessor,
                                                   PromptFormatter)
    from dynamo_tpu_torch.runtime import ResponseStream, link

    class Recorder:
        """The engine's token ids per request id (the HTTP X-Request-Id;
        a fan-out's children are ``{id}-c{i}``)."""

        def __init__(self, engine):
            self.engine = engine
            self.ids: dict = {}

        async def generate(self, request):
            stream = await self.engine.generate(request)
            got = self.ids.setdefault(request.ctx.id, [])

            async def tap():
                async for item in stream:
                    data = getattr(item, "data", None)
                    if data is not None:
                        got.extend(data.token_ids)
                    yield item
            return ResponseStream(tap(), stream.ctx)

    mode, _ = SERVE_PATHS[CHAT_PATH]
    weights, kv_quant = SERVE_MODES[mode]
    report: dict = {}
    with tempfile.TemporaryDirectory(prefix="dtt-chat-") as tmp:
        model_dir = os.path.join(tmp, "llama3-8b-chat-random")
        t0 = time.monotonic()
        write_chat_model_dir(model_dir, cfg)
        args = launcher.build_parser().parse_args(
            ["in=http", "out=torch", "--model-path", model_dir,
             "--random-weights", "--http-host", "127.0.0.1",
             "--http-port", "0", "--max-model-len", str(MAX_MODEL_LEN),
             "--kv-block-size", str(KV_BLOCK), "--num-kv-blocks", "2048",
             "--max-num-seqs", "8", "--device", "cuda",
             "--quantization", weights, "--kv-quantization", kv_quant])
        gc.collect()
        torch.cuda.empty_cache()
        core = launcher.build_core(args)
        t1 = time.monotonic()
        mdc = ModelDeploymentCard.from_local_path(
            model_dir, display_name=launcher.model_name(args))
        # the first tokenizer.json of the process: its \p classes built
        report["card_load_s"] = time.monotonic() - t1
        recorder = Recorder(TorchEngine(core))
        pipeline = link(OpenAIPreprocessor(mdc), Backend(mdc), recorder)
        report["bring_up_s"] = time.monotonic() - t0
        loop, stop_server = start_server(args, core, pipeline)
        port, name = args.http_port, launcher.model_name(args)
        sent = {"chat_completions": 0, "completions": 0}
        streamed = 0

        def post(endpoint: str, body: dict) -> dict:
            nonlocal streamed
            sent[endpoint] += 1
            streamed += bool(body.get("stream"))
            path = ("/v1/chat/completions" if endpoint == "chat_completions"
                    else "/v1/completions")
            return http_request(port, path, {"model": name, **body})
        try:
            # bring-up: a greedy and a sampled chat capture the decode
            # program's graphs before the measured requests
            for extra in ({"temperature": 0},
                          {"temperature": 0.7, "top_p": 0.9, "seed": 2}):
                post("chat_completions", {
                    "messages": CHAT_MESSAGES, "max_tokens": 4,
                    "nvext": {"ignore_eos": True}, **extra})
            kernels.reset_launch_counts()
            greedy = {"messages": CHAT_MESSAGES, "temperature": 0,
                      "max_tokens": CHAT_MAX_TOKENS,
                      "nvext": {"ignore_eos": True}}
            # 1. streamed, annotated
            res = post("chat_completions", {
                **greedy, "stream": True,
                "nvext": {"ignore_eos": True, "annotations": [
                    "token_ids", "formatted_prompt"]}})
            stream_ids = recorder.ids[res["request_id"]]
            st = chat_stream_stats("chat stream", res, stream_ids)
            prompt_ids = st["notes"].get("token_ids") or []
            if st["notes"].get("formatted_prompt") != CHAT_PROMPT:
                raise RuntimeError(f"chat: formatted prompt "
                                   f"{st['notes'].get('formatted_prompt')!r}")
            if prompt_ids[:2] != [LLAMA3_BOS, 128006]:
                raise RuntimeError(f"chat: prompt ids begin {prompt_ids[:4]}")
            back = mdc.tokenizer().decode(prompt_ids,
                                          skip_special_tokens=False)
            if back != CHAT_PROMPT:
                raise RuntimeError(f"chat: the prompt ids decode to {back!r}")
            report["stream"] = {k: v for k, v in st.items()
                                if k not in ("notes", "text")}
            report["stream"]["prompt_tokens"] = len(prompt_ids)
            # 2. unary, and a completion of the prompt's ids
            res = post("chat_completions", greedy)
            unary_ids = recorder.ids[res["request_id"]]
            msg = res["response"]["choices"][0]["message"]["content"]
            res = post("completions", {
                "prompt": prompt_ids, "temperature": 0,
                "max_tokens": CHAT_MAX_TOKENS,
                "nvext": {"ignore_eos": True}})
            cmpl_ids = recorder.ids[res["request_id"]]
            if not (stream_ids == unary_ids == cmpl_ids) or not (
                    st["text"] == msg
                    == res["response"]["choices"][0]["text"]):
                raise RuntimeError(f"chat: stream / unary / completion ids "
                                   f"{stream_ids[:6]} / {unary_ids[:6]} / "
                                   f"{cmpl_ids[:6]}")
            b = base["p700"]
            log(f"request {CHAT_PATH}-vs-int4_kv8 "
                f"{json.dumps({'ttft_ms': [b['ttft_ms'], st['ttft_ms']], 'itl_ms_mean': [b['itl_ms_mean'], st['itl_ms_mean']], 'prompt_tokens': [700, len(prompt_ids)]})} "
                f"[{card}]")
            # 3. n = 2, seeded
            s = 11
            sampled = {"messages": CHAT_MESSAGES, "temperature": 0.7,
                       "top_p": 0.9, "max_tokens": CHAT_MAX_TOKENS,
                       "nvext": {"ignore_eos": True}}
            res = post("chat_completions", {**sampled, "seed": s, "n": 2})
            two = res["response"]
            pair = [recorder.ids[f"{res['request_id']}-c{i}"]
                    for i in range(2)]
            ones = []
            for i in range(2):
                r = post("chat_completions", {**sampled, "seed": s + i})
                ones.append(recorder.ids[r["request_id"]])
            texts = [c["message"]["content"] for c in two["choices"]]
            usage = two["usage"]
            if pair != ones or len(texts) != 2 or usage != {
                    "prompt_tokens": len(prompt_ids),
                    "completion_tokens": 2 * CHAT_MAX_TOKENS,
                    "total_tokens": len(prompt_ids) + 2 * CHAT_MAX_TOKENS}:
                raise RuntimeError(f"chat n=2: choices {[p[:4] for p in pair]}"
                                   f" against n=1 {[o[:4] for o in ones]}, "
                                   f"usage {usage}")
            report["n2"] = {"usage": usage, "distinct": pair[0] != pair[1]}
            # 4. a long chat prompt: host render / encode, then TTFT
            words = (WORDS * (CHAT_LONG_TOKENS // len(WORDS) + 1))
            long_messages = [CHAT_MESSAGES[0], {
                "role": "user", "content": " ".join(
                    words[:CHAT_LONG_TOKENS - 40])}]
            t1 = time.monotonic()
            fresh = ModelDeploymentCard.from_local_path(model_dir)
            tk = fresh.tokenizer()
            load_s = time.monotonic() - t1
            fmt = PromptFormatter(fresh.prompt_format.chat_template,
                                  bos_token=tk.id_to_token(LLAMA3_BOS),
                                  eos_token=tk.id_to_token(LLAMA3_EOS[0]))
            host = {"card_reload_s": load_s}
            for when in ("cold", "warm"):
                t1 = time.perf_counter()
                text = fmt.render(long_messages)
                t2 = time.perf_counter()
                n_long = len(tk.encode(text).ids)
                t3 = time.perf_counter()
                host[f"render_ms_{when}"] = 1e3 * (t2 - t1)
                host[f"encode_ms_{when}"] = 1e3 * (t3 - t2)
            if host["encode_ms_cold"] > CHAT_ENCODE_MS:
                raise RuntimeError(f"chat: {n_long}-token encode took "
                                   f"{host['encode_ms_cold']:.1f} ms")
            res = post("chat_completions", {
                "messages": long_messages, "temperature": 0, "stream": True,
                "max_tokens": CHAT_MAX_TOKENS,
                "nvext": {"ignore_eos": True}})
            lt = chat_stream_stats("chat long", res,
                                   recorder.ids[res["request_id"]])
            report["long"] = {"prompt_tokens": n_long, **host,
                              **{k: lt[k] for k in ("ttft_ms",
                                                    "itl_ms_mean")}}
            # 5. run_batch on the live pipeline (on the server's loop)
            lines = [{"messages": [{"role": "user", "content": q}],
                      "max_tokens": 16, "temperature": 0}
                     for q in ("What is the time?", "Say one word.",
                               "Count to three.")]
            src = os.path.join(tmp, "batch.jsonl")
            dst = os.path.join(tmp, "batch.out.jsonl")
            with open(src, "w") as f:
                f.write("".join(json.dumps(d) + "\n" for d in lines))
            args.output_path = dst
            asyncio.run_coroutine_threadsafe(
                launcher.run_batch(args, pipeline, src), loop).result(600)
            with open(dst) as f:
                got = [json.loads(x) for x in f if x.strip()]
            for d, g in zip(lines, got):
                want = post("chat_completions", d)["response"]
                want = want["choices"][0]["message"]["content"]
                if g.get("response") != want:
                    raise RuntimeError(f"chat batch: {g} against the unary "
                                       f"answer {want!r}")
            if len(got) != len(lines):
                raise RuntimeError(f"chat batch: {len(got)} lines out")
            report["batch"] = {"lines": len(got)}
            launches = {k: v.launches for k, v in kernels.KERNELS.items()}
            # 6. /metrics and /live
            samples = metric_samples(http_request(port, "/metrics")
                                     ["response"])
            by_endpoint = {}
            ttft_count = 0.0
            for (metric, labels), v in samples.items():
                lab = dict(labels)
                if metric == "nv_llm_http_service_requests_total":
                    if lab["status"] != "success":
                        raise RuntimeError(f"chat metrics: {lab} {v}")
                    by_endpoint[lab["endpoint"]] = (
                        by_endpoint.get(lab["endpoint"], 0) + v)
                if metric == ("nv_llm_http_service_time_to_first_token_"
                              "seconds_count"):
                    ttft_count += v
            if by_endpoint != {k: float(v) for k, v in sent.items() if v} \
                    or ttft_count != streamed:
                raise RuntimeError(f"chat metrics: requests {by_endpoint} "
                                   f"for {sent}, TTFT count {ttft_count} "
                                   f"for {streamed} streams")
            if http_request(port, "/live")["status"] != 200:
                raise RuntimeError("chat: /live did not answer 200")
            report["metrics"] = {"requests": by_endpoint,
                                 "ttft_count": ttft_count}
        finally:
            stop_server()
    for k, v in report.items():
        log(f"request {CHAT_PATH} {k} {json.dumps(v)} [{card}]")
    log(f"serve {CHAT_PATH}: launches {json.dumps(launches)}")
    for k in PATH_KERNELS[CHAT_PATH]:
        if launches[k] <= 0:
            raise RuntimeError(f"serve {CHAT_PATH}: kernel {k} was never "
                               f"launched")
    del core, pipeline, recorder
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------------------
# phase 8: speculative decoding at the 8B width and depth
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_B = 8
SPEC_ROWS = SPEC_B * (SPEC_K + 1)       # the verify program's rows: 40
# the KV each slot holds before a verify dispatch: phase 3's K3 mix with its
# empty slot given 300 keys; slot 0's 4 keys let a row's seq_len one short
# (the planted fault) drop one key of five
SPEC_LENS = [4, 15, 16, 17, 255, 1000, 2040, 300]
SPEC_MODES = ("int4_kv8", "bf16")
SPEC_TOKENS = 64          # tokens of each oracle-drafter request
SPEC_PROMPT = 300         # its prompt
SPEC_REQUESTS = 4         # oracle-drafter requests served together
SPEC_WRONG_AT = 2         # the wrong drafter's bad draft
# the most a verify row's logits may differ from the decode program's at
# the same position (8a fails above it; on the H100 at 700 W it read
# 0.0903 in int4 + int8 KV and 0.0804 in bf16, PERF.md), and a near tie:
# a top-2 logit gap under twice that, which such a difference may flip
SPEC_VS_DECODE_MAX = 0.1
SPEC_NEAR_TIE = 2 * SPEC_VS_DECODE_MAX
# the oracle-drafter runs a drafter takes to reach references that every
# stream repeats to its end (oracle_rounds)
SPEC_ROUNDS = 12
SPEC_MODE_TAG = "spec_verify_rows40"


def check_verify_attention(cfg, dev, int8: bool) -> dict:
    """K3 (bf16 pool, or int8 rows) at the verify program's shape: SPEC_B
    slots of SPEC_LENS keys, each slot's SPEC_K + 1 rows over its own
    table at seq_lens len + 1 .. len + SPEC_K + 1 (40 rows), against its
    plain version within the row limit, the longest slot's last table
    entry read as the trash block as the planted fault, repeated bits,
    timed cold beside the bound (each slot's keys read once), the plain
    version and SDPA over the gathered pages."""
    import torch
    from dynamo_tpu_torch.engine import attention, kernels
    Tv = SPEC_K + 1
    bs, M = KV_BLOCK, MAX_MODEL_LEN // KV_BLOCK
    lens = [n + Tv for n in SPEC_LENS]          # keys of each slot's last row
    q, k_cache, v_cache, tables, _ = pool_inputs(cfg, dev, 8, lens, int8, bs,
                                                 M, n_rows=SPEC_ROWS)
    rows_t = tables.repeat_interleave(Tv, 0)
    seq_lens = torch.tensor([n + t + 1 for n in SPEC_LENS for t in range(Tv)],
                            dtype=torch.int32, device=dev)
    kw = dict(block_size=bs, scale=attn_scale(cfg, LLAMA_ATTN))
    fn = (kernels.paged_attention_int8_cuda if int8
          else kernels.paged_attention_cuda)
    name = "paged_attention_int8" if int8 else "paged_attention"

    def kernel(tabs=rows_t):
        return fn(q, k_cache, v_cache, tabs, seq_lens, **kw)

    def plain():
        return attention.paged_attention_ref(q, k_cache, v_cache, rows_t,
                                             seq_lens, **kw)
    out, again, ref = kernel(), kernel(), plain()
    b = SPEC_LENS.index(max(SPEC_LENS))
    bad = rows_t.clone()
    bad[b * Tv:(b + 1) * Tv, (lens[b] - 1) // bs] = 0
    fault = kernel(bad)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.equal(out, again):
        raise RuntimeError(f"{name} at {SPEC_ROWS} verify rows: non-finite "
                           f"output or two calls gave different bits")
    err, rel = row_errors(out, ref, slice(None))
    _, fault_rel = row_errors(fault, ref, slice(b * Tv, (b + 1) * Tv))
    check_limit(f"{name} verify rows", rel, {"last_block_trash": fault_rel})
    lib = paged_library(cfg, LLAMA_ATTN, q, k_cache, v_cache, rows_t,
                        seq_lens, bs)
    b_ms, b_by = attn_bound(cfg, LLAMA_ATTN, int8, M, SPEC_ROWS, SPEC_ROWS,
                            sum(lens), int(seq_lens.sum()), 1)
    ms = time_ms(kernel, cold=True)
    case = {"rows": SPEC_ROWS, "slots": SPEC_B, "slot_keys": lens,
            "max_abs_err": err, "max_row_rel_err": rel,
            "fault_row_rel_err": fault_rel, "repeat_bits_equal": True,
            "ms": ms, "plain_ms": time_ms(plain, iters=5, cold=True),
            "library_ms": lib["sdpa_ms"], "library": (
                f"scaled_dot_product_attention ({lib.get('sdpa_backend')}) "
                f"over gathered pages"),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms}
    log(f"{name} verify {json.dumps(case)}")
    return {"name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dynamo_tpu/engine/attention.py:743",
            "mode": SPEC_MODE_TAG, "row_rel_tolerance": KERNEL_ROW_REL_TOL,
            **case}


def check_verify_kernels(cfg, dev) -> list:
    """Phase 8's kernels at the shapes speculation gives them (8B): K3 bf16
    and int8 at the verify program's 40 rows, K5 at 40 rows and at the
    row-sampled ragged program's capacity, K6 at N = 40 at the four 8B
    layer shapes."""
    D, Fi = cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_kv_heads * cfg.head_dim
    return [check_verify_attention(cfg, dev, False),
            check_verify_attention(cfg, dev, True),
            check_lm_head_int8(cfg, dev, rows=(SPEC_ROWS, RAGGED_CAPACITY),
                               primary=SPEC_ROWS, mode=SPEC_MODE_TAG),
            check_grouped_int4(cfg, dev, shapes=[
                ((d, f), (SPEC_ROWS,))
                for d, f in ((D, Fi), (Fi, D), (D, KVD), (D, D))],
                primary_rows=SPEC_ROWS, mode=SPEC_MODE_TAG)]


def spec_weights(cfg, dev, seed: int, mode: str):
    """The mode's random weights (SERVE_MODES) from ``seed``."""
    import torch
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.engine.weights import init_params
    weights, _ = SERVE_MODES[mode]
    if weights == "none":
        return init_params(cfg, seed, dev, torch.bfloat16)
    return init_params_quantized(cfg, seed, dev, torch.bfloat16,
                                 bits=4 if weights == "int4" else 8)


def spec_pool(params, cfg, dev, seed: int, kv_quant: str, bs: int,
              max_len: int) -> tuple:
    """A pool of SPEC_B slots, slot b holding the KV of SPEC_LENS[b] random
    prompt tokens (prefilled, each padded to a multiple of 128), its blocks
    reaching past the verify rows. Returns (kv, tables [B, M])."""
    import torch
    from dynamo_tpu_torch.engine.models import family
    model = family(cfg)
    Tv, M = SPEC_K + 1, max_len // bs
    need = [-(-(n + Tv + 1) // bs) for n in SPEC_LENS]
    kv = model.init_kv_cache(cfg, sum(need) + 1, bs, dev, torch.bfloat16,
                             quantization=kv_quant)
    tables = torch.zeros((SPEC_B, M), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    used = 1
    with torch.inference_mode():
        for b, n in enumerate(SPEC_LENS):
            tables[b, :need[b]] = torch.arange(used, used + need[b],
                                               device=dev)
            used += need[b]
            toks = torch.randint(3, cfg.vocab_size, (-(-n // 128) * 128,),
                                 generator=gen, device=dev)
            model.prefill_forward(params, kv, toks, tables[b], 0, n, cfg, bs)
    return kv, tables


def one_key_short(attn: Callable) -> Callable:
    """The decode attention with a planted fault: the first row's seq_len
    one short (it misses the key its own row wrote)."""
    def fault(q, k_cache, v_cache, block_tables, seq_lens, **kw):
        short = seq_lens.clone()
        short[0] -= 1
        return attn(q, k_cache, v_cache, block_tables, short, **kw)
    return fault


def check_verify_program(params, cfg, dev, seed: int, mode: str, label: str,
                         bs: int, max_len: int, plain_swaps) -> dict:
    """8a: the verify program (engine/programs.py VerifyProgram, SPEC_B
    slots of SPEC_K + 1 rows) over ``params`` and a spec_pool: its graph
    replay against the same program run eagerly (tokens, logprobs, logits
    and the pool, bit for bit); a stale static input caught; its row (b,
    t) logits against the decode program's K = SPEC_K + 1 dispatch fed the
    same tokens (step t at the same position) within MODEL_REL_TOL; its
    kernel path against ``plain_swaps`` (the plain versions) within the
    limit, and the first row's seq_len one short (one_key_short) beyond
    it. Returns the readings, with the largest |verify - decode| logit
    difference (which SPEC_VS_DECODE_MAX bounds at the 8B)."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine.models import family
    from dynamo_tpu_torch.engine.programs import DecodeProgram, VerifyProgram
    model = family(cfg)
    _, kv_quant = SERVE_MODES[mode]
    kv, tables = spec_pool(params, cfg, dev, seed, kv_quant, bs, max_len)
    B, Tv, M = SPEC_B, SPEC_K + 1, tables.shape[1]
    rng = np.random.default_rng(seed + 12)
    tokens = rng.integers(3, cfg.vocab_size, size=(B, Tv)).astype(np.int64)
    lens = np.array(SPEC_LENS, np.int32)
    inp = dict(tokens=tokens, positions=lens, tables=tables.cpu().numpy(),
               seeds=np.arange(B, dtype=np.int64),
               steps0=lens.astype(np.int64),
               temperature=np.zeros((B,), np.float32),
               top_k=np.zeros((B,), np.int64),
               top_p=np.ones((B,), np.float32))
    # slot 1 samples with top-p: the filtered branch runs
    inp["temperature"][1], inp["top_p"][1] = 0.7, 0.9
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])
    prog = VerifyProgram(params, kv, cfg, bs, B, M, Tv, 0, dev)
    res = {"model": label, "mode": mode, "rows": B * Tv}
    with torch.inference_mode():
        d = prog.dispatch("filtered", inp, with_logits=True)
        toks, lps = d.fetch()
        logits = d.logits.clone()
        pool = {n: t[:, bs:].clone() for n, t in kv.items()}
        restore()
        e = prog.run_eager("filtered", inp, with_logits=True)
        res["replay_equals_eager"] = {
            "tokens": bool((toks == e.toks.cpu().numpy()).all()),
            "logprobs": bool((lps == e.logprobs.cpu().numpy()).all()),
            "logits": torch.equal(logits, e.logits),
            "pool": all(torch.equal(pool[n], kv[n][:, bs:]) for n in kv)}
        del pool, e
        # the planted fault: a second dispatch whose inputs never reach the
        # graph
        other = dict(inp, tokens=(tokens + 1000) % cfg.vocab_size)
        restore()
        upload = prog._upload
        prog._upload = lambda inputs: None
        try:
            stale = prog.dispatch("filtered", other,
                                  with_logits=True).logits.clone()
        finally:
            prog._upload = upload
        restore()
        right = prog.run_eager("filtered", other, with_logits=True).logits
        res["planted_stale_inputs_caught"] = not torch.equal(stale, right)
        del stale, right
        # row (b, t) against the decode program's step t (planned tokens)
        restore()
        dec = DecodeProgram(params, kv, cfg, bs, B, M, Tv, 0, dev)
        dinp = {k: v for k, v in inp.items() if k != "tokens"}
        dinp.update(tokens=tokens[:, 0].copy(), planned=tokens.T.copy(),
                    planned_mask=np.ones((Tv, B), bool))
        dlog = dec.dispatch(Tv, "filtered", dinp,
                            with_logits=True).logits.transpose(0, 1).clone()
        _, compare = logit_compare(dlog)
        res["vs_decode"] = compare(logits)
        res["vs_decode_max_abs_err"] = res["vs_decode"]["max_abs_err"]
        del dec, dlog
        # the kernel path against the plain versions, and the planted fault
        restore()
        with swapped(*plain_swaps):
            ref = prog.run_eager("filtered", inp, with_logits=True).logits
        restore()
        with swapped((model, "paged_attention",
                      one_key_short(model.paged_attention))):
            bad = prog.run_eager("filtered", inp, with_logits=True).logits
        _, compare = logit_compare(ref)
        res["vs_plain"] = compare(logits)
        res["planted_fault"] = compare(bad)
        del ref, bad
    restore()
    res["captures"], res["capture_s"] = prog.captures, prog.capture_s
    log(f"verify_program {json.dumps(res)}")
    what = f"verify program {label} {mode}"
    bad_checks = [k for k, v in res["replay_equals_eager"].items() if not v]
    if bad_checks or not res["planted_stale_inputs_caught"]:
        raise RuntimeError(f"{what}: replay != eager {bad_checks} or the "
                           f"stale input went unseen")
    if not res["vs_decode"]["rel_err"] <= MODEL_REL_TOL:
        raise RuntimeError(f"{what}: rows differ from the decode program's "
                           f"by {res['vs_decode']['rel_err']}")
    check_model_limits(what, res["vs_plain"]["rel_err"],
                       {"seq_len_one_short":
                        res["planted_fault"]["rel_err"]})
    del kv, snap, prog
    return res


class OracleDrafter:
    """Proposes a reference stream's next tokens while the request's
    history is a prefix of one of ``streams`` (prompt + reference tokens),
    else nothing; with ``wrong_at``, that draft is another token."""

    def __init__(self, streams: list, vocab: int,
                 wrong_at: Optional[int] = None) -> None:
        self.streams, self.vocab, self.wrong_at = streams, vocab, wrong_at

    def draft(self, history, k: int) -> list:
        h = list(history)
        for s in self.streams:
            if s[:len(h)] == h:
                d = list(s[len(h):len(h) + k])
                if self.wrong_at is not None and self.wrong_at < len(d):
                    d[self.wrong_at] = (d[self.wrong_at] + 1) % self.vocab
                return d
        return []


def spec_engine(params, cfg, dev, mode: str, ragged: bool,
                pipeline: bool = False):
    """An in-process EngineCore over ``params`` with spec_k = SPEC_K, 8
    slots, no prefix reuse (every admission prefills its whole prompt)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    weights, kv_quant = SERVE_MODES[mode]
    ecfg = EngineConfig(max_model_len=MAX_MODEL_LEN, kv_block_size=KV_BLOCK,
                        num_kv_blocks=512, max_num_seqs=SPEC_B,
                        enable_prefix_reuse=False, quantization=weights,
                        kv_quantization=kv_quant, spec_k=SPEC_K,
                        ragged_dispatch=ragged,
                        ragged_max_seq_rows=RAGGED_MAX_ROWS,
                        decode_dispatch_pipeline=pipeline)
    return EngineCore(cfg, ecfg, params=params, device=dev)


def engine_streams(core, prompts: list, spec: list, max_new: list,
                   launches: Optional[dict] = None) -> list:
    """Serve ``prompts`` together on ``core`` (request i with speculation
    ``spec[i]``, -1 = the engine's, and ``max_new[i]`` tokens) to the end;
    their token lists. The kernels' launches over the run are added to
    ``launches`` where it is given."""
    import asyncio
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.sampling import SlotSampling

    async def run():
        reqs = [EngineRequest(rid=f"s{i}", prompt=list(p),
                              sampling=SlotSampling(temperature=0.0),
                              max_new_tokens=max_new[i], eos_ids=frozenset(),
                              spec_k=spec[i])
                for i, p in enumerate(prompts)]
        for r in reqs:
            await core.submit(r)
        out = []
        for r in reqs:
            toks = []
            while True:
                item, _ = await asyncio.wait_for(r.out_queue.get(), 300)
                if item is FINISH_SENTINEL:
                    break
                toks.append(item)
            out.append(toks)
        await core.stop()
        return out
    kernels.reset_launch_counts()
    out = asyncio.run(run())
    if launches is not None:
        for k, v in kernels.KERNELS.items():
            launches[k] = launches.get(k, 0) + v.launches
    return out


class GapReader:
    """The top-2 logit gap of each token of greedy continuations of
    prompts, on the split path and teacher-forced: the prefill's logits
    for a stream's first token, then the decode program (K = 8 dispatches
    fed the streams) for the rest. Up to SPEC_B streams a call, a slot
    each, over one pool and one decode program kept across calls (its
    graphs captured once)."""

    def __init__(self, params, cfg, dev, kv_quant: str,
                 max_len: int) -> None:
        import numpy as np
        import torch
        from dynamo_tpu_torch.engine.models import family
        from dynamo_tpu_torch.engine.programs import DecodeProgram
        self.params, self.cfg, self.dev = params, cfg, dev
        self.model = family(cfg)
        bs = KV_BLOCK
        per = -(-(max_len + PROGRAM_K) // bs)       # blocks a slot
        M = max(MAX_MODEL_LEN // KV_BLOCK, per)
        self.kv = self.model.init_kv_cache(cfg, SPEC_B * per + 1, bs, dev,
                                           torch.bfloat16,
                                           quantization=kv_quant)
        self.tables = np.zeros((SPEC_B, M), np.int32)
        for j in range(SPEC_B):
            self.tables[j, :per] = np.arange(1 + j * per, 1 + (j + 1) * per)
        self.prog = DecodeProgram(params, self.kv, cfg, bs, SPEC_B, M,
                                  PROGRAM_K, 0, dev)

    def __call__(self, prompts: list, streams: list) -> list:
        import numpy as np
        import torch
        n, K = len(streams), PROGRAM_K
        L = len(streams[0])
        if n > SPEC_B or any(len(s) != L for s in streams):
            raise ValueError("up to SPEC_B streams of one length")

        def gap(lg):
            top = torch.topk(lg.float(), 2).values
            return float(top[0] - top[1])
        gaps = []
        with torch.inference_mode():
            for j, p in enumerate(prompts):
                padded = torch.zeros((-(-len(p) // 128) * 128,),
                                     dtype=torch.long, device=self.dev)
                padded[:len(p)] = torch.tensor(p, device=self.dev)
                table = torch.from_numpy(self.tables[j]).to(self.dev)
                gaps.append([gap(self.model.prefill_forward(
                    self.params, self.kv, padded, table, 0, len(p),
                    self.cfg, KV_BLOCK))])
            for lo in range(0, L - 1, K):
                k = min(K, L - 1 - lo)
                planned = np.zeros((k, SPEC_B), np.int64)
                pmask = np.zeros((k, SPEC_B), bool)
                positions = np.zeros((SPEC_B,), np.int32)
                for j, s in enumerate(streams):
                    planned[:, j] = s[lo:lo + k]
                    pmask[:, j] = True
                    positions[j] = len(prompts[j]) + lo
                inp = {"tokens": planned[0].copy(), "tables": self.tables,
                       "positions": positions, "planned": planned,
                       "planned_mask": pmask}
                lg = self.prog.dispatch(k, "greedy", inp,
                                        with_logits=True).logits
                for j in range(n):
                    gaps[j] += [gap(lg[i, j]) for i in range(k)]
        return gaps


def check_oracle_streams(name: str, harvests: list, got: list, ref: list,
                         gaps: list, accept: int, emitted: int) -> dict:
    """8b / 8c for one request: its stream equals its reference ``ref``
    up to the first difference, and any difference lies at a near tie (a
    gap of ``ref``'s under SPEC_NEAR_TIE); every verifying dispatch whose
    tokens all precede it (and the budget's end) accepted ``accept``
    drafts. ``harvests``: the request's (request_harvests), after the
    ``emitted`` tokens its admission gave."""
    first = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                 None)
    if len(got) != len(ref):
        raise RuntimeError(f"{name}: {len(got)} tokens, reference "
                           f"{len(ref)}")
    if first is not None and not gaps[first] < SPEC_NEAR_TIE:
        raise RuntimeError(f"{name}: the stream leaves its reference at "
                           f"token {first}, whose gap {gaps[first]} is no "
                           f"near tie (limit {SPEC_NEAR_TIE})")
    end = first if first is not None else len(ref)
    checked = 0
    for n, acc in harvests:
        if acc is not None and emitted + SPEC_K + 1 <= end:
            checked += 1
            if acc != accept:
                raise RuntimeError(f"{name}: a dispatch accepted {acc} "
                                   f"drafts, expected {accept}")
        emitted += n
    return {"first_difference": first,
            "gap_there": gaps[first] if first is not None else None,
            "near_ties": sum(g < SPEC_NEAR_TIE for g in gaps[:end]),
            "dispatches_checked": checked}


def oracle_rounds(core, name: str, prompts: list, refs: list, gaps: list,
                  wrong: Optional[int], emitted: int, regap: Callable,
                  launches: Optional[dict]) -> tuple:
    """8b / 8c: serve ``prompts`` together on ``core`` (speculating at its
    spec_k) with an OracleDrafter over ``refs`` (wrong at draft ``wrong``
    where given), each stream held to its reference by
    check_oracle_streams; a stream that left its reference (at a near
    tie) becomes it, with its gaps from ``regap(prompts, streams)``, and
    the round runs again, until every stream equals its reference to the end:
    then every verifying dispatch of the last round but those at the
    budget's end accepted SPEC_K drafts (``wrong`` of them). Fails after
    SPEC_ROUNDS rounds. Returns (the references, their gaps, the readings,
    the last round's recorded events)."""
    from dynamo_tpu_torch.engine import replay as treplay
    refs, gaps, n = list(refs), list(gaps), len(prompts)
    accept = SPEC_K if wrong is None else wrong
    left = []                  # each round's (request, token) differences
    t0 = time.monotonic()
    for rnd in range(SPEC_ROUNDS):
        core.drafter = OracleDrafter([p + r for p, r in zip(prompts, refs)],
                                     core.model_cfg.vocab_size, wrong)
        core.recorder = treplay.Recorder()
        got = engine_streams(core, prompts, [-1] * n, [SPEC_TOKENS] * n,
                             launches)
        events = core.recorder.events
        rows = [check_oracle_streams(
            f"{name} {j} round {rnd}", request_harvests(events, f"s{j}"),
            got[j], refs[j], gaps[j], accept, emitted) for j in range(n)]
        diff = [(j, r["first_difference"], r["gap_there"])
                for j, r in enumerate(rows)
                if r["first_difference"] is not None]
        left.append(diff)
        if not diff:
            res = {"rounds": rnd + 1, "s": time.monotonic() - t0,
                   "left_reference_at": left,
                   "accepted_each": accept,
                   "dispatches_checked": [r["dispatches_checked"]
                                          for r in rows],
                   "near_ties": [r["near_ties"] for r in rows]}
            log(f"spec_streams {name} {json.dumps(res)}")
            if not all(r["dispatches_checked"] for r in rows):
                raise RuntimeError(f"{name}: a stream had no verifying "
                                   f"dispatch: {res}")
            return refs, gaps, res, events
        js = [j for j, _, _ in diff]
        for j, g in zip(js, regap([prompts[j] for j in js],
                                  [got[j] for j in js])):
            refs[j], gaps[j] = got[j], g
    raise RuntimeError(f"{name}: the streams still left their references "
                       f"after {SPEC_ROUNDS} rounds: {left}")


def request_harvests(events: list, rid: str) -> list:
    """(tokens applied, drafts accepted or None) of each harvest of
    ``rid`` in a recorded run: a verify row's or a spec span's accepted
    drafts, None for a plain decode step or a prompt span."""
    out = []
    spans = {}
    for e in events:
        if e["ev"] == "ragged":
            spans[e["id"]] = {s: m for s, _st, _n, m in e["seqs"]}
        for row in e.get("applied", ()):
            if row[1] != rid:
                continue
            if e["ev"] == "spec_harvest":
                out.append((row[2], row[3]))
            elif e["ev"] == "ragged_harvest":
                spec = spans[e["id"]].get(row[0]) == "spec"
                if row[3]:          # a span that emitted
                    out.append((row[3] if spec else 1,
                                row[2] - 1 if spec else None))
            elif e["ev"] == "harvest":
                out += [(1, None)] * row[2]
    return out


def check_spec_engines(params, cfg, dev, seed: int, mode: str,
                       launches: Optional[dict]) -> dict:
    """8b-8d in one mode. 8b: an in-process EngineCore (split path) whose
    drafter proposes reference streams, first the engine's own streams at
    speculation 0 (oracle_rounds), SPEC_REQUESTS requests together, until
    each stream repeats its reference to the end with SPEC_K drafts
    accepted a dispatch; then a drafter wrong at draft SPEC_WRONG_AT from
    those references, accepting that many; 8c: the same on the
    row-sampled ragged program, with the oracle also on one request alone
    (spec spans at the max_num_seqs bucket; together they fill the
    capacity bucket); 8d: a recorded --ragged --decode-dispatch-pipeline
    run, an oracle request beside a longer one with speculation 0 (which
    chains once alone), replayed on the card (compare_replay empty) and
    clean under check_log and check_inputs. The drafting runs' launches
    (8b and 8c) are added to ``launches`` where it is given."""
    import numpy as np
    from dynamo_tpu_torch.engine import replay as treplay
    _, kv_quant = SERVE_MODES[mode]
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(3, cfg.vocab_size, size=SPEC_PROMPT).tolist()
               for _ in range(SPEC_REQUESTS)]
    n = len(prompts)

    regap = GapReader(params, cfg, dev, kv_quant, SPEC_PROMPT + SPEC_TOKENS)
    res = {}
    for ragged in (False, True):
        path = "ragged" if ragged else "split"
        name = f"{mode} {path}"
        core = spec_engine(params, cfg, dev, mode, ragged)
        plain = engine_streams(core, prompts, [0] * n, [SPEC_TOKENS] * n)
        emitted = 0 if ragged else 1
        runs = [("oracle", None, n), ("wrong", SPEC_WRONG_AT, n)]
        if ragged:
            runs.append(("oracle alone", None, 1))
        refs = plain
        gaps = regap(prompts, plain)
        for label, wrong, m in runs:
            # the wrong drafter and the lone request start from the
            # oracle's references
            got, got_gaps, res[f"{path} {label}"], events = oracle_rounds(
                core, f"{name} {label}", prompts[:m], refs[:m], gaps[:m],
                wrong, emitted, regap, launches)
            if label == "oracle":
                res[f"{path} plain kept"] = [r == p
                                             for r, p in zip(got, plain)]
                refs, gaps = got, got_gaps
            if ragged:
                # whether each dispatch with a spec span ran at the
                # max_num_seqs bucket: all of them alone, not all together
                small = [sum(e["counts"]) <= SPEC_B for e in events
                         if e["ev"] == "ragged"
                         and any(md == "spec" for *_, md in e["seqs"])]
                if not small or all(small) != (m == 1):
                    raise RuntimeError(f"{name} {label}: spec spans at the "
                                       f"small bucket: {small}")
        res[f"{path} graphs"] = sorted(
            str(k) for k in (core.ragged_program if ragged
                             else core.verify_program).graphs)
        del core
    # 8d: the recorded pipelined ragged + spec run, replayed on the card
    core = spec_engine(params, cfg, dev, mode, True, pipeline=True)
    core.drafter = OracleDrafter([prompts[0] + refs[0]], cfg.vocab_size)
    core.recorder = treplay.Recorder()
    engine_streams(core, prompts[:2], [-1, 0], [SPEC_TOKENS, 2 * SPEC_TOKENS])
    events = core.recorder.events
    spans = sum(1 for e in events if e["ev"] == "ragged"
                and any(m == "spec" for *_, m in e["seqs"]))
    chained = sum(1 for e in events if e["ev"] == "ragged"
                  and e["chained_from"] is not None)
    t0 = time.monotonic()
    replayed = treplay.replay(core, events)
    d = {"events": len(events), "spec_dispatches": spans,
         "chained_dispatches": chained,
         "replay_s": time.monotonic() - t0,
         "compare_replay": treplay.compare_replay(events, replayed)[:3],
         "check_log": [str(x) for x in
                       treplay.check_log(events, KV_BLOCK)[:3]],
         "check_inputs": treplay.check_inputs(events)[:3]}
    log(f"spec_replay {mode} {json.dumps(d)}")
    if (d["compare_replay"] or d["check_log"] or d["check_inputs"]
            or not spans or not chained):
        raise RuntimeError(f"{mode} replay: {d}")
    res["replay"] = d
    del core, replayed, regap
    return res


def row_sampled_inputs(spans: dict, tables, B: int, vocab: int,
                       rng) -> dict:
    """One row-sampled ragged dispatch's host inputs: ``spans`` (slot: (rows,
    first position)) packed in slot order over ``tables`` [B, M] and the
    trash sequence, random tokens, each row keyed at its position + 1,
    slot 0 seeded and sampled at temperature 0.7, top-p 0.9 (the filtered
    variant), the others greedy."""
    import numpy as np
    S = B + 1
    starts = np.zeros((S,), np.int32)
    counts = np.zeros((S,), np.int32)
    sample = np.zeros((S,), np.int32)
    pos, row_slot = [], []
    for slot in sorted(spans):
        n, p0 = spans[slot]
        starts[slot], counts[slot] = len(pos), n
        sample[slot] = len(pos) + n - 1
        pos += range(p0, p0 + n)
        row_slot += [slot] * n
    starts[B] = len(pos)
    pos = np.array(pos, np.int32)
    temp = np.zeros((S,), np.float32)
    top_p = np.ones((S,), np.float32)
    temp[0], top_p[0] = 0.7, 0.9
    return {"tokens": rng.integers(3, vocab, size=len(pos)).astype(np.int64),
            "positions": pos, "row_slot": np.array(row_slot, np.int32),
            "tables": np.concatenate([tables, np.zeros_like(tables[:1])]),
            "seq_starts": starts, "seq_counts": counts,
            "sample_rows": sample, "seeds": np.arange(S, dtype=np.int64),
            "steps": (pos + 1).astype(np.int64), "temperature": temp,
            "top_k": np.zeros((S,), np.int64), "top_p": top_p}


def span_one_key_short(attn: Callable, slot: int) -> Callable:
    """The ragged attention with a planted fault: ``slot``'s key count one
    short, so each row of its span misses the key its own row wrote."""
    def fault(q, k_cache, v_cache, block_tables, seq_starts, seq_counts,
              seq_lens, **kw):
        short = seq_lens.clone()
        short[slot] -= 1
        return attn(q, k_cache, v_cache, block_tables, seq_starts,
                    seq_counts, short, **kw)
    return fault


def check_row_sampled_program(params, cfg, dev, seed: int, mode: str,
                              plain_swaps) -> dict:
    """8a': the row-sampled ragged program (engine/programs.py
    RaggedProgram with row_sampled, the --spec-k --ragged program) over
    ``params`` and a spec_pool, at each row bucket: ``small``, slot 0's
    spec span of SPEC_K + 1 rows beside a decode row each of slots 1 and
    6 (7 rows, the max_num_seqs bucket); ``capacity``, a spec span of
    SPEC_K + 1 rows in every slot (40 rows, the capacity bucket); slot 0
    seeded with top-p (row_sampled_inputs). At each: its graph replay
    against the same program run eagerly (every used row's tokens,
    logprobs and logits, and the pool, bit for bit); a stale static input
    caught; its kernel path against ``plain_swaps`` and K4's plain
    version within MODEL_REL_TOL, and slot 0's key count one short in K4
    (span_one_key_short) beyond it."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine import attention
    from dynamo_tpu_torch.engine.models import family
    from dynamo_tpu_torch.engine.programs import RaggedProgram
    model = family(cfg)
    _, kv_quant = SERVE_MODES[mode]
    bs = KV_BLOCK
    kv, tables = spec_pool(params, cfg, dev, seed, kv_quant, bs,
                           MAX_MODEL_LEN)
    B, M, Tv = SPEC_B, tables.shape[1], SPEC_K + 1
    rng = np.random.default_rng(seed + 14)
    host_tables = tables.cpu().numpy()
    batches = {
        "small": {0: (Tv, SPEC_LENS[0]), 1: (1, SPEC_LENS[1]),
                  6: (1, SPEC_LENS[6])},
        "capacity": {b: (Tv, SPEC_LENS[b]) for b in range(B)}}
    snap = {n: t.clone() for n, t in kv.items()}

    def restore():
        for n, t in kv.items():
            t.copy_(snap[n])
    prog = RaggedProgram(params, kv, cfg, bs, B, M, RAGGED_CAPACITY,
                         RAGGED_MAX_ROWS, 0, dev, row_sampled=True)
    plain = tuple(plain_swaps) + (
        (model, "ragged_paged_attention",
         attention.ragged_paged_attention_ref),)
    fault = (model, "ragged_paged_attention",
             span_one_key_short(model.ragged_paged_attention, 0))
    res = {"mode": mode}
    with torch.inference_mode():
        for kind, spans in batches.items():
            inp = row_sampled_inputs(spans, host_tables, B, cfg.vocab_size,
                                     rng)
            used = int(inp["seq_counts"].sum())
            r = res[kind] = {"rows": used, "bucket": prog.bucket(inp)}
            restore()
            d = prog.dispatch("filtered", inp, with_logits=True)
            toks, lps = d.fetch()
            logits = d.logits[:used].clone()
            pool = {n: t[:, bs:].clone() for n, t in kv.items()}
            restore()
            e = prog.run_eager("filtered", inp, with_logits=True)
            r["replay_equals_eager"] = {
                "tokens": bool((toks[:used]
                                == e.toks.cpu().numpy()[:used]).all()),
                "logprobs": bool((lps[:used]
                                  == e.logprobs.cpu().numpy()[:used]).all()),
                "logits": torch.equal(logits, e.logits[:used]),
                "pool": all(torch.equal(pool[n], kv[n][:, bs:])
                            for n in kv)}
            del pool, e, d
            # the planted fault: a second dispatch whose inputs never
            # reach the graph (its static inputs keep this dispatch's)
            other = dict(inp, tokens=(inp["tokens"] + 1000) % cfg.vocab_size)
            restore()
            upload = prog._upload
            prog._upload = lambda inputs: None
            try:
                stale = prog.dispatch("filtered", other,
                                      with_logits=True).logits[:used].clone()
            finally:
                prog._upload = upload
            restore()
            right = prog.run_eager("filtered", other,
                                   with_logits=True).logits[:used]
            r["planted_stale_inputs_caught"] = not torch.equal(stale, right)
            del stale, right
            # the kernel path against the plain versions, and K4's fault
            restore()
            with swapped(*plain):
                ref = prog.run_eager("filtered", inp,
                                     with_logits=True).logits[:used]
            restore()
            with swapped(fault):
                bad = prog.run_eager("filtered", inp,
                                     with_logits=True).logits[:used]
            _, compare = logit_compare(ref)
            r["vs_plain"] = compare(logits)
            r["planted_fault"] = compare(bad)
            del ref, bad, logits
    restore()
    res["captures"], res["capture_s"] = prog.captures, prog.capture_s
    log(f"row_sampled_program {json.dumps(res)}")
    del kv, snap, prog
    for kind in batches:
        r, what = res[kind], f"row-sampled program {mode} {kind}"
        want = B if kind == "small" else RAGGED_CAPACITY
        bad_checks = [k for k, v in r["replay_equals_eager"].items()
                      if not v]
        if (r["bucket"] != want or bad_checks
                or not r["planted_stale_inputs_caught"]):
            raise RuntimeError(f"{what}: bucket {r['bucket']} (want "
                               f"{want}), replay != eager {bad_checks} or "
                               f"the stale input went unseen")
        check_model_limits(what, r["vs_plain"]["rel_err"],
                           {"span_one_key_short":
                            r["planted_fault"]["rel_err"]})
    return res


def spec_phase(cfg, dev, seed: int) -> dict:
    """Phase 8 but its servers, in each of SPEC_MODES: the verify program
    (8a), the row-sampled ragged program (8a') and the engines (8b-8d)
    over the mode's random weights at the 8B width and depth. Returns the
    kernels' launches over the bf16 drafting runs of 8b and 8c (K3 bf16
    at the verify shape, which no spec server runs; the comparisons of
    8a, the speculation-0 runs and 8d are not counted)."""
    import torch
    from dynamo_tpu_torch.engine import attention, lm_head, quant
    from dynamo_tpu_torch.engine import quant_matmul
    from dynamo_tpu_torch.engine.models import llama
    launches: dict = {}
    for mode in SPEC_MODES:
        with phase(f"8 {mode}"):
            weights, _ = SERVE_MODES[mode]
            params = spec_weights(cfg, dev, seed, mode)
            swaps = [(llama, "paged_attention", attention.paged_attention_ref)]
            if weights != "none":
                swaps.append((llama, "lm_head_int8",
                              lm_head.lm_head_int8_ref))
            if weights == "int4":
                swaps.append((quant, "grouped_int4_matmul",
                              quant_matmul.grouped_int4_matmul_ref))
            a = check_verify_program(params, cfg, dev, seed, mode, "8B",
                                     KV_BLOCK, MAX_MODEL_LEN, swaps)
            if not a["vs_decode_max_abs_err"] <= SPEC_VS_DECODE_MAX:
                raise RuntimeError(
                    f"verify program {mode}: rows differ from the decode "
                    f"program's by {a['vs_decode_max_abs_err']} logits, "
                    f"over SPEC_VS_DECODE_MAX {SPEC_VS_DECODE_MAX}: "
                    f"SPEC_NEAR_TIE no longer bounds the ties they flip")
            check_row_sampled_program(params, cfg, dev, seed, mode, swaps)
            check_spec_engines(params, cfg, dev, seed, mode,
                               launches if weights == "none" else None)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    log(f"spec launches (bf16 drafting runs) {json.dumps(launches)}")
    for k in ("paged_attention", "ragged_paged_attention"):
        if launches.get(k, 0) <= 0:
            raise RuntimeError(f"phase 8: kernel {k} was never launched "
                               f"by the bf16 drafting runs")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the KV tiers at the 8B width and depth
# ---------------------------------------------------------------------------

def tier_formats():
    """(name, model config at full depth, kv quantization, block size) of
    each pool row format 9a round-trips: the 8B's bf16 rows (8 wire
    heads), its int8 rows (1152 lanes, one opaque head), V2-Lite's latent
    rows in bf16 and int8-sectioned."""
    from dynamo_tpu_torch.engine.config import bench_model_config
    c8 = bench_model_config("8b")
    cm = mla_config()
    return [("8b_bf16", c8, "none", KV_BLOCK), ("8b_int8", c8, "int8", KV_BLOCK),
            ("v2lite_bf16", cm, "none", MLA_BLOCK[0]),
            ("v2lite_int8", cm, "int8", MLA_BLOCK[1])]


def blocks_mismatched(kv, orig, src, tgt, bs: int) -> int:
    """Target blocks whose bytes differ from their source's in ``orig``."""
    bad = 0
    for k in kv:
        L, T, C = kv[k].shape
        got = kv[k].view(L, T // bs, bs, C)
        want = orig[k].view(L, T // bs, bs, C)
        for s, t in zip(src, tgt):
            if not torch_equal_bits(got[:, t], want[:, s]):
                bad += 1
    return bad


def torch_equal_bits(a, b) -> bool:
    import torch
    return bool(torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def check_tier_round_trips(dev) -> list:
    """9a: at each row format, gather 32 random blocks on the compute
    stream, copy them into pinned memory on the tier stream, store them in
    a pinned host arena, fetch them into pinned staging, copy them back and
    scatter them in place into 32 other blocks: every target must equal
    its source bit for bit, the other blocks must be untouched, the pool
    tensors must keep their addresses, and the same check must catch the
    targets shifted by one (a planted fault)."""
    import numpy as np
    import torch
    from dynamo_tpu_torch.engine import block_copy as bc
    from dynamo_tpu_torch.engine.models import family
    from dynamo_tpu_torch.llm.kv.offload import HostKvPool
    out = []
    side = torch.cuda.Stream(dev)
    for name, cfg, kvq, bs in tier_formats():
        mod = family(cfg)
        kv = mod.init_kv_cache(cfg, TIER_RT_BLOCKS, bs, dev, torch.bfloat16,
                               quantization=kvq)
        for v in kv.values():
            v.view(torch.uint8).random_(0, 256)
        ptrs = {k: v.data_ptr() for k, v in kv.items()}
        orig = {k: v.clone() for k, v in kv.items()}
        heads = bc.wire_kv_heads(cfg, kvq)
        perm = np.random.default_rng(9).permutation(
            np.arange(1, TIER_RT_BLOCKS)).tolist()
        n = (TIER_RT_BLOCKS - 1) // 2
        src, tgt = perm[:n], perm[n:2 * n]
        torch.cuda.synchronize()
        d2h = bc.start_d2h(kv, src, bs, heads, stream=side)
        rows = d2h.wait()
        one = {k: v[0] for k, v in rows.items()}
        host = HostKvPool(n, cfg.num_layers, one[next(iter(one))].shape[1],
                          bs, one[next(iter(one))].shape[-1],
                          dtype=one[next(iter(one))].dtype,
                          opaque_rows=heads == 1, pin_memory=True)
        hashes = list(range(1000, 1000 + n))
        host.store(hashes, {k: bc.rows_as_wire(v) for k, v in rows.items()})
        staged = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                  for k, v in rows.items()}
        host.fetch_rows(host.match_prefix(hashes), out=staged)
        h2d = bc.start_h2d(staged, dev, stream=side)
        h2d.wait()
        bc.scatter_transfer(kv, tgt, h2d, bs)
        torch.cuda.synchronize()
        nbytes = sum(v.numel() * v.element_size() for v in rows.values())
        bad = blocks_mismatched(kv, orig, src, tgt, bs)
        rest = [b for b in range(TIER_RT_BLOCKS) if b not in tgt]
        untouched = blocks_mismatched(kv, orig, rest, rest, bs)
        fault = blocks_mismatched(kv, orig, src, tgt[1:] + tgt[:1], bs)
        e = {"format": name, "blocks": n, "wire_heads": heads,
             "row_shape": list(one[next(iter(one))].shape),
             "block_bytes": nbytes // n, "mismatched": bad,
             "untouched_changed": untouched, "planted_fault_caught": fault,
             "d2h_gb_s": nbytes / d2h.copy_s() / 1e9,
             "h2d_gb_s": nbytes / h2d.copy_s() / 1e9,
             "arena_pin_s": host.pin_s}
        log(f"tier round trip {json.dumps(e)}")
        if bad or untouched or not fault:
            raise RuntimeError(f"tier round trip {name}: {bad} targets "
                               f"differ, {untouched} other blocks changed, "
                               f"planted fault caught in {fault} blocks")
        if {k: v.data_ptr() for k, v in kv.items()} != ptrs:
            raise RuntimeError(f"tier round trip {name}: a pool tensor "
                               f"moved")
        out.append(e)
        del kv, orig, rows, staged, h2d, host
    return out


def completion_bits(res: dict) -> tuple:
    """(text, tokens, token logprobs) of a unary completion asked with
    logprobs: what two servings of one prompt must share bit for bit."""
    ch = res["response"]["choices"][0]
    lp = ch.get("logprobs") or {}
    return ch["text"], lp.get("tokens"), lp.get("token_logprobs")


def scribbling_move(move):
    """``block_copy.move_blocks`` that, after the move, overwrites the
    vacated source blocks: a program that still read the old table would
    read garbage there (9e)."""
    def moved(kv, src, dst, bs):
        move(kv, src, dst, bs)
        gone = [b for b in src if b not in set(dst)]
        for v in kv.values():
            L, T, C = v.shape
            v.view(L, T // bs, bs, C)[:, gone] = 77
    return moved


async def defrag_stream(core, prompt: list, threshold: float) -> tuple:
    """9e on the server's loop: at ``threshold``, with prefix reuse off,
    shatter the pool (every free block held, every other one released),
    admit ``prompt``, release the rest once it is admitted, and serve it
    to the end. Returns (tokens, logprobs, defrag passes of the run, the
    request's block runs at admission)."""
    import asyncio
    import dataclasses as dc
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    while any(s is not None for s in core.slots):
        await asyncio.sleep(0.01)
    core.cfg = dc.replace(core.cfg, kv_defrag_threshold=threshold)
    mgr = core.kv_manager
    mgr.enable_reuse = False
    passes0 = core.defrag_passes
    pool = mgr.pool
    pool.reset()
    comb = pool.alloc_uninit(pool.free_uninit_blocks)
    pool.release(comb[::2])
    req = EngineRequest(rid=f"defrag-{threshold}", prompt=list(prompt),
                        sampling=SlotSampling(temperature=0.0),
                        max_new_tokens=48, eos_ids=frozenset())
    await core.submit(req)
    while req.slot < 0:
        await asyncio.sleep(0)
    runs = pool.count_runs(req.blocks)
    pool.release(comb[1::2])
    toks, lps = [], []
    while True:
        item, lp = await asyncio.wait_for(req.out_queue.get(), 300)
        if item is FINISH_SENTINEL:
            break
        toks.append(item)
        lps.append(lp)
    mgr.enable_reuse = True
    core.cfg = dc.replace(core.cfg, kv_defrag_threshold=0.5)
    return toks, lps, core.defrag_passes - passes0, runs


async def recorded_restore(core, prompt: list) -> list:
    """9f on the server's loop: record a fresh prompt served cold, its
    write-back, a device wipe and its host-tier restore."""
    import asyncio
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.replay import Recorder
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    while any(s is not None for s in core.slots):
        await asyncio.sleep(0.01)
    await core.offload_engine.drain()
    core.kv_manager.pool.reset()
    core.recorder = Recorder()
    try:
        for rid in ("rec-cold", "rec-host"):
            req = EngineRequest(rid=rid, prompt=list(prompt),
                                sampling=SlotSampling(temperature=0.0),
                                max_new_tokens=TIER_TOKENS,
                                eos_ids=frozenset())
            await core.submit(req)
            while True:
                item, _ = await asyncio.wait_for(req.out_queue.get(), 300)
                if item is FINISH_SENTINEL:
                    break
            await core.offload_engine.drain()
            core.kv_manager.pool.reset()
        return core.recorder.events
    finally:
        core.recorder = None


def on_loop(loop, coro, timeout: float = 600):
    """Run ``coro`` on the server's event loop and wait for its result."""
    import asyncio
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def itl_split(streams: list, windows: list) -> dict:
    """Inter-token gaps of ``streams`` (each: wall start, the SSE result)
    whose later token landed inside one of ``windows`` (wall t0, t1) or
    outside all: p50 and max of each, in ms."""
    import numpy as np
    inside, outside = [], []
    for start, res in streams:
        t = [start + tm for c, tm in zip(res["chunks"], res["times"])
             if c.get("choices") and c["choices"][0].get("text")]
        for a, b in zip(t, t[1:]):
            (inside if any(w0 <= b <= w1 for w0, w1 in windows)
             else outside).append(1e3 * (b - a))
    stat = lambda x: ({"n": len(x), "p50": float(np.median(x)),  # noqa: E731
                       "max": float(max(x))} if x else {"n": 0})
    return {"in_window": stat(inside), "outside": stat(outside)}


def onboards_since(core, n0: int) -> list:
    """The flight recorder's ``onboard`` records written since its
    ``records_total`` was ``n0``, oldest first."""
    new = core.flight.records_total - n0
    ring = core.flight.dump()
    if new > len(ring):
        raise RuntimeError(f"the flight ring overran: {new} records since "
                           f"the mark, {len(ring)} kept")
    return [r for r in ring[len(ring) - new:] if r["kind"] == "onboard"]


class TierRun:
    """One tiered server's traffic helpers (9b-9f): its core, port and
    loop, the served model name, and the prompts X and Y."""

    def __init__(self, core, loop, port: int, name: str, cfg, seed: int):
        import numpy as np
        self.core, self.loop, self.port, self.name = core, loop, port, name
        self.pool = core.kv_manager.pool
        lo = 259
        rng = np.random.default_rng(seed + 90)
        self.mk = lambda n: rng.integers(lo, cfg.vocab_size,  # noqa: E731
                                         size=n).tolist()
        self.x = np.random.default_rng(seed + 91).integers(
            lo, cfg.vocab_size, size=TIER_PROMPT).tolist()
        self.y = np.random.default_rng(seed + 92).integers(
            lo, cfg.vocab_size, size=TIER_PROMPT).tolist()
        self.greedy = {"model": name, "temperature": 0,
                       "nvext": {"ignore_eos": True}}
        # the device hit of a repeated TIER_PROMPT: all its blocks but the
        # last, which always recomputes
        self.n_hit = TIER_PROMPT // KV_BLOCK - 1

    def one(self, prompt, n=TIER_TOKENS) -> dict:
        return http_completion(self.port, {**self.greedy, "logprobs": 1,
                                           "prompt": prompt,
                                           "max_tokens": n})

    def tiered(self, prompt) -> tuple:
        """Serve ``prompt``: its bits, the device blocks it hit and its
        onboard's (host, disk) blocks, (0, 0) when it had none."""
        hits0, n0 = self.pool.match_hits, self.core.flight.records_total
        bits = completion_bits(self.one(prompt))
        on = onboards_since(self.core, n0)
        return (bits, self.pool.match_hits - hits0,
                (on[0]["host_blocks"], on[0]["disk_blocks"]) if on
                else (0, 0))

    def churn(self, n: int) -> None:
        """``n`` fresh 1000-token requests, 3 at a time, 8 tokens each."""
        from concurrent.futures import ThreadPoolExecutor
        prompts = [self.mk(TIER_CHURN) for _ in range(n)]
        with ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda p: self.one(p, 8), prompts))

    def twin(self, prompt, label: str) -> tuple:
        """Serve ``prompt`` cold, then again from its device-resident
        prefix: the second serving's bits, the reference of its restores."""
        self.one(prompt)
        bits, dev, _ = self.tiered(prompt)
        if dev != self.n_hit:
            raise RuntimeError(f"9b: {label}'s twin hit {dev} device "
                               f"blocks, want {self.n_hit}")
        return bits

    def restore(self, prompt, twin, want_on: tuple, label: str) -> None:
        bits, dev, on = self.tiered(prompt)
        if bits != twin or on != want_on or dev:
            raise RuntimeError(f"{label}: restored from {on} host/disk "
                               f"blocks (want {want_on}) and {dev} device "
                               f"blocks, bits equal to the device-hit "
                               f"twin: {bits == twin} ({bits[0]!r} vs "
                               f"{twin[0]!r})")


def tier_traffic(run: TierRun, path: str, report: dict) -> None:
    """9b, 9d and 9e on a tiered server (see TierRun)."""
    from concurrent.futures import ThreadPoolExecutor
    from dynamo_tpu_torch.llm.kv.blocks import TokenBlockSequence
    core, pool = run.core, run.pool
    disk = core.disk_store is not None
    hits0 = pool.match_hits
    # two conversations whose turns extend the last one: device hits
    convs = [run.mk(TIER_TURNS[0]) for _ in range(2)]
    for extra in TIER_TURNS[1:] + (0,):
        for i in range(2):
            run.one(convs[i], 8)
            convs[i] = convs[i] + run.mk(extra)
    report["conversations"] = {"device_hit_blocks": pool.match_hits - hits0}
    if disk:
        report["_x_twin"] = run.twin(run.x, "X")
        run.churn(TIER_CHURN1)           # X leaves the device and the host
        hashes = TokenBlockSequence(KV_BLOCK, run.x).sequence_hashes[
            :run.n_hit]
        t0 = time.monotonic()
        while not all(core.disk_store.contains(h) for h in hashes):
            if time.monotonic() - t0 > 120:
                raise RuntimeError("9b: X's blocks never reached the disk "
                                   f"(spill drops: "
                                   f"{core.spill_engine.dropped_jobs_total})")
            time.sleep(0.05)
    y_twin = run.twin(run.y, "Y")
    run.churn(TIER_CHURN2)               # Y leaves the device, not the host
    # 9d: Y restored from the host while two other requests decode
    streams = []

    def decoder(p):
        t = time.time()
        streams.append((t, http_completion(run.port, {
            **run.greedy, "prompt": p, "stream": True,
            "max_tokens": TIER_DECODE_TOKENS})))
    n0 = core.flight.records_total
    decoded0 = core.total_decode_tokens
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(decoder, run.mk(64)) for _ in range(2)]
        t0 = time.monotonic()
        while core.total_decode_tokens - decoded0 < 32:
            if time.monotonic() - t0 > 120:
                raise RuntimeError("9d: the decoders never decoded")
            time.sleep(0.01)
        run.restore(run.y, y_twin, (run.n_hit, 0), f"9b {path} Y")
        for f in futs:
            f.result()
    on = onboards_since(core, n0)[0]
    window = (on["t_start"], on["t"])
    inside = [r for r in core.flight.dump()
              if r["kind"] in ("decode", "ragged")
              and window[0] <= r["t"] <= window[1]]
    report["overlap"] = {
        "onboard_blocks": on["host_blocks"] + on["disk_blocks"],
        "window_ms": 1e3 * (window[1] - window[0]),
        "read_ms": on["read_ms"],
        "h2d_ms": on["h2d_ms"],
        "h2d_gb_s": on["h2d_bytes"] / on["h2d_copy_ms"] / 1e6,
        "dispatches_in_window": len(inside),
        "itl_ms": itl_split(streams, [window])}
    if not inside:
        raise RuntimeError(f"9d {path}: no decode dispatch inside the "
                           f"onboard window")
    if disk:
        n0 = core.flight.records_total
        run.restore(run.x, report["_x_twin"], (0, run.n_hit), "9b X")
        last = onboards_since(core, n0)[-1]
        report["disk_restore"] = {
            "read_ms": last["read_ms"],
            "h2d_gb_s": last["h2d_bytes"] / last["h2d_copy_ms"] / 1e6}
    # 9e: the defrag pass against the same run with it off
    dprompt = run.mk(600)
    off = on_loop(run.loop, defrag_stream(core, dprompt, 0.0))
    dfr = on_loop(run.loop, defrag_stream(core, dprompt, 0.5))
    report["defrag"] = {"runs_at_admission": dfr[3], "passes": dfr[2],
                        "passes_off": off[2],
                        "moves_total": pool.defrag_moves_total}
    if dfr[2] < 1 or off[2] or dfr[:2] != off[:2] or dfr[3] < 2:
        raise RuntimeError(f"9e {path}: defrag passes {dfr[2]} (off: "
                           f"{off[2]}), runs {dfr[3]}, streams equal: "
                           f"{dfr[:2] == off[:2]}")
    batches = core.offload_engine.transfers
    m = core.metrics()
    report["tiers"] = {
        "host_onboards": core.host_onboards,
        "disk_onboards": core.disk_onboards,
        "device_hit_blocks": pool.match_hits,
        "host_stored": m.host_stored_total,
        "host_evicted": m.host_evicted_total,
        "disk_stored": m.disk_stored_total,
        "offload_dropped": m.offload_dropped_jobs_total,
        "spill_dropped": m.disk_spill_dropped_total,
        "d2h_batches": len(batches),
        "d2h_gb_s": (sum(b for _n, b, _s, _c in batches)
                     / sum(c for _n, _b, _s, c in batches) / 1e9),
        "d2h_commit_ms_mean": 1e3 * sum(s for _n, _b, s, _c in batches)
        / len(batches),
        "arena_pin_s": core.kv_manager.host_pool.pin_s}
    if not (core.host_onboards and pool.match_hits
            and (core.disk_onboards or not disk)):
        raise RuntimeError(f"9b {path}: tier hits {report['tiers']}")


def tier_replay(run: TierRun, report: dict) -> None:
    """9f: a recorded restore, replayed on the card. The replay builds
    programs of its own, so it runs after the server's launch counts are
    read."""
    from dynamo_tpu_torch.engine import replay
    events = on_loop(run.loop, recorded_restore(run.core, run.mk(300)))
    out = replay.replay(run.core, events)
    diffs = replay.compare_replay(events, out)
    kinds = {e["ev"] for e in events}
    restores = [e for e in events if e["ev"] == "hit_transfer"
                and e.get("host_hit")]
    report["replay"] = {"events": len(events),
                        "kv_store": "kv_store" in kinds,
                        "host_restores": len(restores),
                        "diffs": len(diffs)}
    if diffs or not restores or "kv_store" not in kinds:
        raise RuntimeError(f"9f: replay {report['replay']}: {diffs[:3]}")


def tier_server(cfg, seed: int, card: str, model_dir: str, path: str,
                disk_dir: str, restart_of: Optional[dict] = None) -> tuple:
    """One tiered server (9b, 9d-9f), or with ``restart_of`` (the report of
    the server that wrote ``disk_dir``) its warm restart (9c): a new
    engine on the same directory must serve X from disk with the bits its
    twin had. The launch counts cover the traffic after the two requests
    that capture the graphs and before 9f's replay. Returns (launch
    counts, report)."""
    import gc
    import torch
    from dynamo_tpu_torch.engine import core as core_mod
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.launch import run as launcher
    weights, kv_quant = SERVE_MODES["int4_kv8" if "int4" in path
                                    else "bf16"]
    disk = path == "tier_int4_kv8"
    args = launcher.build_parser().parse_args(
        ["in=http", "out=torch", "--model-path", model_dir,
         "--random-weights", "--http-host", "127.0.0.1", "--http-port", "0",
         "--max-model-len", str(MAX_MODEL_LEN), "--kv-block-size",
         str(KV_BLOCK), "--num-kv-blocks", str(TIER_DEVICE_BLOCKS),
         "--max-num-seqs", "8", "--device", "cuda", "--quantization",
         weights, "--kv-quantization", kv_quant, "--host-kv-blocks",
         str(TIER_HOST_BLOCKS)]
        + (["--kv-disk-dir", disk_dir, "--kv-disk-blocks",
            str(TIER_DISK_BLOCKS)] if disk else [])
        + TIER_FLAGS[path])
    launcher.parse_io(args.io)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    core = launcher.build_core(args)
    report = {"bring_up": {"engine_s": time.monotonic() - t0}}
    if disk:
        report["bring_up"]["disk_restored_blocks"] = \
            core.disk_store.restored_blocks
    loop, stop_server = start_server(args, core)
    run = TierRun(core, loop, args.http_port, launcher.model_name(args),
                  cfg, seed)
    stack = contextlib.ExitStack()
    try:
        # the graphs, captured before the counted traffic
        for extra in ({"temperature": 0}, {"temperature": 0.7, "top_p": 0.9,
                                           "seed": 2}):
            http_completion(run.port, {**run.greedy, "prompt": run.mk(16),
                                       "max_tokens": 4, **extra})
        kernels.reset_launch_counts()
        if restart_of is not None:
            n0 = core.flight.records_total
            run.restore(run.x, restart_of["_x_twin"], (0, run.n_hit),
                        "9c warm restart X")
            report["warm_x"] = {"disk_blocks": run.n_hit,
                                "read_ms": onboards_since(core, n0)[-1][
                                    "read_ms"]}
        else:
            stack.enter_context(swapped((core_mod, "move_blocks",
                                         scribbling_move(
                                             core_mod.move_blocks))))
            tier_traffic(run, path, report)
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        if restart_of is None and core.cfg.ragged_dispatch:
            tier_replay(run, report)
    finally:
        stack.close()
        stop_server()
    for k, v in report.items():
        if not k.startswith("_"):
            log(f"tier {path} {k} {json.dumps(v)} [{card}]")
    log(f"serve {path}: launches {json.dumps(launches)}")
    for k in PATH_KERNELS[path]:
        if launches[k] <= 0:
            raise RuntimeError(f"serve {path}: kernel {k} was never "
                               f"launched")
    if core.cfg.ragged_dispatch:
        split = {k: launches[k] for k in SPLIT_ATTENTION if launches[k]}
        if split:
            raise RuntimeError(f"serve {path}: split-path attention "
                               f"launched on the ragged path: {split}")
    del core, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


def tier_phase(cfg, dev, seed: int, card: str) -> dict:
    """Phase 9: the round trips (9a), the two tiered servers (9b, 9d-9f)
    and the warm restart of the first (9c). Returns their launch counts
    and reports by path."""
    import tempfile
    with phase("9a"):
        check_tier_round_trips(dev)
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="dtt-tier-") as tmp:
        model_dir = os.path.join(tmp, "llama3-8b-random")
        write_model_dir(model_dir, cfg)
        disk_dir = os.path.join(tmp, "kv-disk")
        for path in TIER_PATHS:
            with phase(f"9 {path}"):
                by_path[path] = tier_server(cfg, seed, card, model_dir, path,
                                            disk_dir)
            if path == "tier_int4_kv8":
                with phase("9c"):
                    tier_server(cfg, seed, card, model_dir, path, disk_dir,
                                restart_of=by_path[path][1])
    return by_path


# ---------------------------------------------------------------------------
# 10. KV-aware routing over two workers on the one card
# ---------------------------------------------------------------------------

ROUTED_ENDPOINT = "dyn://dynamo/worker/generate"
ROUTED_GROUPS = 4
ROUTED_PREFIX_BLOCKS = 62        # each group's shared prefix: 992 tokens
ROUTED_SUFFIX = (16, 64)         # each request's own suffix, tokens
ROUTED_FOLLOW_UPS = 3            # a group, one at a time
ROUTED_TOKENS = 32
ROUTED_CUT_TOKENS = 384          # the streams in flight at the SIGTERM
ROUTED_READY_S = 300.0           # a process must be ready by then
ROUTED_ERROR_S = 30.0            # a cut stream must end in an error by then
ROUTED_GONE_S = 40.0             # the lost worker's key (10 s lease) by then
# after a worker's published stats show it idle, one processor scrape (its
# interval is 1 s) has cleared the router's optimistic load by then
ROUTED_SCRAPE_S = 1.3


class RoutedProcs:
    """The phase's processes (the daemon, two workers and the processor),
    each logging to a file of its own; ``stop`` ends every one."""

    def __init__(self, tmp: str, tag: str = "10"):
        self.tmp = tmp
        self.tag = tag
        self.procs: dict = {}

    def start(self, name: str, module: str, *args) -> None:
        """``python -m module args`` with SIGINT's default handler (a child
        of a process started in a shell's background inherits SIGINT
        ignored, and ``stop`` stops by SIGINT)."""
        path = os.path.join(self.tmp, f"{name}.log")
        run = ("import runpy, signal; "
               "signal.signal(signal.SIGINT, signal.default_int_handler); "
               f"runpy.run_module({module!r}, run_name='__main__', "
               "alter_sys=True)")
        f = open(path, "w")
        try:
            self.procs[name] = (subprocess.Popen(
                [sys.executable, "-c", run, *args], cwd=ROOT,
                stdout=f, stderr=subprocess.STDOUT), path)
        finally:
            f.close()

    def text(self, name: str) -> str:
        with open(self.procs[name][1], errors="replace") as f:
            return f.read()

    def wait_line(self, name: str, start: str, timeout: float) -> str:
        """The first line of ``name``'s log that starts with ``start``."""
        deadline = time.monotonic() + timeout
        while True:
            for line in self.text(name).splitlines():
                if line.startswith(start):
                    return line
            proc = self.procs[name][0]
            if proc.poll() is not None:
                raise RuntimeError(f"{self.tag}: {name} exited "
                                   f"({proc.returncode}) before {start!r}:\n"
                                   f"{self.text(name)[-3000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"{self.tag}: no {start!r} from {name} in "
                                   f"{timeout} s:\n{self.text(name)[-3000:]}")
            time.sleep(0.05)

    def signal(self, name: str, sig) -> None:
        proc = self.procs[name][0]
        if proc.poll() is None:
            proc.send_signal(sig)

    def stop(self, names, timeout: float = 60.0) -> None:
        import signal
        for n in names:
            self.signal(n, signal.SIGINT)
        for n in names:
            proc = self.procs[n][0]
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)

    def tails(self) -> str:
        return "\n".join(f"== {n}\n{self.text(n)[-2000:]}"
                         for n in self.procs)


def routed_prompts(cfg, seed: int) -> dict:
    """Each group's prefix and the suffixes of its seed, follow-ups, cut
    stream and last request (token ids of the chat directory's vocab)."""
    import numpy as np
    rng = np.random.default_rng(seed + 100)

    def ids(n):
        return rng.integers(1000, 127000, size=n).tolist()

    def suffix():
        return ids(int(rng.integers(ROUTED_SUFFIX[0], ROUTED_SUFFIX[1] + 1)))
    out = {}
    for g in range(ROUTED_GROUPS):
        prefix = ids(ROUTED_PREFIX_BLOCKS * KV_BLOCK)
        out[g] = {"prefix": prefix, "seed": prefix + suffix(),
                  "follow": [prefix + suffix()
                             for _ in range(ROUTED_FOLLOW_UPS)],
                  "cut": prefix + suffix(), "last": prefix + suffix()}
    return out


def routed_body(name: str, prompt: list, n: int) -> dict:
    return {"model": name, "prompt": prompt, "max_tokens": n,
            "temperature": 0, "stream": True, "logprobs": 1,
            "nvext": {"ignore_eos": True}}


def routed_stream(res: dict) -> dict:
    """A streamed completion's tokens, each as its text (asked with
    ``logprobs``, every token comes in a chunk of its own, which carries
    its logprob and its text, empty while a character is incomplete), its
    first token's time, its finish reason and its error event, if any."""
    toks, finish, ttft = [], None, None
    for ev, t in zip(res["events"], res["times"]):
        if ev.event == "error":
            return {"error": " ".join(ev.comments), "tokens": toks,
                    "done": res["done"]}
        if not ev.data:
            continue
        c = json.loads(ev.data)
        for ch in c.get("choices") or []:
            lp = (ch.get("logprobs") or {}).get("token_logprobs") or []
            toks += [ch.get("text") or ""] * len(lp)
            if lp and ttft is None:
                ttft = 1e3 * t
            if ch.get("finish_reason"):
                finish = ch["finish_reason"]
    return {"tokens": toks, "ttft_ms": ttft, "finish": finish,
            "done": res["done"], "request_id": res.get("request_id"),
            "error": None}


def routed_phase(cfg, dev, seed: int, card: str) -> tuple:
    """Phase 10: KV-aware routing over two 8B workers sharing the card.

    The port's daemon (``runtime/server.py``) on a free port, two workers
    through the launcher's own entry point (``in=dyn://dynamo/worker/
    generate out=torch --protocol tokens --random-weights --quantization
    int4 --kv-quantization int8``, the same seed, 2048 blocks of 16 each,
    phase 7's ``tokenizer.json`` directory at full depth), and the KV-aware
    processor (``components/processor.py``, ``--kv-block-size 16``). An
    observer in this process connects to the daemon: the router's
    ``kv-hit-rate`` events give each decision's worker and overlap, and
    the workers' published stats their prefix hits and launch counts.
    Beside them an in-process server of phase 7's shape at the same seed
    serves the same requests: the reference.

    Traffic (greedy, ``ignore_eos``, streamed, token-id prompts): four
    prefix groups of 62 full blocks with 16-64-token suffixes; (a) the four
    seeds together; (b) three follow-ups a group, one group at a time, one
    at a time once the processor has scraped the idle workers; (c) four
    long requests stream and the worker of the first gets SIGTERM; once
    its key is gone, (d) four more requests.

    Checks: (1) both workers serve a group; (2) each follow-up goes to its
    group's seed worker with an overlap of the prefix's 62 blocks, and that
    worker's prefix hits grow by 62; (3) each finished stream equals the
    reference's, or parts from it only at a near tie (``SPEC_NEAR_TIE``,
    as phase 8 judges one); (4) the lost worker's discovery key goes, the
    processor prunes its blocks from the router's index, each stream cut
    there ends in an error event within ``ROUTED_ERROR_S``, and the last
    four requests finish on the survivor; (5) each worker launched K1,
    K3-int8, K5 and K6 (their stats; the survivor's final counts from its
    log at stop). Returns (the two workers' summed launches, report)."""
    import asyncio
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from dynamo_tpu_torch.launch import run as launcher
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.kv.native_pool import load_native_pool_lib
    from dynamo_tpu_torch.llm.kv_router.protocols import KV_HIT_RATE_SUBJECT
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime import ResponseStream
    from dynamo_tpu_torch.runtime.distributed import (DistributedRuntime,
                                                      Endpoint)

    t_phase = time.monotonic()
    load_native_pool_lib()          # built once, before any worker starts
    weights, kv_quant = SERVE_MODES[SERVE_PATHS[CHAT_PATH][0]]
    prompts = routed_prompts(cfg, seed)
    name = "llama3-8b-routed"
    report: dict = {}
    tmp_ctx = tempfile.TemporaryDirectory(prefix="dtt-routed-")
    tmp = tmp_ctx.name
    model_dir = os.path.join(tmp, name)
    write_chat_model_dir(model_dir, cfg)
    procs = RoutedProcs(tmp)
    obs_loop = asyncio.new_event_loop()
    obs_thread = threading.Thread(target=obs_loop.run_forever,
                                  name="routed-observer", daemon=True)
    obs_thread.start()
    stop_ref = None
    try:
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dport = s.getsockname()[1]
        addr = f"127.0.0.1:{dport}"
        procs.start("daemon", "dynamo_tpu_torch.runtime.server", "--host",
                    "127.0.0.1", "--port", str(dport))
        procs.wait_line("daemon", "dynamo-tpu-torch discovery", 60)
        worker_args = [f"in={ROUTED_ENDPOINT}", "out=torch", "--protocol",
                       "tokens", "--random-weights", "--quantization",
                       weights, "--kv-quantization", kv_quant,
                       "--model-path", model_dir, "--runtime-server", addr,
                       "--max-model-len", str(MAX_MODEL_LEN),
                       "--kv-block-size", str(KV_BLOCK), "--num-kv-blocks",
                       "2048", "--max-num-seqs", "8", "--device", dev.type]
        t0 = time.monotonic()
        for w in ("worker0", "worker1"):
            procs.start(w, "dynamo_tpu_torch.launch.run", *worker_args)
        procs.start("processor", "dynamo_tpu_torch.components.processor",
                    "--runtime-server", addr, "--model-path", model_dir,
                    "--model-name", name, "--endpoint", ROUTED_ENDPOINT,
                    "--host", "127.0.0.1", "--port", "0",
                    "--kv-block-size", str(KV_BLOCK))

        # the reference, in this process while the workers come up
        class Recorder:
            """The engine's token ids per request id."""

            def __init__(self, engine):
                self.engine = engine
                self.ids: dict = {}

            async def generate(self, request):
                stream = await self.engine.generate(request)
                got = self.ids.setdefault(request.ctx.id, [])

                async def tap():
                    async for item in stream:
                        data = getattr(item, "data", None)
                        if data is not None:
                            got.extend(data.token_ids)
                        yield item
                return ResponseStream(tap(), stream.ctx)

        rargs = launcher.build_parser().parse_args(
            ["in=http", "out=torch", "--model-path", model_dir,
             "--random-weights", "--http-host", "127.0.0.1",
             "--http-port", "0", "--max-model-len", str(MAX_MODEL_LEN),
             "--kv-block-size", str(KV_BLOCK), "--num-kv-blocks", "2048",
             "--max-num-seqs", "8", "--device", dev.type,
             "--quantization", weights, "--kv-quantization", kv_quant])
        ref_core = launcher.build_core(rargs)
        mdc = ModelDeploymentCard.from_local_path(model_dir,
                                                  display_name=name)
        recorder = Recorder(TorchEngine(ref_core))
        _, stop_ref = start_server(rargs, ref_core, launcher.link_pipeline(
            recorder, mdc))
        rport = rargs.http_port

        def ref_one(prompt, n=ROUTED_TOKENS):
            return routed_stream(http_request(
                rport, "/v1/completions", routed_body(name, prompt, n)))
        ref = {}
        with ThreadPoolExecutor(ROUTED_GROUPS) as ex:
            for g, r in zip(range(ROUTED_GROUPS), ex.map(
                    lambda g: ref_one(prompts[g]["seed"]),
                    range(ROUTED_GROUPS))):
                ref[("seed", g, 0)] = r
        for g in range(ROUTED_GROUPS):
            for k, p in enumerate(prompts[g]["follow"]):
                ref[("follow", g, k)] = ref_one(p)
        for g in range(ROUTED_GROUPS):
            ref[("last", g, 0)] = ref_one(prompts[g]["last"])

        # the routed graph comes up
        wids = {}
        for w in ("worker0", "worker1"):
            line = procs.wait_line(w, "READY", ROUTED_READY_S)
            wids[w] = int(line.rsplit(" ", 1)[-1], 16)
            gib = [ln for ln in procs.text(w).splitlines()
                   if "device memory after bring-up" in ln]
            report.setdefault("bring_up", {})[w] = {
                "worker": f"{wids[w]:x}",
                "gib_reserved": float(gib[0].split(": ")[-1].split()[0])
                if gib else None}
        line = procs.wait_line("processor", "READY", ROUTED_READY_S)
        pport = int(line.rsplit(":", 1)[-1].split("/")[0])
        report["bring_up"]["s"] = time.monotonic() - t0
        by_id = {v: k for k, v in wids.items()}

        decisions: list = []
        obs: dict = {}

        async def observe():
            rt = await DistributedRuntime.connect(addr)
            ep = Endpoint.parse_path(rt, ROUTED_ENDPOINT)
            client = await ep.client().start()
            await client.wait_for_instances(timeout=ROUTED_READY_S)
            sub = await ep.parent_component().subscribe_event(
                KV_HIT_RATE_SUBJECT)

            async def pump():
                async for msg in sub:
                    decisions.append(json.loads(msg.payload))
            obs.update(rt=rt, client=client, sub=sub,
                       task=asyncio.get_running_loop().create_task(pump()))
        on_loop(obs_loop, observe(), ROUTED_READY_S)

        def stats() -> dict:
            return on_loop(obs_loop, obs["client"].collect_stats(), 60)

        def wait_idle(want_decode: dict) -> dict:
            """Poll the workers' published stats until every live worker
            is idle and has decoded ``want_decode[wid]`` tokens at least;
            then wait for the processor's next scrape."""
            deadline = time.monotonic() + 120
            while True:
                st = stats()
                if all(w in st and st[w]["request_active_slots"] == 0
                       and st[w]["kv_active_blocks"] == 0
                       and st[w]["decode_tokens_total"] >= n
                       for w, n in want_decode.items()):
                    time.sleep(ROUTED_SCRAPE_S)
                    return st
                if time.monotonic() > deadline:
                    raise RuntimeError(f"10: workers not idle: {st}")
                time.sleep(0.05)

        def next_decision(n0: int, timeout: float = 60) -> dict:
            deadline = time.monotonic() + timeout
            while len(decisions) <= n0:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"10: no kv_hit_rate event after "
                                       f"{n0} (the router dispatched at "
                                       f"random?)")
                time.sleep(0.01)
            return decisions[n0]

        def one(prompt, n=ROUTED_TOKENS, on_event=None):
            return routed_stream(http_request(
                pport, "/v1/completions", routed_body(name, prompt, n),
                on_event=on_event))

        def together(kind: str, n_tokens: int,
                     progress: Optional[dict] = None) -> tuple:
            """Send each group's ``kind`` request, the next as soon as the
            router decided the one before (all in flight together, each
            decision known); (results, worker by group, end times, the
            threads). ``progress[g]`` counts the events of stream g."""
            res, ends, on = {}, {}, {}

            def send(g):
                def seen(ev):
                    progress[g] = progress.get(g, 0) + 1
                res[g] = one(prompts[g][kind], n_tokens,
                             on_event=seen if progress is not None
                             else None)
                ends[g] = time.monotonic()
            threads = []
            n0 = len(decisions)
            for g in range(ROUTED_GROUPS):
                th = threading.Thread(target=send, args=(g,), daemon=True)
                th.start()
                threads.append(th)
                on[g] = next_decision(n0 + g)["worker_id"]
            return res, on, ends, threads

        got = {}
        # (a) the seeds, together, once the processor's router has scraped
        # both workers' stats (before that it has no endpoint to weigh and
        # dispatches at random, with no decision)
        with phase("10a"):
            wait_idle({w: 0 for w in wids.values()})
            res, holders, _, threads = together("seed", ROUTED_TOKENS)
            for th in threads:
                th.join(300)
            for g in range(ROUTED_GROUPS):
                got[("seed", g, 0)] = res[g]
        # check 1: both workers serve a group
        seeds_on = {g: by_id[w] for g, w in holders.items()}
        log(f"10 check 1 {json.dumps({'groups_by_worker': seeds_on})} "
            f"[{card}]")
        if set(seeds_on.values()) != set(wids):
            raise RuntimeError(f"10 check 1: the groups by worker "
                               f"{seeds_on}")
        # (b) the follow-ups, one at a time
        decode = {w: (ROUTED_TOKENS - 1) * sum(h == w for h in
                                               holders.values())
                  for w in wids.values()}
        with phase("10b"):
            st = wait_idle(decode)
            for g in range(ROUTED_GROUPS):
                for k, p in enumerate(prompts[g]["follow"]):
                    hits0 = {w: st[w]["prefix_hit_blocks_total"]
                             for w in wids.values()}
                    n0 = len(decisions)
                    got[("follow", g, k)] = r = one(p)
                    d = next_decision(n0)
                    w = d["worker_id"]
                    decode = {x: st[x]["decode_tokens_total"]
                              + (ROUTED_TOKENS - 1 if x == w else 0)
                              for x in wids.values()}
                    st = wait_idle(decode)
                    grew = {x: st[x]["prefix_hit_blocks_total"] - hits0[x]
                            for x in wids.values()}
                    fig = {"group": g, "follow_up": k,
                           "worker": by_id[w], "holder": by_id[holders[g]],
                           "overlap_blocks": d["overlap_blocks"],
                           "isl_blocks": d["isl_blocks"],
                           "prefix_hits_grew": {by_id[x]: v
                                                for x, v in grew.items()},
                           "ttft_ms": r["ttft_ms"]}
                    log(f"10 check 2 {json.dumps(fig)} [{card}]")
                    if (w != holders[g]
                            or d["overlap_blocks"] != ROUTED_PREFIX_BLOCKS
                            or grew[w] != ROUTED_PREFIX_BLOCKS
                            or any(v for x, v in grew.items() if x != w)):
                        raise RuntimeError(f"10 check 2: {fig}")
        seed_ttft = [got[("seed", g, 0)]["ttft_ms"]
                     for g in range(ROUTED_GROUPS)]
        follow_ttft = [got[("follow", g, k)]["ttft_ms"]
                       for g in range(ROUTED_GROUPS)
                       for k in range(ROUTED_FOLLOW_UPS)]
        report["ttft_ms"] = {"seeds": seed_ttft, "follow_ups": follow_ttft,
                             "seeds_mean": sum(seed_ttft) / len(seed_ttft),
                             "follow_ups_mean": sum(follow_ttft)
                             / len(follow_ttft)}
        log(f"10 ttft {json.dumps(report['ttft_ms'])} [{card}]")

        # (c) four streams, then SIGTERM to the first one's worker
        with phase("10c"):
            progress: dict = {}
            cut_res, cut_on, cut_end, threads = together(
                "cut", ROUTED_CUT_TOKENS, progress)
            # every stream is streaming (a few tokens in), and the
            # workers' stats (published each second) hold their launches
            deadline = time.monotonic() + 300
            while (len(progress) < ROUTED_GROUPS
                   or min(progress.values()) < 4):
                if (time.monotonic() > deadline
                        or any(not t.is_alive() for t in threads)):
                    raise RuntimeError(f"10c: the streams did not start: "
                                       f"{progress}")
                time.sleep(0.01)
            time.sleep(ROUTED_SCRAPE_S)
            victim = cut_on[0]
            survivor = next(w for w in wids.values() if w != victim)
            st = stats()
            launches = {by_id[w]: dict(st[w]["kernel_launches"])
                        for w in wids.values()}
            procs.signal(by_id[victim], signal.SIGTERM)
            t_kill = time.monotonic()
            on_victim = [g for g, w in cut_on.items() if w == victim]
            # the lost worker's key goes, and the processor prunes its
            # blocks from the router's index
            ep = Endpoint.parse_path(obs["rt"], ROUTED_ENDPOINT)
            while True:
                keys = on_loop(obs_loop, obs["rt"].store.kv_get_prefix(
                    ep.discovery_prefix()), 60)
                if not any(k.key.endswith(f":{victim:x}") for k in keys):
                    break
                if time.monotonic() - t_kill > ROUTED_GONE_S:
                    raise RuntimeError("10 check 4: the lost worker's key "
                                       "is still there")
                time.sleep(0.05)
            gone_s = time.monotonic() - t_kill
            pruned = []
            while not pruned:
                pruned = [ln for ln in procs.text("processor").splitlines()
                          if f"worker {victim:x} gone" in ln]
                if time.monotonic() - t_kill > ROUTED_GONE_S:
                    break
                time.sleep(0.05)
            for th in threads:
                th.join(300)
            ended = {g: {"worker": by_id[cut_on[g]],
                         "error": cut_res.get(g, {}).get("error"),
                         "tokens": len(cut_res.get(g, {}).get("tokens", [])),
                         "ended_s_after_kill": cut_end[g] - t_kill
                         if g in cut_end else None}
                     for g in range(ROUTED_GROUPS)}
            err_s = max((cut_end.get(g, float("inf")) - t_kill
                         for g in on_victim), default=float("inf"))
            fig = {"victim": by_id[victim], "key_gone_s": gone_s,
                   "streams": ended, "error_within_s": err_s,
                   "pruned": pruned[0].split(": ", 1)[-1] if pruned
                   else None}
            log(f"10 check 4 {json.dumps(fig)} [{card}]")
            if (not on_victim or any(t.is_alive() for t in threads)
                    or not pruned or not pruned[0].endswith("(0 left)")
                    or err_s > ROUTED_ERROR_S):
                raise RuntimeError(f"10 check 4: {fig}")
            for g in range(ROUTED_GROUPS):
                r = cut_res[g]
                if cut_on[g] == victim and not r["error"]:
                    raise RuntimeError(f"10 check 4: stream {g} on the "
                                       f"lost worker ended without an "
                                       f"error: {r['finish']}")
                if cut_on[g] != victim and (r["error"]
                                            or r["finish"] != "length"):
                    raise RuntimeError(f"10 check 4: stream {g} on the "
                                       f"survivor: {r}")
        # (d) four more requests, once the processor scraped without the
        # lost worker: all on the survivor
        time.sleep(ROUTED_SCRAPE_S)
        with phase("10d"):
            for g in range(ROUTED_GROUPS):
                n0 = len(decisions)
                got[("last", g, 0)] = r = one(prompts[g]["last"])
                w = next_decision(n0)["worker_id"]
                if w != survivor or r["finish"] != "length":
                    raise RuntimeError(f"10 check 4: request {g} after the "
                                       f"loss went to {by_id.get(w, w)}: "
                                       f"{r['finish']}")
            log(f"10 check 4 after {json.dumps({'all_on': by_id[survivor], 'n': ROUTED_GROUPS})} [{card}]")

        # (3) every finished stream against the reference
        with phase("10e"):
            parted, reader = [], None
            for key, r in got.items():
                want = ref[key]
                if r["error"] or r["finish"] != "length" or \
                        len(r["tokens"]) != ROUTED_TOKENS:
                    raise RuntimeError(f"10 check 3: {key} {r}")
                if r["tokens"] == want["tokens"]:
                    continue
                first = next(i for i, (a, b) in enumerate(
                    zip(r["tokens"], want["tokens"])) if a != b)
                if reader is None:
                    reader = GapReader(ref_core.params, cfg, dev, kv_quant,
                                       ROUTED_PREFIX_BLOCKS * KV_BLOCK
                                       + ROUTED_SUFFIX[1] + ROUTED_TOKENS)
                kind, g, k = key
                prompt = (prompts[g]["seed"] if kind == "seed" else
                          prompts[g]["follow"][k] if kind == "follow"
                          else prompts[g]["last"])
                ids = recorder.ids[want["request_id"]]
                gap = reader([prompt], [ids])[0][first]
                parted.append({"request": list(key), "at": first,
                               "gap": gap})
                if not gap < SPEC_NEAR_TIE:
                    raise RuntimeError(f"10 check 3: {key} parts from the "
                                       f"reference at token {first}, gap "
                                       f"{gap} (limit {SPEC_NEAR_TIE})")
            fig = {"streams": len(got), "equal": len(got) - len(parted),
                   "parted_at_near_ties": parted}
            log(f"10 check 3 {json.dumps(fig)} [{card}]")

        # (5) each worker's launches: the victim's last published counts,
        # the survivor's from its log at stop
        procs.stop(["processor", by_id[survivor]])
        final = [ln for ln in procs.text(by_id[survivor]).splitlines()
                 if "kernel launches" in ln]
        if not final:
            raise RuntimeError(f"10 check 5: no launch counts in the "
                               f"survivor's log:\n"
                               f"{procs.text(by_id[survivor])[-2000:]}")
        launches[by_id[survivor]] = json.loads(
            final[-1].split("kernel launches ", 1)[1])
        total: dict = {}
        for w, counts in launches.items():
            log(f"10 check 5 routed launches {w}: {json.dumps(counts)} "
                f"[{card}]")
            for k in PATH_KERNELS[ROUTED_PATH]:
                if counts.get(k, 0) <= 0:
                    raise RuntimeError(f"10 check 5: {w} never launched "
                                       f"{k}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        report["s"] = time.monotonic() - t_phase
        log(f"10 routed {json.dumps({k: v for k, v in report.items()})} "
            f"[{card}]")
        return total, report
    except BaseException:
        log(procs.tails())
        raise
    finally:
        if "task" in obs:
            async def close_obs():
                obs["task"].cancel()
                obs["sub"].close()
                await obs["client"].close()
                await obs["rt"].shutdown()
            try:
                on_loop(obs_loop, close_obs(), 60)
            except Exception as e:  # noqa: BLE001 — shutdown goes on
                log(f"10: observer shutdown: {e}")
        obs_loop.call_soon_threadsafe(obs_loop.stop)
        obs_thread.join(30)
        procs.stop([n for n in procs.procs if n != "daemon"], 30)
        procs.stop(["daemon"], 30)
        if stop_ref is not None:
            stop_ref()
        tmp_ctx.cleanup()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 11. Disaggregated prefill and decode on the one card
# ---------------------------------------------------------------------------

DISAGG_MAX_LEN = 4096          # above the longest prompt and its tokens
DISAGG_PROMPTS = (600, 1400, 2200, 3000)    # 11a-11d, tokens each
DISAGG_LONG = (1500, 2000, 2500, 3000)      # 11e: prefilled remotely
DISAGG_SHORT = (40, 100, 180, 256)          # 11e: under the threshold
DISAGG_THRESHOLD = 512         # 11e's --max-local-prefill-length
DISAGG_TOKENS = 32
DISAGG_CUT_LAYERS = 8          # 11d: the layer stream dies after these
DISAGG_FALLBACK_S = 2.0        # 11d: prefill_timeout with no worker
DISAGG_WAIT_S = 120.0          # a remote prefill's timeout elsewhere
# the planes of 11a: DisaggEngine's arguments and the counter of each
DISAGG_PLANES = {
    "device": (dict(device_plane=True), "device_transfers"),
    "wire": (dict(device_plane=False, layer_stream=False), None),
    "wire_layers": (dict(device_plane=False, layer_stream=True),
                    "stream_transfers")}


def disagg_prompts(cfg, seed: int) -> dict:
    """Token-id prompts of the phase, from one seed (ids of the chat
    directory's vocab)."""
    import numpy as np
    rng = np.random.default_rng(seed + 200)
    hi = min(127000, cfg.vocab_size - 256)

    def ids(n):
        return rng.integers(min(1000, hi // 2), hi, size=n).tolist()
    return {"main": [ids(n) for n in DISAGG_PROMPTS],
            "long": [ids(n) for n in DISAGG_LONG],
            "short": [ids(n) for n in DISAGG_SHORT]}


def disagg_core(cfg, dev, params, **over):
    """An engine of the launcher's flags ``--quantization int4
    --kv-quantization int8 --num-kv-blocks 2048 --max-model-len 4096``
    over ``params``, with prefix reuse off (each plane re-sends the same
    prompts, which must cross whole)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    kw = dict(max_model_len=DISAGG_MAX_LEN, kv_block_size=KV_BLOCK,
              num_kv_blocks=2048, max_num_seqs=8, enable_prefix_reuse=False,
              quantization="int4", kv_quantization="int8")
    kw.update(over)
    return EngineCore(cfg, EngineConfig(**kw), params=params, device=dev)


def disagg_request(rid: str, prompt: list):
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       SamplingOptions,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.runtime.engine import EngineContext
    pre = PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=DISAGG_TOKENS,
                                       ignore_eos=True),
        sampling_options=SamplingOptions(greedy=True))
    return Context(pre, ctx=EngineContext(rid))


async def disagg_serve(engine, prompts: list, tag: str) -> list:
    """Each prompt's greedy token ids through ``engine`` (a TorchEngine or
    a DisaggEngine), all sent together."""
    import asyncio

    async def one(i, p):
        stream = await engine.generate(disagg_request(f"{tag}-{i}", p))
        toks = []
        async for a in stream:
            if a.data is not None and a.data.token_ids:
                toks.extend(a.data.token_ids)
        return toks
    return list(await asyncio.gather(*(one(i, p)
                                       for i, p in enumerate(prompts))))


def launch_counts() -> dict:
    from dynamo_tpu_torch.engine import kernels
    return {k: v.launches for k, v in kernels.KERNELS.items()}


def count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def check_equal_streams(what: str, got: list, want: list) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != DISAGG_TOKENS or g != w:
            first = next((j for j, (a, b) in enumerate(zip(g, w))
                          if a != b), min(len(g), len(w)))
            raise RuntimeError(f"{what}: stream {i} ({len(g)} tokens) "
                               f"parts from the reference at token {first}")


def check_near_tie_streams(what: str, got: list, want: list, prompts: list,
                           reader: Callable) -> list:
    """Each stream of ``got`` equals ``want``'s, or parts from it where
    ``want``'s token was a near tie (its top-2 gap under SPEC_NEAR_TIE,
    read by ``reader()``, a GapReader built on the first parting). Returns
    the partings."""
    parted, gaps = [], None
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != DISAGG_TOKENS:
            raise RuntimeError(f"{what}: stream {i} has {len(g)} tokens")
        if g == w:
            continue
        first = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        gaps = gaps or reader()
        gap = gaps([prompts[i]], [w])[0][first]
        parted.append({"stream": i, "at": first, "gap": gap})
        if not gap < SPEC_NEAR_TIE:
            raise RuntimeError(f"{what}: stream {i} parts from the "
                               f"reference at token {first}, gap {gap} "
                               f"(limit {SPEC_NEAR_TIE})")
    return parted


def disagg_phase(cfg, dev, seed: int, card: str) -> dict:
    """Phase 11: disaggregated prefill and decode at the 8B width and
    depth, int4 weights + int8 KV, 2048 blocks of 16, phase 7's
    ``tokenizer.json`` directory, greedy 32-token streams with
    ``ignore_eos``.

    In one process (the engines share one seeded weight tree; prefix reuse
    off, so every prompt crosses whole): a local aggregated engine R (the
    reference), a prefill engine P behind a ``PrefillWorker`` and a decode
    engine D behind a ``DisaggEngine``, on one in-process runtime.
    (11a) four prompts of 600-3000 tokens over the device plane, the wire
    with the whole payload and the wire layer by layer: every stream equals
    R's bit for bit, D prefills nothing and launches no K1 (each plane's K1
    launches equal R's for the same prompts), no fallback, and each
    plane's counter counts 4; then the four prompts twice, all eight at
    once over the whole payload, R's streams. (11d) the rungs: with no
    prefill worker and a
    2 s timeout a request prefills locally with R's stream; a layer stream
    cut after 8 of 32 layers re-admits cold with R's stream; a short
    prompt under a threshold stays local; a threshold raised through the
    KV store moves a long prompt local. (11b) a bf16-KV prefill engine
    feeds D over the device plane (the cross-quant repack): R's streams,
    or parting at a near tie (``SPEC_NEAR_TIE``), and the repacked rows of
    one prompt equal R's in layer 0 (``cross_quant_rows``). (11c) a
    ``--ragged`` decode engine over the layer stream: a local ``--ragged``
    engine's streams or parting at a near tie, with K4 launched and no K1
    beyond P's; fed the same prefills as whole payloads, the same engine
    repeats its streams bit for bit. (11e) across
    processes, through the launcher: the port's daemon, ``in=none
    out=torch --is-prefill-worker`` and ``in=http out=torch
    --remote-prefill --max-local-prefill-length 512``; four prompts of
    1500-3000 tokens go remote and four of at most 256 stay local, one at
    a time; every stream equals R's (served over HTTP in this process,
    whose TTFT is each request's local twin), the worker did 4 prefills,
    the decode worker streamed 4 x 32 layers, and each worker's K1,
    K3-int8, K5 and K6 launches are those the split predicts. Printed: the
    wire's GB/s and each remote TTFT beside its twin's (no claim).
    Returns {path: (launch counts, report)} for DISAGG_PATHS."""
    import asyncio
    import tempfile
    import threading
    import torch
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.llm.kv.native_pool import load_native_pool_lib

    t_phase = time.monotonic()
    load_native_pool_lib()          # built once, before any worker starts
    name = "llama3-8b-disagg"
    tmp_ctx = tempfile.TemporaryDirectory(prefix="dtt-disagg-")
    model_dir = os.path.join(tmp_ctx.name, name)
    write_chat_model_dir(model_dir, cfg)
    mcfg = ModelConfig.from_model_dir(model_dir)
    prompts = disagg_prompts(mcfg, seed)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="disagg-loop",
                              daemon=True)
    thread.start()
    cores: dict = {}    # the in-process engines, by name
    aux: dict = {}      # 11a's runtime and prefill worker
    report: dict = {}
    out: dict = {}
    try:
        params = init_params_quantized(mcfg, seed, dev, torch.bfloat16,
                                       include_embed=True, bits=4)
        with phase("11a"):
            ref = disagg_planes(mcfg, dev, params, prompts, cores, aux,
                                loop, report, out, card)
        with phase("11d"):
            disagg_rungs(mcfg, prompts, ref, cores, aux, loop, report, card)
        on_loop(loop, aux.pop("worker").stop())
        on_loop(loop, aux.pop("rt").shutdown())
        with phase("11b"):
            disagg_cross_quant(mcfg, dev, params, prompts, ref, cores,
                               loop, report, card)
        with phase("11c"):
            disagg_ragged(mcfg, dev, params, prompts, cores, loop, report,
                          out, card)
        with phase("11e"):
            disagg_processes(mcfg, dev, seed, model_dir, name, prompts,
                             cores, loop, report, card)
        report["s"] = time.monotonic() - t_phase
        log(f"11 disagg {json.dumps(report)} [{card}]")
        return {p: (out[p], report) for p in DISAGG_PATHS}
    finally:
        stops = ([aux["worker"].stop()] if "worker" in aux else []) \
            + ([aux["rt"].shutdown()] if "rt" in aux else []) \
            + [c.stop() for c in cores.values()]
        for coro in stops:
            try:
                on_loop(loop, coro, 120)
            except Exception as e:  # noqa: BLE001 — shutdown goes on
                log(f"11: shutdown: {e}")
        cores.clear()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        tmp_ctx.cleanup()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def drop_core(cores: dict, key: str, loop) -> None:
    """Stop one of the phase's engines and give its memory back."""
    import torch
    core = cores.pop(key)
    on_loop(loop, core.stop(), 120)
    del core
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def disagg_planes(cfg, dev, params, prompts, cores, aux, loop, report, out,
                  card) -> dict:
    """11a. Returns R's reference streams by prompt group."""
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.llm.disagg import (DisaggEngine,
                                             DisaggregatedRouter,
                                             PrefillWorker)
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    for key in ("R", "P", "D"):
        cores[key] = disagg_core(cfg, dev, params)
    R, P, D = cores["R"], cores["P"], cores["D"]
    ptrs = {k: v.data_ptr() for k, v in D.kv.items()}
    # the references (and R's K1 launches for the four main prompts)
    c0 = launch_counts()
    ref = {"main": on_loop(loop, disagg_serve(TorchEngine(R),
                                              prompts["main"], "ref"))}
    ref_k1 = count_delta(launch_counts(), c0)["flash_prefill"]
    ref["short"] = on_loop(loop, disagg_serve(TorchEngine(R),
                                              prompts["short"], "ref-short"))
    if ref_k1 != len(DISAGG_PROMPTS) * cfg.num_layers:
        raise RuntimeError(f"11a: R's four prefills launched K1 {ref_k1} "
                           f"times, not {len(DISAGG_PROMPTS)} x "
                           f"{cfg.num_layers}")
    rt = aux["rt"] = DistributedRuntime.in_process()
    worker = aux["worker"] = on_loop(loop, PrefillWorker(P, rt).start())
    planes = {}
    kernels.reset_launch_counts()
    for plane, (kw, counter) in DISAGG_PLANES.items():
        router = DisaggregatedRouter(rt, "llama3", conditional=False)
        eng = DisaggEngine(D, rt, router, prefill_timeout=DISAGG_WAIT_S,
                           **kw)
        c0, w0 = launch_counts(), dict(worker.stats())
        t0 = time.monotonic()
        got = on_loop(loop, disagg_serve(eng, prompts["main"], plane))
        wall = time.monotonic() - t0
        d = count_delta(launch_counts(), c0)
        st = eng.stats()
        fig = {"plane": plane, "wall_s": wall, "engine": st,
               "worker": {k: v - w0.get(k, 0)
                          for k, v in worker.stats().items()
                          if k != "inflight"},
               "k1_launches": d["flash_prefill"], "reference_k1": ref_k1,
               "decode_prefill_tokens": D.total_prefill_tokens}
        log(f"11a {json.dumps(fig)} [{card}]")
        check_equal_streams(f"11a {plane}", got, ref["main"])
        n = len(DISAGG_PROMPTS)
        if (st["remote_prefills"] != n or st["remote_failures"]
                or st["local_prefills"]
                or (counter is not None and st[counter] != n)
                or D.total_prefill_tokens != 0
                or d["flash_prefill"] != ref_k1):
            raise RuntimeError(f"11a {plane}: {fig}")
        planes[plane] = fig
    out[DISAGG_PATH] = launch_counts()
    planes["wire_burst"] = disagg_burst(D, rt, prompts, ref, loop, card)
    if {k: v.data_ptr() for k, v in D.kv.items()} != ptrs:
        raise RuntimeError("11a: the decode pool was rebound")
    report["11a"] = planes
    for k in PATH_KERNELS[DISAGG_PATH]:
        if out[DISAGG_PATH].get(k, 0) <= 0:
            raise RuntimeError(f"11a: {k} never launched on the "
                               f"disaggregated path")
    return ref


def disagg_burst(D, rt, prompts, ref, loop, card) -> dict:
    """11a's burst: each main prompt twice, all eight at once over the
    whole wire payload, so that staging copies on D's tier stream run
    while D's compute stream still scatters and decodes the others (a
    staged payload freed before its scatter ran would be overwritten
    here). Every stream equals R's bit for bit."""
    from dynamo_tpu_torch.llm.disagg import (DisaggEngine,
                                             DisaggregatedRouter)
    kw, _ = DISAGG_PLANES["wire"]
    eng = DisaggEngine(D, rt, DisaggregatedRouter(rt, "llama3",
                                                  conditional=False),
                       prefill_timeout=DISAGG_WAIT_S, **kw)
    t0 = time.monotonic()
    got = on_loop(loop, disagg_serve(eng, prompts["main"] * 2, "burst"))
    fig = {"plane": "wire_burst", "requests": len(got),
           "wall_s": time.monotonic() - t0, "engine": eng.stats(),
           "decode_prefill_tokens": D.total_prefill_tokens}
    log(f"11a {json.dumps(fig)} [{card}]")
    check_equal_streams("11a wire burst", got, ref["main"] * 2)
    st = fig["engine"]
    if (st["remote_prefills"] != len(got) or st["remote_failures"]
            or st["local_prefills"] or D.total_prefill_tokens != 0):
        raise RuntimeError(f"11a wire burst: {fig}")
    return fig


def disagg_rungs(cfg, prompts, ref, cores, aux, loop, report,
                 card) -> None:
    """11d. The fallback without a prefill worker, the cold rung after a
    cut layer stream, a short prompt under the threshold, and a threshold
    raised through the KV store."""
    import asyncio
    import json as _json
    from dynamo_tpu_torch.llm import disagg as tdisagg
    from dynamo_tpu_torch.llm.disagg import (DisaggEngine,
                                             DisaggregatedRouter)
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    D, rt = cores["D"], aux["rt"]
    # the layer stream dies after DISAGG_CUT_LAYERS layers (half the
    # layers of a shallower model)
    n_cut = min(DISAGG_CUT_LAYERS, cfg.num_layers // 2)
    figs = {}
    # (1) no prefill worker: a runtime whose queue nobody pulls
    lone = DistributedRuntime.in_process()
    eng = DisaggEngine(D, lone, DisaggregatedRouter(lone, "llama3",
                                                    conditional=False),
                       prefill_timeout=DISAGG_FALLBACK_S)
    t0 = time.monotonic()
    got = on_loop(loop, disagg_serve(eng, prompts["main"][:1], "fallback"))
    figs["no_worker"] = {"wall_s": time.monotonic() - t0, **eng.stats()}
    on_loop(loop, lone.shutdown())
    check_equal_streams("11d no worker", got, ref["main"][:1])
    if eng.remote_failures != 1 or eng.local_prefills != 1:
        raise RuntimeError(f"11d no worker: {figs['no_worker']}")
    # (2) the layer stream dies after n_cut layers: the prefill worker's
    # sender holds the layer frames until the decode engine has admitted
    # against the manifest, and fails at the next one once those have
    # been scattered
    real = tdisagg.open_stream_sender
    sent = {"layers": 0}

    async def cutting(conn, timeout):
        sender = await real(conn, timeout=timeout)
        send = sender.send

        async def cut(data, header=b""):
            h = _json.loads(header) if header else {}
            if h.get("stream") == "kv_layer":
                while D.disagg_stream_admits < admits0 + 1:
                    await asyncio.sleep(0.001)
                if sent["layers"] >= n_cut:
                    # once the decode engine has scattered what was sent
                    while (D.disagg_stream_layers_scattered
                           < layers0 + n_cut):
                        await asyncio.sleep(0.001)
                    raise ConnectionResetError("layer stream cut")
                sent["layers"] += 1
            await send(data, header=header)
        sender.send = cut
        return sender
    admits0, fb0 = D.disagg_stream_admits, D.disagg_stream_fallbacks
    layers0, pf0 = D.disagg_stream_layers_scattered, D.total_prefill_tokens
    tdisagg.open_stream_sender = cutting
    try:
        eng = DisaggEngine(D, rt, DisaggregatedRouter(rt, "llama3",
                                                      conditional=False),
                           prefill_timeout=DISAGG_WAIT_S, device_plane=False,
                           layer_stream=True)
        got = on_loop(loop, disagg_serve(eng, prompts["main"][:1], "cut"))
    finally:
        tdisagg.open_stream_sender = real
    figs["cut"] = {"layers_scattered": D.disagg_stream_layers_scattered
                   - layers0,
                   "fallbacks": D.disagg_stream_fallbacks - fb0,
                   "recomputed_tokens": D.total_prefill_tokens - pf0}
    check_equal_streams("11d cut stream", got, ref["main"][:1])
    if figs["cut"] != {"layers_scattered": n_cut,
                       "fallbacks": 1,
                       "recomputed_tokens": len(prompts["main"][0])}:
        raise RuntimeError(f"11d cut stream: {figs['cut']}")
    # (3) a short prompt under the threshold, (4) the threshold raised
    # through the KV store moves a long prompt local
    router = DisaggregatedRouter(rt, "llama3",
                                 max_local_prefill_length=DISAGG_THRESHOLD)
    on_loop(loop, router.start())
    try:
        eng = DisaggEngine(D, rt, router, prefill_timeout=DISAGG_WAIT_S)
        got = on_loop(loop, disagg_serve(eng, prompts["short"][:1], "short"))
        check_equal_streams("11d short", got, ref["short"][:1])
        figs["short"] = dict(eng.stats())
        if eng.local_prefills != 1 or eng.remote_prefills:
            raise RuntimeError(f"11d short: {figs['short']}")
        on_loop(loop, router.publish_threshold(DISAGG_MAX_LEN))
        deadline = time.monotonic() + 30
        while router.max_local_prefill_length != DISAGG_MAX_LEN:
            if time.monotonic() > deadline:
                raise RuntimeError("11d: the threshold never arrived")
            time.sleep(0.01)
        got = on_loop(loop, disagg_serve(eng, prompts["main"][-1:],
                                         "raised"))
        check_equal_streams("11d raised", got, ref["main"][-1:])
        figs["raised"] = dict(eng.stats())
        if eng.local_prefills != 2 or eng.remote_prefills:
            raise RuntimeError(f"11d raised threshold: {figs['raised']}")
    finally:
        on_loop(loop, router.stop())
    log(f"11d {json.dumps(figs)} [{card}]")
    report["11d"] = figs


def disagg_cross_quant(cfg, dev, params, prompts, ref, cores, loop, report,
                       card) -> None:
    """11b. A bf16-KV prefill engine feeds the int8-KV decode engine over
    the device plane: R's streams, or parting at a near tie."""
    from dynamo_tpu_torch.llm.disagg import (DisaggEngine,
                                             DisaggregatedRouter,
                                             PrefillWorker)
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drop_core(cores, "P", loop)
    cores["P16"] = disagg_core(cfg, dev, params, kv_quantization="none")
    D = cores["D"]
    rt = DistributedRuntime.in_process()
    worker = on_loop(loop, PrefillWorker(cores["P16"], rt).start())
    try:
        eng = DisaggEngine(D, rt, DisaggregatedRouter(rt, "llama3",
                                                      conditional=False),
                           prefill_timeout=DISAGG_WAIT_S, device_plane=True)
        pf0 = D.total_prefill_tokens
        got = on_loop(loop, disagg_serve(eng, prompts["main"], "xq"))
    finally:
        on_loop(loop, worker.stop())
        on_loop(loop, rt.shutdown())
    st = eng.stats()
    if (st["device_transfers"] != len(DISAGG_PROMPTS)
            or st["remote_failures"] or D.total_prefill_tokens != pf0):
        raise RuntimeError(f"11b: {st}")
    parted = check_near_tie_streams(
        "11b", got, ref["main"], prompts["main"],
        lambda: GapReader(D.params, cfg, dev, "int8",
                          max(DISAGG_PROMPTS) + DISAGG_TOKENS))
    fig = {"engine": st, "equal": len(got) - len(parted),
           "parted_at_near_ties": parted,
           "rows": cross_quant_rows(cores["R"], cores["P16"], D,
                                    prompts["main"][0], loop)}
    log(f"11b {json.dumps(fig)} [{card}]")
    report["11b"] = fig
    drop_core(cores, "P16", loop)


def device_gather(core, rid: str, prompt: list, loop):
    """``prompt``'s KV as ``core`` hands it off over the device plane
    (its prefill, then the gather of the prompt's blocks): a
    DeviceKvPayload."""
    import asyncio
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    from dynamo_tpu_torch.llm.kv_transport import DeviceKvPayload

    async def run():
        fut = asyncio.get_running_loop().create_future()

        async def handoff(tok, logprob, dev, hashes):
            stacked = dev["stacked"]
            fut.set_result(DeviceKvPayload(
                request_id=rid, first_token=tok, first_logprob=logprob,
                seq_hashes=hashes, stacked=dict(stacked),
                n_blocks=dev["n_blocks"], block_size=core.cfg.kv_block_size,
                ready=getattr(stacked, "ready", None)))
        req = EngineRequest(rid=rid, prompt=list(prompt),
                            sampling=SlotSampling(temperature=0.0),
                            max_new_tokens=1, eos_ids=frozenset(),
                            handoff=handoff, handoff_device=True)
        await core.submit(req)
        while (await req.out_queue.get())[0] is not FINISH_SENTINEL:
            pass
        return await asyncio.wait_for(fut, DISAGG_WAIT_S)
    return on_loop(loop, run())


def cross_quant_rows(local8, src16, dst8, prompt: list, loop) -> dict:
    """11b's cause, read on one prompt: the int8 rows the local int8-KV
    engine writes for it against ``dst8``'s repack of the rows the bf16-KV
    engine writes. Layer 0's K/V are the same bf16 values in both engines
    and quantize to the same bytes; from layer 1 on they part, since each
    prefill's attention read its own pool (the int8 engine its rows
    dequantized, the bf16 engine bf16 rows). Fails unless layer 0 is
    equal bit for bit. Returns each layer's share of differing bytes over
    the prompt's rows (K and V together)."""
    import torch
    a = device_gather(local8, "xq-rows-int8", prompt, loop)
    if a.ready is not None:
        a.ready.synchronize()       # the gather ran on the engine's stream
    b = dst8._repack_kv_payload(device_gather(src16, "xq-rows-bf16",
                                              prompt, loop))
    n = len(prompt)
    diff = 0
    for k in a.stacked:
        x, y = a.stacked[k], b.stacked[k]
        L, C = x.shape[0], x.shape[-1]
        x = x.reshape(L, -1, C)[:, :n]
        y = y.reshape(L, -1, C)[:, :n].to(x.device)
        diff = diff + (x != y).float().mean(dim=(1, 2)) / len(a.stacked)
    share = diff.tolist()
    if share[0] != 0.0:
        raise RuntimeError(f"11b: layer 0's repacked rows differ from the "
                           f"local int8 engine's in {share[0]} of bytes")
    return {"differing_share_by_layer": share,
            "layers_equal": sum(v == 0.0 for v in share)}


def disagg_ragged(cfg, dev, params, prompts, cores, loop, report, out,
                  card) -> None:
    """11c. A --ragged decode engine over the wire layer stream."""
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.llm.disagg import (DisaggEngine,
                                             DisaggregatedRouter,
                                             PrefillWorker)
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    drop_core(cores, "D", loop)
    ragged = dict(ragged_dispatch=True, ragged_max_seq_rows=RAGGED_MAX_ROWS)
    cores["P"] = disagg_core(cfg, dev, params)
    cores["RR"] = disagg_core(cfg, dev, params, **ragged)
    cores["DR"] = disagg_core(cfg, dev, params, **ragged)
    want = on_loop(loop, disagg_serve(TorchEngine(cores["RR"]),
                                      prompts["main"], "ref-ragged"))
    drop_core(cores, "RR", loop)
    # P's K1 launches for these prompts: those of R's prefills in 11a
    k1 = len(DISAGG_PROMPTS) * cfg.num_layers
    rt = DistributedRuntime.in_process()
    worker = on_loop(loop, PrefillWorker(cores["P"], rt).start())
    DR = cores["DR"]
    try:
        eng = DisaggEngine(DR, rt, DisaggregatedRouter(rt, "llama3",
                                                       conditional=False),
                           prefill_timeout=DISAGG_WAIT_S, device_plane=False,
                           layer_stream=True)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        got = on_loop(loop, disagg_serve(eng, prompts["main"], "ragged"))
        wall = time.monotonic() - t0
        out[DISAGG_RAGGED_PATH] = launch_counts()
    finally:
        on_loop(loop, worker.stop())
        on_loop(loop, rt.shutdown())
    c = out[DISAGG_RAGGED_PATH]
    fig = {"wall_s": wall, "engine": eng.stats(),
           "ragged_dispatches": DR.ragged_dispatches,
           "stream_layers": DR.disagg_stream_layers_scattered,
           "k1_launches": c["flash_prefill"],
           "k4_launches": c["ragged_paged_attention_int8"]}
    # the local --ragged engine prefills through K4 in row chunks, the
    # prefill engine through K1: their KV may differ in the last bits, so
    # a stream may part from the local one at a near tie
    fig["parted_at_near_ties"] = check_near_tie_streams(
        "11c", got, want, prompts["main"],
        lambda: GapReader(DR.params, cfg, dev, "int8",
                          max(DISAGG_PROMPTS) + DISAGG_TOKENS))
    n = len(DISAGG_PROMPTS)
    if (fig["engine"]["stream_transfers"] != n
            or fig["engine"]["remote_failures"]
            or DR.total_prefill_tokens != 0
            or c["flash_prefill"] != k1
            or c["paged_attention_int8"] != 0
            or DR.disagg_stream_layers_scattered != n * cfg.num_layers):
        log(f"11c {json.dumps(fig)} [{card}]")
        raise RuntimeError(f"11c: {fig}")
    # the same prefills' KV (P's K1, the same bits) into the same engine as
    # whole payloads: any difference from the layer-streamed streams is
    # the stream's scatter's
    rt = DistributedRuntime.in_process()
    worker = on_loop(loop, PrefillWorker(cores["P"], rt).start())
    try:
        whole = DisaggEngine(DR, rt, DisaggregatedRouter(
            rt, "llama3", conditional=False), prefill_timeout=DISAGG_WAIT_S,
            device_plane=False, layer_stream=False)
        got_whole = on_loop(loop, disagg_serve(whole, prompts["main"],
                                               "ragged-whole"))
    finally:
        on_loop(loop, worker.stop())
        on_loop(loop, rt.shutdown())
    fig["whole_payload"] = whole.stats()
    log(f"11c {json.dumps(fig)} [{card}]")
    check_equal_streams("11c layer stream against whole payloads", got,
                        got_whole)
    if (whole.remote_prefills != n or whole.remote_failures
            or DR.total_prefill_tokens != 0):
        raise RuntimeError(f"11c whole payloads: {fig['whole_payload']}")
    for k in PATH_KERNELS[DISAGG_RAGGED_PATH]:
        if c.get(k, 0) <= 0:
            raise RuntimeError(f"11c: {k} never launched")
    report["11c"] = fig
    drop_core(cores, "DR", loop)
    drop_core(cores, "P", loop)


def disagg_processes(cfg, dev, seed, model_dir, name, prompts, cores, loop,
                     report, card) -> None:
    """11e. The daemon, a prefill worker and a --remote-prefill decode
    worker as processes of their own; R serves the same requests over
    HTTP in this process."""
    import signal
    import socket
    from dynamo_tpu_torch.launch import run as launcher
    from dynamo_tpu_torch.llm.engines.torch_engine import TorchEngine
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    procs = RoutedProcs(model_dir + "-logs", tag="11e")
    os.makedirs(procs.tmp, exist_ok=True)
    svc = None
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dport = s.getsockname()[1]
        addr = f"127.0.0.1:{dport}"
        procs.start("daemon", "dynamo_tpu_torch.runtime.server", "--host",
                    "127.0.0.1", "--port", str(dport))
        procs.wait_line("daemon", "dynamo-tpu-torch discovery", 60)
        common = ["out=torch", "--random-weights", "--quantization", "int4",
                  "--kv-quantization", "int8", "--model-path", model_dir,
                  "--model-name", name, "--runtime-server", addr,
                  "--max-model-len", str(DISAGG_MAX_LEN), "--kv-block-size",
                  str(KV_BLOCK), "--num-kv-blocks", "2048",
                  "--max-num-seqs", "8", "--device", dev.type]
        t0 = time.monotonic()
        procs.start("prefill", "dynamo_tpu_torch.launch.run", "in=none",
                    *common, "--is-prefill-worker")
        procs.start("decode", "dynamo_tpu_torch.launch.run", "in=http",
                    *common, "--remote-prefill",
                    "--max-local-prefill-length", str(DISAGG_THRESHOLD),
                    "--http-host", "127.0.0.1", "--http-port", "0")
        # R over HTTP: the twin of every request
        mdc = ModelDeploymentCard.from_local_path(model_dir,
                                                  display_name=name)

        async def start_twin():
            s = HttpService(port=0, host="127.0.0.1")
            pipe = launcher.link_pipeline(TorchEngine(cores["R"]), mdc)
            s.manager.add_completion_model(name, pipe)
            await s.start()
            return s
        svc = on_loop(loop, start_twin())
        procs.wait_line("prefill", "READY", ROUTED_READY_S)
        line = procs.wait_line("decode", "READY", ROUTED_READY_S)
        dport_http = int(line.rsplit(":", 1)[-1].split("/")[0])
        bring_up = {"s": time.monotonic() - t0}
        for w in ("prefill", "decode"):
            gib = [ln for ln in procs.text(w).splitlines()
                   if "device memory after bring-up" in ln]
            bring_up[w] = (float(gib[0].split(": ")[-1].split()[0])
                           if gib else None)
        rows = []
        for group in ("long", "short"):
            for i, p in enumerate(prompts[group]):
                body = routed_body(name, p, DISAGG_TOKENS)
                got = routed_stream(http_request(dport_http,
                                                 "/v1/completions", body))
                twin = routed_stream(http_request(svc.port,
                                                  "/v1/completions", body))
                rows.append({"group": group, "prompt": len(p),
                             "ttft_ms": got["ttft_ms"],
                             "twin_ttft_ms": twin["ttft_ms"],
                             "equal": got["tokens"] == twin["tokens"],
                             "finish": got["finish"]})
                if (got["error"] or got["finish"] != "length"
                        or len(got["tokens"]) != DISAGG_TOKENS
                        or got["tokens"] != twin["tokens"]):
                    raise RuntimeError(f"11e: {group} {i}: {rows[-1]}")
        procs.stop(["decode", "prefill"])
        stats = {}
        for w, key in (("prefill", "prefill worker stats"),
                       ("decode", "disagg stats")):
            text = procs.text(w)
            lines = [ln for ln in text.splitlines() if key in ln]
            launches = [ln for ln in text.splitlines()
                        if "kernel launches" in ln]
            if not lines or not launches:
                raise RuntimeError(f"11e: no {key!r} or launch counts in "
                                   f"{w}'s log:\n{text[-2000:]}")
            stats[w] = json.loads(lines[-1].split(key + " ", 1)[1])
            stats[w]["launches"] = json.loads(
                launches[-1].split("kernel launches ", 1)[1])
        pw, dw = stats["prefill"], stats["decode"]
        n, L = len(DISAGG_LONG), cfg.num_layers
        pl, dl = pw["launches"], dw["launches"]
        gbps = (pw["wire_bytes"] / pw["wire_s"] / 1e9
                if pw["wire_s"] else None)
        fig = {"bring_up": bring_up, "requests": rows,
               "sender": ("asyncio" if os.environ.get(
                   "DYN_NATIVE_DATAPLANE", "1") == "0" else "native"),
               "wire_gb": pw["wire_bytes"] / 1e9, "wire_s": pw["wire_s"],
               "wire_gbps": gbps, "prefill_worker": {
                   k: v for k, v in pw.items() if k != "launches"},
               "decode_worker": {k: v for k, v in dw.items()
                                 if k != "launches"},
               "launches": {"prefill": pl, "decode": dl}}
        log(f"11e {json.dumps(fig)} [{card}]")
        want_split = (pw["prefills_done"] == n and pw["stream_handoffs"] == n
                      and not pw["stream_fallbacks"]
                      and dw["remote_prefills"] == n
                      and dw["local_prefills"] == len(DISAGG_SHORT)
                      and dw["remote_failures"] == 0
                      and dw["stream_transfers"] == n
                      and dw["disagg_stream_layers_total"] == n * L
                      and dw["prefill_tokens_total"] == sum(DISAGG_SHORT)
                      # the worker: n prefills (K1 a layer, K5 once), no
                      # decode; the decode worker: the short prompts'
                      # prefills and every decode step
                      and pl["flash_prefill"] == n * L
                      and pl["lm_head_int8"] == n
                      and pl["paged_attention_int8"] == 0
                      and pl["grouped_int4_matmul"] > 0
                      and dl["flash_prefill"] == len(DISAGG_SHORT) * L
                      and dl["paged_attention_int8"] > 0
                      and dl["lm_head_int8"] > len(DISAGG_SHORT)
                      and dl["grouped_int4_matmul"] > 0)
        if not want_split:
            raise RuntimeError(f"11e: {fig}")
        report["11e"] = fig
    except BaseException:
        log(procs.tails())
        raise
    finally:
        if svc is not None:
            on_loop(loop, svc.stop(), 60)
        procs.stop([n for n in procs.procs if n != "daemon"], 30)
        procs.stop(["daemon"], 30)


# 12. The fleet KV fabric on the one card
FABRIC_PROMPTS = (1600, 2100, 2600, 3000)   # 12b published, 12c fetched
FABRIC_SUFFIX = 32             # each request's own tokens past its prefix
FABRIC_TOKENS = 32
FABRIC_LOST = 1000             # 12c: held by worker A at its SIGTERM
FABRIC_TORN = 800              # 12c: the torn peer's prompt
FABRIC_FILLER = 3000           # 12c: pushes A's prompts off its device
FABRIC_BLOCKS = 1024           # every engine's pool but A's
FABRIC_A_BLOCKS = 256          # A's: two fillers evict everything else
FABRIC_HOST, FABRIC_DISK = 1536, 2048
FABRIC_ENDPOINT = "dyn://dynamo/fabric/generate"
FABRIC_PUBLISH = "dyn://dynamo/prefill/prefill_publish"
FABRIC_STREAM_TOKENS = 3000    # 12a: the 8B layer stream's prompt


def fabric_prompts(cfg, seed: int) -> dict:
    """The phase's token-id prompts and suffixes, from one seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 300)
    hi = min(127000, cfg.vocab_size - 256)

    def ids(n):
        return rng.integers(min(1000, hi // 2), hi, size=n).tolist()
    main = [ids(n) for n in FABRIC_PROMPTS]
    return {"main": main,
            "suffixed": [p + ids(FABRIC_SUFFIX) for p in main],
            "lost": ids(FABRIC_LOST), "lost_suffix": ids(FABRIC_SUFFIX),
            "torn": ids(FABRIC_TORN), "torn_suffix": ids(FABRIC_SUFFIX),
            "fillers": [ids(FABRIC_FILLER) for _ in range(2)]}


async def engine_stream(core, prompt: list, rid: str,
                        n: int = FABRIC_TOKENS) -> tuple:
    """(greedy token ids, TTFT ms on the engine's clock, the request) of
    one request submitted to ``core`` alone."""
    import asyncio
    from dynamo_tpu_torch.engine.core import FINISH_SENTINEL, EngineRequest
    from dynamo_tpu_torch.engine.sampling import SlotSampling
    req = EngineRequest(rid=rid, prompt=list(prompt),
                        sampling=SlotSampling(temperature=0.0),
                        max_new_tokens=n, eos_ids=frozenset())
    t0 = time.monotonic()
    await core.submit(req)
    toks, ttft = [], None
    while True:
        item, _ = await asyncio.wait_for(req.out_queue.get(), 600)
        if item is FINISH_SENTINEL:
            return toks, ttft, req
        if ttft is None:
            ttft = 1e3 * (time.monotonic() - t0)
        toks.append(item)


async def worker_stream(client, wid: int, prompt: list, rid: str,
                        n: int = FABRIC_TOKENS) -> tuple:
    """(greedy token ids, TTFT ms on this client's clock) of one
    token-protocol request sent to worker ``wid``."""
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       SamplingOptions,
                                                       StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context, EngineContext
    pre = PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=SamplingOptions(greedy=True))
    t0 = time.monotonic()
    stream = await client.direct(Context(pre, ctx=EngineContext(rid)), wid)
    toks, ttft = [], None
    async for item in stream:
        ids = ((item or {}).get("data") or {}).get("token_ids") or []
        if ids and ttft is None:
            ttft = 1e3 * (time.monotonic() - t0)
        toks += ids
    return toks, ttft


async def raw_socket_bytes(sender_cls, frames: list,
                           layered=None) -> tuple:
    """Every byte ``sender_cls`` writes for a prologue, ``frames`` (header,
    data) and a sentinel, read off the socket by a plain blocking socket in
    a thread of its own, and the seconds from connect to the last byte;
    ``layered`` (a callable of the sender) sends a layer stream instead of
    frames."""
    import asyncio
    import socket
    import threading
    from dynamo_tpu_torch.runtime.codec import ConnectionInfo
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    chunks: list = []
    done = threading.Event()

    def reader():
        conn, _ = lsock.accept()
        with conn:
            while True:
                c = conn.recv(1 << 22)
                if not c:
                    break
                chunks.append(c)
        done.set()
    threading.Thread(target=reader, daemon=True).start()
    t0 = time.monotonic()
    s = await sender_cls.connect(ConnectionInfo(
        address=f"127.0.0.1:{lsock.getsockname()[1]}", stream_id="f" * 32))
    try:
        if layered is not None:
            await layered(s)
        else:
            for header, data in frames:
                await s.send(data, header=header)
            await s.finish()
        if not await asyncio.to_thread(done.wait, 120):
            raise RuntimeError("12a: the reader saw no end of stream")
        return b"".join(chunks), time.monotonic() - t0
    finally:
        lsock.close()


async def fabric_dataplane(cfg, card: str) -> dict:
    """12a. The data plane's library built, then the C++ sender's bytes
    against the asyncio sender's on the same payloads (token frames, the
    whole KV payload of the 8B int8 pool at 3000 tokens, its layer stream),
    each payload's frames read back whole through a TcpStreamServer, STOP
    and KILL through the flag poll; each sender's GB/s."""
    import asyncio
    import torch
    from dynamo_tpu_torch.llm.kv.stream import (LayeredHarvest,
                                                LayerStreamManifest,
                                                decode_layer_frame,
                                                send_layer_stream,
                                                send_monolithic_payload)
    from dynamo_tpu_torch.llm.protocols.disagg import (KvPayload,
                                                       decode_kv_payload)
    from dynamo_tpu_torch.runtime.codec import ControlMessage, FrameKind
    from dynamo_tpu_torch.runtime.native_tcp import (NativeStreamSender,
                                                     load_data_plane_lib)
    from dynamo_tpu_torch.runtime.tcp import StreamSender, TcpStreamServer

    t0 = time.monotonic()
    await asyncio.to_thread(load_data_plane_lib)
    fig = {"build_s": time.monotonic() - t0}
    from dynamo_tpu_torch.engine.models import llama
    n = FABRIC_STREAM_TOKENS // KV_BLOCK
    g = torch.Generator().manual_seed(12)
    # the int8 pool's rows: one opaque wire head of the row's width
    width = next(iter(llama.init_kv_cache(
        cfg, 1, KV_BLOCK, "cpu", torch.bfloat16,
        quantization="int8").values())).shape[-1]
    shape = (cfg.num_layers, 1, n, KV_BLOCK, width)
    values = {k: torch.randint(-128, 128, shape, generator=g,
                               dtype=torch.int8) for k in ("k", "v")}
    hashes = list(range(n))
    payload = KvPayload(request_id="12a", first_token=7, first_logprob=-0.5,
                        seq_hashes=hashes, values=values)
    harvest = LayeredHarvest(
        num_layers=cfg.num_layers,
        fetch_layer=lambda layer: {k: v[layer] for k, v in values.items()},
        fetch_all=lambda: values)
    tokens = [(b"", json.dumps({"tok": i}).encode()) for i in range(64)]

    async def whole(s):
        await send_monolithic_payload(s, payload)
        await s.finish()

    async def layers(s):
        await send_layer_stream(s, "12a", 7, -0.5, hashes, harvest)
    cases = {"tokens": (tokens, None), "payload": ([], whole),
             "layer_stream": ([], layers)}
    senders = {"native": NativeStreamSender, "asyncio": StreamSender}
    for name, (frames, fn) in cases.items():
        out = {}
        for sname, cls in senders.items():
            out[sname] = await raw_socket_bytes(cls, frames, fn)
        if out["native"][0] != out["asyncio"][0]:
            raise RuntimeError(f"12a {name}: the C++ sender's bytes differ "
                               f"from the asyncio sender's")
        nbytes = len(out["native"][0])
        fig[name] = {"bytes": nbytes, **{
            f"{s}_gbps": nbytes / out[s][1] / 1e9 for s in senders}}

    # the same payloads through a stream server: whole and equal
    srv = TcpStreamServer(host="127.0.0.1")
    await srv.start()
    try:
        for name, fn in (("payload", whole), ("layer_stream", layers)):
            rx = srv.register()
            s = await NativeStreamSender.connect(srv.connection_info(rx))
            task = asyncio.get_running_loop().create_task(fn(s))
            await rx.wait_connected(10)
            frames = []
            while True:
                f = await rx.next_frame(timeout=60)
                if f is None or f.kind == FrameKind.ERROR:
                    raise RuntimeError(f"12a {name}: the stream tore")
                if f.kind == FrameKind.SENTINEL:
                    break
                frames.append(f)
            await task
            if name == "payload":
                got = decode_kv_payload(frames[0].header,
                                        b"".join(f.data for f in frames))
                same = all(torch.equal(got.values[k], values[k])
                           for k in values)
            else:
                man = LayerStreamManifest.from_header(
                    frames[0].header_json())
                same = len(frames) == 1 + cfg.num_layers and all(
                    torch.equal(decode_layer_frame(man, f.data)[k],
                                values[k][i])
                    for i, f in enumerate(frames[1:]) for k in values)
            if not same:
                raise RuntimeError(f"12a {name}: the received values differ")
            srv.unregister(rx.stream_id)
        rx = srv.register()
        s = await NativeStreamSender.connect(srv.connection_info(rx))
        seen = []
        s.on_stop = lambda: seen.append("stop")
        s.on_kill = lambda: seen.append("kill")
        await rx.wait_connected(10)
        for ctl, want in ((ControlMessage.stop(), ["stop"]),
                          (ControlMessage.kill(), ["stop", "kill"])):
            await rx.send_control(ctl)
            deadline = time.monotonic() + 5
            while seen != want and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            if seen != want:
                raise RuntimeError(f"12a: control flags {seen}, not {want}")
        await s.finish()
        srv.unregister(rx.stream_id)
    finally:
        await srv.close()
    log(f"12a dataplane {json.dumps(fig)} [{card}]")
    return fig


class TornPeer:
    """A kv_fabric peer in this process that serves torn payloads for the
    hashes it announces (the torn-frame rung)."""

    def __init__(self, hashes: list):
        from dynamo_tpu_torch.llm.kv.fabric import KvFabricServer

        class Torn(KvFabricServer):
            def _pin_host(self, hashes):
                return {}

            def _read_block(self, seq_hash, held):
                return b"\x93NUMPY-torn" if seq_hash in hashes else None

            def _serveable(self, seq_hash):
                return seq_hash in hashes
        self.server = Torn(None)
        self.hashes = hashes


def fabric_phase(cfg, dev, seed: int, card: str) -> dict:
    """Phase 12: the fleet KV fabric at the 8B width and depth, int4
    weights + int8 KV, phase 7's ``tokenizer.json`` directory, host and
    disk tiers, greedy 32-token streams with ``ignore_eos``.

    (12a) the data plane, ``fabric_dataplane``. Then the port's daemon, a
    ``--role prefill-publish`` worker (``--kv-remote-dir`` under
    ``build/``) and two ``--kv-fabric`` workers A and B (no object root;
    A's device pool 256 blocks) come up as processes while this process
    builds three engines over one seeded weight tree: D (the decode engine:
    host and disk tiers on an empty directory, the same object root,
    ``kv_remote_admission="always"``, recorded), T (the device-hit twin,
    with a host tier) and C (the cold twin, no prefix reuse). (12b) the
    publisher publishes four prompts of 1600-3000 tokens and re-publishes
    one (0 objects written); T prefills each prompt, then T, C and D serve
    each prompt plus a 32-token suffix: D's four admissions onboard from
    the object store (``remote_onboards`` 4, ``hit_remote`` the published
    blocks, D's prefill tokens the suffixes alone) and its streams equal
    T's bit for bit. (12c) A serves the four prompts, a fifth and two
    fillers that push them off its device (to its host and disk tiers,
    announced as such); B serves each prompt plus its suffix, fetching the
    prefix from A over ``fetch_native`` (``dataplane_fallbacks_total`` 0)
    with T's streams; a peer in this process serving torn payloads for a
    sixth prompt: B recomputes it with T's cold stream; T's host blocks
    over the JSON op (``DYN_KV_FABRIC_DATAPLANE=0`` here, the fallback
    counted) equal them over the data plane and A's; A gets SIGTERM and
    B recomputes the fifth prompt (its fetch failure counted) with T's
    cold stream. (12d) D's log replays on the card from the carried bytes
    and, stripped of them, from the root, with ``compare_replay`` empty.
    Printed: the object store's write and read GB/s, each remote TTFT
    beside its cold and device-hit twins', B's probed links and what the
    ``auto`` gate would have decided for each fetch (modeled seconds,
    crossover). Returns {FABRIC_PATH: (launches, report)}: the in-process
    engines' launches before the replay plus the three workers'."""
    import asyncio
    import signal
    import socket
    import tempfile
    import threading
    import torch
    from dynamo_tpu_torch.engine import replay
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.quant import init_params_quantized
    from dynamo_tpu_torch.llm.kv.native_pool import load_native_pool_lib
    from dynamo_tpu_torch.runtime.distributed import (DistributedRuntime,
                                                      Endpoint)

    t_phase = time.monotonic()
    load_native_pool_lib()          # built once, before any worker starts
    name = "llama3-8b-fabric"
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp_ctx = tempfile.TemporaryDirectory(prefix="dtt-fabric-",
                                          dir=os.path.join(ROOT, "build"))
    tmp = tmp_ctx.name
    model_dir = os.path.join(tmp, name)
    write_chat_model_dir(model_dir, cfg)
    mcfg = ModelConfig.from_model_dir(model_dir)
    prompts = fabric_prompts(mcfg, seed)
    root = os.path.join(tmp, "objects")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="fabric-loop",
                              daemon=True)
    thread.start()
    procs = RoutedProcs(os.path.join(tmp, "logs"), tag="12")
    os.makedirs(procs.tmp, exist_ok=True)
    cores: dict = {}
    report: dict = {"card": card}
    aux: dict = {}
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dport = s.getsockname()[1]
        addr = f"127.0.0.1:{dport}"
        procs.start("daemon", "dynamo_tpu_torch.runtime.server", "--host",
                    "127.0.0.1", "--port", str(dport))
        procs.wait_line("daemon", "dynamo-tpu-torch discovery", 60)
        common = ["out=torch", "--random-weights", "--quantization", "int4",
                  "--kv-quantization", "int8", "--model-path", model_dir,
                  "--model-name", name, "--runtime-server", addr,
                  "--max-model-len", str(DISAGG_MAX_LEN), "--kv-block-size",
                  str(KV_BLOCK), "--max-num-seqs", "8", "--device",
                  dev.type, "-v"]
        t0 = time.monotonic()
        procs.start("publisher", "dynamo_tpu_torch.launch.run",
                    f"in={FABRIC_PUBLISH}", *common, "--role",
                    "prefill-publish", "--num-kv-blocks", str(FABRIC_BLOCKS),
                    "--host-kv-blocks", str(FABRIC_HOST), "--kv-disk-dir",
                    os.path.join(tmp, "disk-publisher"), "--kv-disk-blocks",
                    str(FABRIC_DISK), "--kv-remote-dir", root)
        for w, blocks in (("A", FABRIC_A_BLOCKS), ("B", FABRIC_BLOCKS)):
            procs.start(w, "dynamo_tpu_torch.launch.run",
                        f"in={FABRIC_ENDPOINT}", *common, "--protocol",
                        "tokens", "--kv-fabric", "--kv-remote-admission",
                        "always", "--num-kv-blocks", str(blocks),
                        "--host-kv-blocks", str(FABRIC_HOST), "--kv-disk-dir",
                        os.path.join(tmp, f"disk-{w}"), "--kv-disk-blocks",
                        str(FABRIC_DISK))

        # the data plane and the in-process engines, while the workers
        # come up
        with phase("12a"):
            report["12a"] = on_loop(loop, fabric_dataplane(mcfg, card))
        params = init_params_quantized(mcfg, seed, dev, torch.bfloat16,
                                       include_embed=True, bits=4)
        tiers = dict(host_kv_blocks=FABRIC_HOST, kv_disk_blocks=FABRIC_DISK)
        cores["D"] = disagg_core(
            mcfg, dev, params, num_kv_blocks=FABRIC_BLOCKS,
            enable_prefix_reuse=True, kv_disk_dir=os.path.join(tmp, "disk-D"),
            kv_remote_dir=root, kv_remote_admission="always", **tiers)
        cores["T"] = disagg_core(mcfg, dev, params,
                                 num_kv_blocks=FABRIC_BLOCKS,
                                 enable_prefix_reuse=True,
                                 host_kv_blocks=FABRIC_HOST)
        cores["C"] = disagg_core(mcfg, dev, params,
                                 num_kv_blocks=FABRIC_BLOCKS)
        D, T, C = cores["D"], cores["T"], cores["C"]
        D.recorder = replay.Recorder()

        async def connect():
            rt = await DistributedRuntime.connect(addr)
            pub = await Endpoint.parse_path(rt, FABRIC_PUBLISH).client() \
                .start()
            work = await Endpoint.parse_path(rt, FABRIC_ENDPOINT).client() \
                .start()
            return rt, pub, work
        rt, pub_client, work_client = on_loop(loop, connect())
        aux["rt"], aux["clients"] = rt, (pub_client, work_client)
        wids = {}
        for w in ("publisher", "A", "B"):
            line = procs.wait_line(w, "READY", ROUTED_READY_S)
            wids[w] = int(line.rsplit(" ", 1)[-1], 16)
        bring_up = {"s": time.monotonic() - t0}
        for w in wids:
            gib = [ln for ln in procs.text(w).splitlines()
                   if "device memory after bring-up" in ln]
            bring_up[w] = (float(gib[0].split(": ")[-1].split()[0])
                           if gib else None)
        report["bring_up"] = bring_up
        launches0 = launch_counts()

        # 12b. publish, then the twins and D
        with phase("12b"):
            async def publish(prompt, rid):
                from dynamo_tpu_torch.runtime.engine import Context
                await pub_client.wait_for_instances(timeout=60)
                stream = await pub_client.direct(
                    Context({"op": "publish", "token_ids": prompt,
                             "request_id": rid}), wids["publisher"])
                async for item in stream:
                    if not item.get("ok"):
                        raise RuntimeError(f"12b publish {rid}: {item}")
                    return item
                raise RuntimeError(f"12b publish {rid}: no reply")
            published = []
            for i, p in enumerate(prompts["main"]):
                r = on_loop(loop, publish(p, f"pub-{i}"))
                published.append(r["published"])
            again = on_loop(loop, publish(prompts["main"][0], "pub-again"))
            want_pub = [len(p) // KV_BLOCK for p in prompts["main"]]
            if published != want_pub or again["published"] != 0:
                raise RuntimeError(f"12b: published {published} (want "
                                   f"{want_pub}), again {again}")
            rows, ref = [], []
            for i, (p, ps) in enumerate(zip(prompts["main"],
                                            prompts["suffixed"])):
                on_loop(loop, engine_stream(T, p, f"prime-{i}", 1))
                t_toks, t_ttft, t_req = on_loop(loop, engine_stream(
                    T, ps, f"twin-{i}"))
                _c_toks, c_ttft, _ = on_loop(loop, engine_stream(
                    C, ps, f"cold-{i}"))
                n_pf0 = D.total_prefill_tokens
                d_toks, d_ttft, d_req = on_loop(loop, engine_stream(
                    D, ps, f"remote-{i}"))
                ref.append(t_toks)
                rows.append({"prompt": len(ps), "ttft_ms": d_ttft,
                             "device_hit_twin_ttft_ms": t_ttft,
                             "cold_twin_ttft_ms": c_ttft,
                             "hit": d_req.prefix_hit_tokens,
                             "twin_hit": t_req.prefix_hit_tokens,
                             "prefill_tokens": D.total_prefill_tokens - n_pf0,
                             "equal": d_toks == t_toks})
                if (d_toks != t_toks or len(d_toks) != FABRIC_TOKENS
                        or d_req.prefix_hit_tokens != want_pub[i] * KV_BLOCK
                        or t_req.prefix_hit_tokens != want_pub[i] * KV_BLOCK
                        or rows[-1]["prefill_tokens"]
                        != len(ps) - want_pub[i] * KV_BLOCK):
                    raise RuntimeError(f"12b: prompt {i}: {rows[-1]}")
            recs = [r for r in D.flight.dump() if r["kind"] == "prefill"
                    and str(r.get("rid", "")).startswith("remote-")]
            hit_remote = [r["hit_remote"] for r in recs]
            st = D.remote_store.object.store
            fig = {"published": published, "republished": again["published"],
                   "requests": rows, "hit_remote": hit_remote,
                   "remote_onboards": D.remote_onboards,
                   "remote_fetch_failures": D.remote_fetch_failures,
                   "object_read_gb": st.get_bytes_total / 1e9,
                   "object_read_s": st.get_seconds_total,
                   "object_read_gbps": (st.get_bytes_total
                                        / st.get_seconds_total / 1e9
                                        if st.get_seconds_total else None)}
            if (D.remote_onboards != len(FABRIC_PROMPTS)
                    or D.remote_fetch_failures
                    or hit_remote != [n * KV_BLOCK for n in want_pub]):
                raise RuntimeError(f"12b: {fig}")
            report["12b"] = fig
            # the publisher is done: its stats come from its log at exit
            procs.signal("publisher", signal.SIGINT)

        # 12c. peer fetch across processes
        cold_rate = (sum(r["prompt"] for r in rows)
                     / sum(r["cold_twin_ttft_ms"] / 1e3 for r in rows))
        with phase("12c"):
            report["12c"] = fabric_peers(
                prompts, wids, want_pub, ref, cores, aux, procs, loop,
                work_client, addr, card, cold_rate)
        in_process = count_delta(launch_counts(), launches0)

        # 12d. D's log replays from the bytes and from the root, while the
        # SIGTERM rung's fetch waits out the dead peer
        with phase("12d"):
            ev = D.recorder.events
            D.recorder = None
            restores = [e for e in ev if e["ev"] == "kv_remote_restore"]
            out = {}
            for mode, events in (
                    ("bytes", ev),
                    ("root", [dict(e, values=None)
                              if e["ev"] == "kv_remote_restore" else e
                              for e in ev])):
                t1 = time.monotonic()
                diffs = replay.compare_replay(events,
                                              replay.replay(D, events))
                out[mode] = {"s": time.monotonic() - t1,
                             "diffs": len(diffs)}
                if diffs:
                    raise RuntimeError(f"12d {mode}: {diffs[:4]}")
            out["restores"] = len(restores)
            if len(restores) != len(FABRIC_PROMPTS):
                raise RuntimeError(f"12d: {out}")
            report["12d"] = out
            report["12c"]["lost"] = aux.pop("lost_task").result(120)
            fails = {rid: any(f"failed for {rid} " in ln
                              for ln in procs.text("B").splitlines())
                     for rid in ("b-torn", "b-lost")}
            report["12c"]["failed_fetches"] = fails
            if not all(fails.values()):
                raise RuntimeError(f"12c: B's failed fetches {fails}")

        # the workers' launches: the publisher's and B's from their logs at
        # stop, A's from its stats before its SIGTERM
        procs.stop(["publisher", "B"])
        worker = {"A": aux["a_launches"]}
        for w, key in (("publisher", "prefill-publish stats"),
                       ("B", "kv fabric stats")):
            text = procs.text(w)
            lines = [ln for ln in text.splitlines() if key in ln]
            launches = [ln for ln in text.splitlines()
                        if "kernel launches" in ln]
            if not lines or not launches:
                raise RuntimeError(f"12: no {key!r} or launch counts in "
                                   f"{w}'s log:\n{text[-2000:]}")
            report.setdefault("stats", {})[w] = json.loads(
                lines[-1].split(key + " ", 1)[1])
            worker[w] = json.loads(launches[-1].split("kernel launches ",
                                                      1)[1])
        ps = report["stats"]["publisher"]
        report["12b"]["object_write_gbps"] = (
            ps["object_put_bytes"] / ps["object_put_s"] / 1e9
            if ps.get("object_put_s") else None)
        bs = report["stats"]["B"]
        if (bs["remote_dataplane_fallbacks_total"] != 0
                or bs["remote_dataplane_fetches_total"]
                < len(FABRIC_PROMPTS)):
            raise RuntimeError(f"12c: B's fabric {bs}")
        total = dict(in_process)
        for w, counts in worker.items():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        report["launches"] = {"in_process": in_process, **worker}
        for k in PATH_KERNELS[FABRIC_PATH]:
            if total.get(k, 0) <= 0:
                raise RuntimeError(f"12: kernel {k} launched no time")
        report["s"] = time.monotonic() - t_phase
        log(f"12 fabric {json.dumps(report)} [{card}]")
        return {FABRIC_PATH: (total, report)}
    except BaseException:
        log(procs.tails())
        raise
    finally:
        task = aux.pop("lost_task", None)
        if task is not None:
            try:
                task.result(60)
            except Exception as e:  # noqa: BLE001 — shutdown goes on
                log(f"12: the SIGTERM rung: {e}")
        stops = [c.stop() for c in cores.values()]
        if "fab" in aux:
            stops.insert(0, aux["fab"].close())
        stops[:0] = [c.close() for c in aux.get("clients", ())]
        for key in ("torn_rt", "rt"):
            if key in aux:
                stops.append(aux[key].shutdown())
        for coro in stops:
            try:
                on_loop(loop, coro, 120)
            except Exception as e:  # noqa: BLE001 — shutdown goes on
                log(f"12: shutdown: {e}")
        cores.clear()
        procs.stop([n for n in procs.procs if n != "daemon"], 30)
        procs.stop(["daemon"], 30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        tmp_ctx.cleanup()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def fabric_peers(prompts, wids, want_pub, ref, cores, aux, procs, loop,
                 work_client, addr, card, cold_rate: float) -> dict:
    """12c (see ``fabric_phase``). Returns its figures; leaves the SIGTERM
    rung's request running (``aux["lost_task"]``, a future) and A's launch
    counts in ``aux["a_launches"]``."""
    import asyncio
    import json as _json
    import signal
    from dynamo_tpu_torch.llm.kv.blocks import TokenBlockSequence
    from dynamo_tpu_torch.llm.kv.fabric import (DATAPLANE_ENV, AdmissionGate,
                                                KvFabric, KvFabricServer,
                                                LinkStats, PeerLinkTable)
    from dynamo_tpu_torch.llm.kv.remotestore import (RemoteKvStore,
                                                     unpack_block_bytes)
    from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
    from dynamo_tpu_torch.runtime.distributed import (DistributedRuntime,
                                                      Endpoint)
    T = cores["T"]
    A, B = wids["A"], wids["B"]
    fig: dict = {}

    def stats(wid, key=None, at_least=None, timeout=10.0) -> dict:
        """A worker's published stats (1 s apart), once ``key`` reads at
        least ``at_least`` when given."""
        deadline = time.monotonic() + timeout
        while True:
            d = on_loop(loop, work_client.collect_stats()).get(wid, {})
            if key is None or d.get(key, 0) >= at_least:
                return d
            if time.monotonic() > deadline:
                raise RuntimeError(f"12c: {key} of {wid:x} is "
                                   f"{d.get(key)}, not {at_least}: {d}")
            time.sleep(0.1)

    # this process's fabric client: its index hears what B's does
    main_hashes = [TokenBlockSequence(KV_BLOCK, p).sequence_hashes[:n]
                   for p, n in zip(prompts["main"], want_pub)]
    lost_hashes = TokenBlockSequence(
        KV_BLOCK, prompts["lost"]).sequence_hashes[:FABRIC_LOST // KV_BLOCK]
    torn_hashes = TokenBlockSequence(
        KV_BLOCK, prompts["torn"]).sequence_hashes[:FABRIC_TORN // KV_BLOCK]

    async def client_setup():
        rt = await DistributedRuntime.connect(addr)
        comp = Endpoint.parse_path(rt, FABRIC_ENDPOINT).parent_component()
        fab = KvFabric(RemoteKvStore(), PeerLinkTable(),
                       AdmissionGate(1, 1, 1.0), runtime=rt)
        fab.bind_loop()
        fab.worker_id = (await rt.primary_lease()).id
        fab.client = comp.endpoint("kv_fabric").client()
        await fab.client.start()
        await fab.client.wait_for_instances(timeout=60)
        fab._sub = await comp.subscribe_event("kv_events")
        fab._tasks.append(asyncio.get_running_loop().create_task(
            fab._event_loop()))
        return rt, fab, comp
    rt, fab, comp = on_loop(loop, client_setup())
    aux["torn_rt"], aux["fab"] = rt, fab

    # A serves the prompts, the one it will hold at its SIGTERM, and two
    # fillers: everything of the first five leaves its device for its host
    # and disk tiers, announced as such
    for i, p in enumerate(prompts["main"] + [prompts["lost"]]):
        on_loop(loop, worker_stream(work_client, A, p, f"a-{i}"))
    for i, p in enumerate(prompts["fillers"]):
        on_loop(loop, worker_stream(work_client, A, p, f"fill-{i}", 1))
    deadline = time.monotonic() + 60
    while not all(fab.store.holders_of(h) == [A]
                  for hs in main_hashes + [lost_hashes] for h in hs):
        if time.monotonic() > deadline:
            raise RuntimeError(f"12c: A announced "
                               f"{fab.store.peer_block_count()} blocks")
        time.sleep(0.1)
    time.sleep(0.5)                 # B reads the same subject

    # B fetches each prefix from A
    rows = []
    for i, ps in enumerate(prompts["suffixed"]):
        toks, ttft = on_loop(loop, worker_stream(work_client, B, ps,
                                                 f"b-{i}"))
        rows.append({"prompt": len(ps), "ttft_ms": ttft,
                     "equal": toks == ref[i]})
        if toks != ref[i]:
            raise RuntimeError(f"12c: B's stream {i} parts from the "
                               f"device-hit twin's: {rows[-1]}")
    hits = {}
    for ln in procs.text("B").splitlines():
        if "admitted b-" in ln and "remote" in ln:
            rid = ln.split("admitted ", 1)[1].split()[0]
            hits[rid] = int(ln.split("disk+", 1)[1].split("remote")[0])
    want_hits = {f"b-{i}": n * KV_BLOCK for i, n in enumerate(want_pub)}
    b = stats(B, "remote_dataplane_fetches_total", len(want_pub))
    fig["fetch"] = {"requests": rows, "remote_hits": hits,
                    "remote_fetch_failures": b["remote_fetch_failures_total"],
                    "dataplane_fetches": b["remote_dataplane_fetches_total"],
                    "dataplane_fallbacks":
                        b["remote_dataplane_fallbacks_total"]}
    if (hits != want_hits or b["remote_fetch_failures_total"]
            or b["remote_dataplane_fallbacks_total"]
            or b["remote_dataplane_fetches_total"] != len(want_pub)):
        raise RuntimeError(f"12c fetch: {fig['fetch']}")
    # what the auto gate would have decided for each fetch: on B's link
    # table (A its only peer yet) and its measured prefill rate, and on the
    # same link at the cold twin's rate (12b's prompts over their TTFTs)
    link = LinkStats(rtt_s=b["remote_link_rtt_s"],
                     gbps=b["remote_link_gbps"])
    fig["auto"] = {"link_gbps": link.gbps, "link_rtt_s": link.rtt_s,
                   "kv_bytes_per_block": b["kv_bytes_per_block"]}
    for tag, rate in (("measured", b["prefill_tok_per_s"]),
                      ("cold_twin", cold_rate)):
        gate = AdmissionGate(b["kv_bytes_per_block"], KV_BLOCK, rate,
                             mode="auto")
        fig["auto"][tag] = {
            "prefill_tok_per_s": rate,
            "crossover_blocks": gate.crossover_blocks(link),
            "decisions": [
                {"blocks": n,
                 "modeled_fetch_s": gate.modeled_fetch_s(n, link),
                 "modeled_recompute_s": gate.modeled_recompute_s(n),
                 "admit": gate.admit(n, link)} for n in want_pub]}

    # (1) T's host blocks of the first prompt over the JSON op (this
    # process's server declines the data plane meanwhile) and over the
    # data plane, and A's over the data plane: the same bytes
    async def json_rung():
        srv_rt = await DistributedRuntime.connect(addr)
        try:
            await T.offload_engine.drain()
            ep = srv_rt.namespace("dynamo").component("twin") \
                .endpoint("kv_fabric")
            await ep.serve(KvFabricServer(T), decode_req=_json.loads)
            cli = KvFabric(RemoteKvStore(), PeerLinkTable(),
                           AdmissionGate(1, 1, 1.0), runtime=rt)
            cli.bind_loop()
            cli.client = ep.client()
            await cli.client.start()
            await cli.client.wait_for_instances(timeout=60)
            tw = (await srv_rt.primary_lease()).id
            native = await cli.fetch_blocks_async(tw, main_hashes[0])
            os.environ[DATAPLANE_ENV] = "0"
            try:
                via_json = await cli.fetch_blocks_async(tw, main_hashes[0])
            finally:
                os.environ.pop(DATAPLANE_ENV)
            from_a = [unpack_block_bytes(x)[0] for x in
                      await fab._fetch_blobs_native(A, main_hashes[0])]
            same = all(torch_equal_bits(x[k], y[k])
                       and torch_equal_bits(x[k], z[k])
                       for x, y, z in zip(native, via_json, from_a)
                       for k in x)
            out = {"blocks": len(native), "equal": same,
                   "fallbacks": cli.dataplane_fallbacks_total,
                   "dataplane_fetches": cli.dataplane_fetches_total}
            await cli.close()
            return out
        finally:
            await srv_rt.shutdown()
    fig["json"] = on_loop(loop, json_rung())
    if fig["json"] != {"blocks": want_pub[0], "equal": True, "fallbacks": 1,
                       "dataplane_fetches": 1}:
        raise RuntimeError(f"12c json: {fig['json']}")
    fig["probe_from_here"] = on_loop(loop, fab.probe(A)).to_dict()

    # (2) a peer in this process announces the sixth prompt's blocks and
    # tears every payload it serves
    n0 = b["remote_peer_blocks"]

    async def torn_peer():
        await comp.endpoint("kv_fabric").serve(TornPeer(torn_hashes).server,
                                               decode_req=_json.loads)

        async def sink(ev):
            await comp.publish_event("kv_events", ev)
        publ = KvEventPublisher(worker_id=fab.worker_id, sink=sink)
        for j, h in enumerate(torn_hashes):
            publ.publish_stored(-1, h, None,
                                torn_hashes[j - 1] if j else None,
                                tier="disk")
        await publ.drain()
        publ._task.cancel()
    on_loop(loop, torn_peer())
    stats(B, "remote_peer_blocks", n0 + len(torn_hashes))
    torn_prompt = prompts["torn"] + prompts["torn_suffix"]
    lost_prompt = prompts["lost"] + prompts["lost_suffix"]
    torn_ref = on_loop(loop, engine_stream(T, torn_prompt, "torn-ref"))[0]
    lost_ref = on_loop(loop, engine_stream(T, lost_prompt, "lost-ref"))[0]
    f0 = stats(B)["remote_fetch_failures_total"]

    # (3) A gets SIGTERM (its key stays until its lease ends): B's fetch of
    # the prompt only A held fails, and B recomputes it with T's cold
    # stream; the request runs on beside the torn rung and the replay
    aux["a_launches"] = stats(A)["kernel_launches"]
    procs.signal("A", signal.SIGTERM)

    async def lost():
        t0 = time.monotonic()
        toks, ttft = await worker_stream(work_client, B, lost_prompt,
                                         "b-lost")
        for _ in range(50):          # the failures in B's next stats
            b = (await work_client.collect_stats())[B]
            if b["remote_fetch_failures_total"] >= f0 + 2:
                break
            await asyncio.sleep(0.1)
        out = {"equal": toks == lost_ref, "ttft_ms": ttft,
               "s": time.monotonic() - t0,
               "fetch_failures": b["remote_fetch_failures_total"] - f0}
        if not out["equal"] or out["fetch_failures"] != 2:
            raise RuntimeError(f"12c lost peer (and torn): {out}")
        return out
    aux["lost_task"] = asyncio.run_coroutine_threadsafe(lost(), loop)
    got = on_loop(loop, worker_stream(work_client, B, torn_prompt, "b-torn"))
    fig["torn"] = {"equal": got[0] == torn_ref}
    if got[0] != torn_ref:
        raise RuntimeError(f"12c torn: {fig['torn']}")
    log(f"12c peers {json.dumps(fig)} [{card}]")
    return fig


# ``--ab DIR``: phase 3's attention kernels (K1-K4 at the 8B shapes) and
# phase 3m's latent kernels (K3-MLA and K4-MLA at V2-Lite's) of another
# checkout of the repository at DIR (its build directory apart) and of
# this one, timed in turns in one run on one card (DIR, this, this, DIR),
# each turn in a process of its own; AB_TURN is the code of a turn,
# written against the checks both checkouts have
AB_TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.engine.config import bench_model_config
kernels.LIBRARY.get()
cfg, dev, out = bench_model_config("8b"), torch.device("cuda:0"), {}
mcfg = cs.mla_config()
for int8 in (False, True):
    # K3-MLA on one 4096-key row alone (B = 1)
    bs = cs.MLA_BLOCK[int8]
    q, pool, _, tables, lens = cs.latent_inputs(
        mcfg, dev, 7, [cs.MLA_MAX_LEN], int8, bs, cs.MLA_MAX_LEN // bs)
    kw = dict(block_size=bs, scale=0.1, v_lanes=512,
              quant_sections=(512, 64) if int8 else None)
    out["latent_paged_b1" + "_int8" * int8] = [cs.time_ms(
        lambda: kernels.latent_paged_attention_cuda(q, pool, tables, lens,
                                                    **kw), cold=True)]
for int8 in (False, True):
    for kind, check in (("paged", cs.check_paged_attention),
                        ("ragged", cs.check_ragged_attention)):
        e = check(mcfg, dev, int8=int8, cases=cs.MLA_ATTN)
        out[f"latent_{kind}_attention" + "_int8" * int8] = [
            e["ms"], e["full_batch"]["ms"]]
if sys.argv[1:] == ["latent"]:
    print("AB " + json.dumps(out), flush=True)
    print("BITS {}", flush=True)
    sys.exit(0)
out["flash_prefill"] = [c["ms"] for c in cs.check_flash_prefill(cfg, dev)["cases"]]
out["flash_prefill_partial"] = [
    c["ms"] for c in cs.check_flash_prefill_partial(cfg, dev)["cases"]]
for int8 in (False, True):
    e = cs.check_paged_attention(cfg, dev, int8=int8)
    out["paged_attention" + "_int8" * int8] = [e["ms"], e["full_batch"]["ms"]]
    e = cs.check_ragged_attention(cfg, dev, int8=int8)
    out["ragged_paged_attention" + "_int8" * int8] = [
        e["ms"], e["full_batch"]["ms"], e["decode_step"]["ms"]]
print("AB " + json.dumps(out), flush=True)
# K3's and K4's output bits at the groups every checkout compiles (1, 2, 4
# and 8 at each head dim, both pools) on inputs drawn from one seed
import hashlib
from dynamo_tpu_torch.engine import attention
gen, bits = torch.Generator(device=dev), {}
gen.manual_seed(123)
i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
spans = [(64, 64), (20, 300), (1, 1), (1, 1024), (40, 1000), (0, 0),
         (1, 513), (3, 130), (0, 0)]
counts = [n for n, _ in spans]
starts = [sum(counts[:i]) for i in range(len(spans))]
for Dh in (64, 96, 128, 256):
    for g in (1, 2, 4, 8):
        for int8 in (False, True):
            H, KVH, M, bs = 2 * g, 2, 64, 16
            k, v = (torch.randn(((9 * M + 1) * bs, KVH * Dh), generator=gen,
                                device=dev).bfloat16() for _ in range(2))
            if int8:
                k, v = attention.quantize_kv_rows(k), attention.quantize_kv_rows(v)
            tables = (torch.randperm(9 * M, generator=gen, device=dev)
                      + 1).reshape(9, M).to(torch.int32)
            q3 = torch.randn((9, H, Dh), generator=gen, device=dev).bfloat16()
            q4 = torch.randn((sum(counts), H, Dh), generator=gen,
                             device=dev).bfloat16()
            kw = dict(block_size=bs, scale=Dh ** -0.5)
            o3 = attention.paged_attention(
                q3, k, v, tables, i32([1, 127, 128, 129, 300, 700, 1024, 0, 513]),
                **kw)
            o4 = attention.ragged_paged_attention(
                q4, k, v, tables, i32(starts), i32(counts),
                i32([c for _, c in spans]), max_rows=64, **kw)
            pool = "int8" if int8 else "bf16"
            for name, o in (("k3", o3), ("k4", o4)):
                bits[f"{name}_dh{Dh}_g{g}_{pool}"] = hashlib.sha256(
                    o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
print("BITS " + json.dumps(bits), flush=True)
"""


def ab_compare(other: str, latent_only: bool = False) -> int:
    """Time phase 3's attention kernels of the checkout at ``other`` and
    of this one in turns (other, this, this, other) and print each turn's
    times (ms: K3-MLA on one 4096-key row alone, K3-MLA's and K4-MLA's
    mix and full batch in both pools, then K1's four cases, K2's five
    hops, K3's mix and full batch and K4's mix, full batch and decode
    step) and their ratios, this over other, of the turns' means; then
    compare K3's and K4's output bits at the groups both compile (1, 2,
    4, 8) across the turns, and fail where any differ. ``latent_only``:
    the latent kernels' times alone, no bits."""
    card = card_line()
    turns, digests = [], []
    for side in ("other", "this", "this", "other"):
        root = os.path.abspath(other) if side == "other" else ROOT
        res = subprocess.run([sys.executable, "-c", AB_TURN]
                             + ["latent"] * latent_only, cwd=root,
                             capture_output=True, text=True, timeout=1200)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        bits = [x for x in res.stdout.splitlines() if x.startswith("BITS ")]
        if res.returncode != 0 or not line or not bits:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return 1
        turns.append((side, json.loads(line[0][3:])))
        digests.append(json.loads(bits[0][5:]))
        log(f"ab {side} {root} {json.dumps(turns[-1][1])} [{card}]")
    mean = {side: {k: [sum(t[k][i] for s, t in turns if s == side) / 2
                       for i in range(len(v))] for k, v in turns[0][1].items()}
            for side in ("other", "this")}
    ratio = {k: [a / b for a, b in zip(v, mean["other"][k])]
             for k, v in mean["this"].items()}
    log(f"ab this/other {json.dumps(ratio)} [{card}]")
    differ = sorted(k for k in digests[0]
                    if len({d.get(k) for d in digests}) != 1)
    log(f"ab bits: {len(digests[0]) - len(differ)} of {len(digests[0])} "
        f"K3 / K4 outputs the same in all four turns; differ: {differ}")
    return 1 if differ else 0


# ``--ab DIR serve``: phases 4m and 5m (V2-Lite's model through the latent
# kernels at LAYERS' depth, and its four servers) of both checkouts in the
# same turns: each turn's graphed decode step (device ms a token at K = 1
# and K = 8), pure-decode ragged dispatch (device ms), a mixed ragged
# dispatch as the --ragged server runs it while a 3000-token prompt is
# read (wall ms, device ms, the kernels' launch calls' host ms, top
# kernels by device time and operators by host time), and each served
# request's [TTFT, mean ITL] (ms)
AB_SERVE_TURN = """
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.engine.models import family
kernels.LIBRARY.get()
dev, card, out = torch.device("cuda:0"), cs.card_line(), {}
mcfg = cs.at_depth(cs.mla_config(), cs.LAYERS["mla"])
host = [0.0]
launch = kernels.Kernel.launch
def timed_launch(self, *a):
    t0 = time.perf_counter()
    launch(self, *a)
    host[0] += time.perf_counter() - t0
kernels.Kernel.launch = timed_launch
decode_profile = cs.profile_ragged_decode
def with_mixed(params, kv, cfg, tables, B, dev, bs=16):
    res = decode_profile(params, kv, cfg, tables, B, dev, bs)
    # slot 0's 64-row chunk ending at key 3000, a decode row per other slot
    spans = {0: (cs.RAGGED_MAX_ROWS, 3000 - cs.RAGGED_MAX_ROWS)}
    spans.update({s: (1, 300) for s in range(1, B)})
    batch = cs.ragged_batch(spans, [[3 + i % 1000 for i in range(3000)]] * B,
                            tables, B, dev)
    step = lambda: family(cfg).ragged_forward(params, kv, *batch, cfg, bs,
                                              cs.RAGGED_MAX_ROWS)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    host[0], t0 = 0.0, time.monotonic()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.monotonic() - t0) / 5
    launch_ms = 1e3 * host[0] / 5
    prof = cs.device_profile(step)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as p:
        step()
        torch.cuda.synchronize()
    ops = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                  for e in p.key_averages()), reverse=True)[:8]
    res["mixed"] = {"wall_ms": wall, "launch_host_ms": launch_ms,
                    "device_ms": prof["device_ms"],
                    "device_busy_share": prof["device_ms"] / wall,
                    "device_kernels": prof["device_kernels"],
                    "top_kernels_ms": prof["top_kernels_ms"],
                    "top_host_ops_ms": [[k[:50], t, n] for t, k, n in ops]}
    return res
cs.profile_ragged_decode = with_mixed
for mode in ("bf16", "bf16_kv8"):
    res = cs.check_model(mcfg, dev, 0, mode, cs.MLA_RUN)
    prof = res["program"]["profile"]
    out["step_" + mode] = [prof[k]["device_ms_per_token"]
                           for k in ("graph_k1", "graph_k8")]
    if res.get("ragged"):
        out["ragged_dispatch_" + mode] = (
            res["ragged"]["decode_dispatch"]["ragged"]["device_ms"])
        out["mixed_dispatch_" + mode] = (
            res["ragged"]["decode_dispatch"]["mixed"])
for path in cs.MLA_PATHS:
    _, rep = cs.serve_phase(mcfg, 0, card, path)
    out[path] = {k: [v["ttft_ms"], v["itl_ms_mean"]] for k, v in rep.items()
                 if isinstance(v, dict) and "ttft_ms" in v}
print("AB " + json.dumps(out), flush=True)
"""


def ab_serve(other: str) -> int:
    """Phases 4m and 5m of the checkout at ``other`` and of this one in
    turns (other, this, this, other), each turn a process of its own:
    print each turn's numbers (AB_SERVE_TURN)."""
    card = card_line()
    for side in ("other", "this", "this", "other"):
        root = os.path.abspath(other) if side == "other" else ROOT
        res = subprocess.run([sys.executable, "-c", AB_SERVE_TURN], cwd=root,
                             capture_output=True, text=True, timeout=1500)
        line = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return 1
        log(f"ab serve {side} {root} {line[0][3:]} [{card}]")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        return ab_compare(sys.argv[2])
    if sys.argv[1:2] == ["--ab"] and sys.argv[3:] == ["serve"]:
        return ab_serve(sys.argv[2])
    if sys.argv[1:2] == ["--ab"] and sys.argv[3:] == ["latent"]:
        return ab_compare(sys.argv[2], latent_only=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from dynamo_tpu_torch.engine import kernels
        from dynamo_tpu_torch.engine.config import bench_model_config
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    # torch.compile (the flex_attention yardstick) caches under the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))

    # 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    dev = torch.device("cuda:0")

    # 2. build
    with phase("2"):
        t0 = time.monotonic()
        kernels.LIBRARY.get()
        log(f"build: {time.monotonic() - t0:.1f} s")
    for block in kernels.LIBRARY.build_log:
        for line in block.splitlines():
            if (line.startswith("==") or "ptxas info" in line
                    or "spill" in line):
                log(line)

    # 3. kernels at the 8B shapes (the model phases at LAYERS' depth)
    cfg = bench_model_config("8b")
    with phase("3"):
        entries = [check_flash_prefill(cfg, dev),
                   check_flash_prefill_partial(cfg, dev),
                   check_paged_attention(cfg, dev),
                   check_paged_attention(cfg, dev, int8=True),
                   check_lm_head_int8(cfg, dev),
                   check_grouped_int4(cfg, dev),
                   check_ragged_attention(cfg, dev),
                   check_ragged_attention(cfg, dev, int8=True)]
        entries[1]["ring"] = check_ring(cfg, dev)
    cfg = at_depth(cfg, LAYERS["8b"])

    # 4. the model through the kernels vs the plain versions, per mode
    seed = 0
    with phase("4"):
        for mode in MODEL_MODES:
            with phase(f"4 {mode}"):
                check_model(cfg, dev, seed, mode, LLAMA_RUN)
        check_sampling_noise(cfg, dev)

    # 5. serving: bf16, quantized, both again with --ragged, then bf16 with
    # sequence-parallel prefill; each path's launch counts cover its own
    # phase alone, and each kernel reports those of the first path that
    # must launch it
    with phase("5"):
        by_path = {path: serve_phase(cfg, seed, card, path)
                   for path in PATH_KERNELS if path not in LATER_PATHS}
    compare_servers(card, by_path["bf16"][1], by_path["sp"][1], "sp")
    compare_servers(card, by_path["int4_kv8"][1], by_path["dispatch"][1],
                    "dispatch", "int4_kv8")
    compare_servers(card, by_path["ragged_int4_kv8"][1],
                    by_path["ragged_pipeline"][1], "ragged_pipeline",
                    "ragged_int4_kv8")

    # 3g-5g. the Gemma-2-9B geometry: its kernels' modes, the model through
    # them, and its servers
    gcfg = gemma_config()
    with phase("3g"):
        entries += check_gemma_kernels(gcfg, dev)
    gcfg = at_depth(gcfg, LAYERS["gemma2"])
    with phase("4g"):
        for mode in ("bf16", "int4_kv8"):
            check_model(gcfg, dev, seed, mode, GEMMA_RUN)
    with phase("5g"):
        by_path.update({path: serve_phase(gcfg, seed, card, path)
                        for path in GEMMA_PATHS})

    # 3m-5m. the DeepSeek-V2-Lite geometry: the latent kernels, the model
    # through them over a bf16 and an int8 pool, and its servers
    mcfg = mla_config()
    with phase("3m"):
        k4_int8 = check_ragged_attention(mcfg, dev, int8=True,
                                         cases=MLA_ATTN)
        # the JAX MLA model gathers over int8 pools on its ragged path
        # (mla.py ragged_forward), and so does the port: this mode runs in
        # phase 3m alone
        k4_int8["on_main_path"] = False
        entries += [check_paged_attention(mcfg, dev, cases=MLA_ATTN),
                    check_paged_attention(mcfg, dev, int8=True,
                                          cases=MLA_ATTN),
                    check_ragged_attention(mcfg, dev, cases=MLA_ATTN),
                    k4_int8]
    mcfg = at_depth(mcfg, LAYERS["mla"])
    with phase("4m"):
        for mode in ("bf16", "bf16_kv8"):
            check_model(mcfg, dev, seed, mode, MLA_RUN)
    with phase("5m"):
        by_path.update({path: serve_phase(mcfg, seed, card, path)
                        for path in MLA_PATHS})

    # 3p-5p. the Phi-3-mini geometry: head dim 96 and its every-layer
    # window in K1-K4, K5 and K6 at its widths, the model through them, and
    # its servers
    pcfg = phi3_config()
    with phase("3p"):
        entries += check_phi3_kernels(pcfg, dev)
    pcfg = at_depth(pcfg, LAYERS["phi3"])
    with phase("4p"):
        for mode in ("bf16", "int4_kv8"):
            check_model(pcfg, dev, seed, mode, PHI3_RUN)
    with phase("5p"):
        by_path.update({path: serve_phase(pcfg, seed, card, path)
                        for path in PHI3_PATHS})

    # 3q-5q. the Qwen2-7B geometry: the GQA group of 7 (and 3, 5, 6) in K3
    # and K4, K1 and K2 at g = 7, K5 and K6 at its widths, the model with
    # its live qkv biases through them, and its servers
    qcfg = qwen2_config()
    with phase("3q"):
        entries += check_qwen2_kernels(qcfg, dev)
    qcfg = at_depth(qcfg, LAYERS["qwen2"])
    with phase("4q"):
        for mode in ("bf16", "int4_kv8"):
            check_model(qcfg, dev, seed, mode, QWEN2_RUN)
    with phase("5q"):
        by_path.update({path: serve_phase(qcfg, seed, card, path)
                        for path in QWEN2_PATHS})

    # 6. the Phi-3-mini checkpoint: written from the seed, loaded back bit
    # for bit in bf16 and int4, and served by two servers that load it
    with phase("6"):
        checkpoint_phase(pcfg, dev, seed, card, by_path)

    # 7. chat at the 8B width from a directory whose only tokenizer is
    # tokenizer.json, on phase 5b's int4 + int8 KV path
    with phase("7"):
        by_path[CHAT_PATH] = chat_phase(cfg, seed, card,
                                        by_path["int4_kv8"][1])

    # 8. speculation at the 8B width and depth: K3, K5 and K6 at the
    # shapes it gives them; in int4 + int8 KV and in bf16 the verify
    # program against eager, decode and plain, the oracle-drafter engines
    # on both paths and a recorded pipelined ragged run replayed; the two
    # spec servers
    with phase("8"):
        entries += check_verify_kernels(cfg, dev)
        spec_launches = spec_phase(cfg, dev, seed)
        by_path.update({path: serve_phase(cfg, seed, card, path)
                        for path in SPEC_PATHS})
    compare_servers(card, by_path["int4_kv8"][1],
                    by_path["spec_int4_kv8"][1], "spec_int4_kv8", "int4_kv8")
    compare_servers(card, by_path["ragged_int4_kv8"][1],
                    by_path["spec_ragged_int4_kv8"][1],
                    "spec_ragged_int4_kv8", "ragged_int4_kv8")

    # 9. the KV tiers at the 8B width and depth: round trips of every pool
    # row format, two tiered servers, the warm restart, the overlap of an
    # onboard with decode, the defrag pass and a replayed restore
    with phase("9"):
        by_path.update(tier_phase(cfg, dev, seed, card))

    # 10. KV-aware routing over two 8B workers sharing the card: the
    # daemon, two workers and the processor as processes of their own
    with phase("10"):
        by_path[ROUTED_PATH] = routed_phase(cfg, dev, seed, card)

    # 11. disaggregated prefill and decode at the 8B width and depth: the
    # three planes, the rungs, the cross-quant repack and a --ragged decode
    # engine in one process, then the launcher's prefill worker and
    # --remote-prefill decode worker as processes of their own
    with phase("11"):
        by_path.update(disagg_phase(cfg, dev, seed, card))

    # 12. the fleet KV fabric at the 8B width and depth: the data plane,
    # prefill-as-a-service over the object tier, peer fetch between two
    # worker processes with its rungs, and the recorded remote restores
    # replayed
    with phase("12"):
        by_path.update(fabric_phase(cfg, dev, seed, card))
    rest = [p for p in PATH_KERNELS if p not in LATER_PATHS] \
        + list(CHAT_PATHS) + list(SPEC_PATHS) + list(TIER_PATHS) \
        + [ROUTED_PATH] + list(DISAGG_PATHS) + list(FABRIC_PATHS)
    for e in entries:
        mode = e.get("mode", "")
        if mode == SPEC_MODE_TAG:
            # the verify shapes: the launches of the spec server that runs
            # the kernel (of each, under launches_by_path); K3 bf16, which
            # no spec server runs, those of phase 8's bf16 drafting runs
            served = [p for p in SPEC_PATHS if e["name"] in PATH_KERNELS[p]]
            if served:
                e["launches_by_path"] = {p: by_path[p][0][e["name"]]
                                         for p in served}
                e["launches"] = e["launches_by_path"][served[0]]
                e["launches_path"] = served[0]
            else:
                e["launches"] = spec_launches[e["name"]]
                e["launches_path"] = "8b-8c bf16 drafting runs"
            e["served_paths"] = served
            if e["launches"] <= 0:
                raise RuntimeError(f"kernel {e['name']} ({mode}): no launch "
                                   f"on {e['launches_path']}")
            continue
        paths = (MLA_PATHS if mode.startswith("mla")
                 else PHI3_PATHS if mode.startswith("phi3")
                 else QWEN2_PATHS if mode.startswith("qwen2")
                 else GEMMA_PATHS if mode else rest)
        served = [p for p in paths if e["name"] in PATH_KERNELS[p]]
        path = served[0] if served else None
        if path is None and e.get("on_main_path") is not False:
            raise RuntimeError(f"kernel {e['name']} ({e.get('mode')}): no "
                               f"served path lists it")
        e["launches"] = by_path[path][0][e["name"]] if path else 0
        e["launches_path"] = path
        e["served_paths"] = served
        # each serving path's own count (the first is ``launches``)
        e["launches_by_path"] = {p: by_path[p][0][e["name"]]
                                 for p in served}
    log(f"phases {json.dumps(PHASE_S)} [{card}]")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
