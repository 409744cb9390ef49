"""The launcher: ``python -m dynamo_tpu_torch.launch.run in=SRC out=ENGINE
--model-path DIR [--random-weights] [--http-port N] [--device cuda|cpu]
[--quantization int8|int4|...] [--kv-quantization int8] [--ragged
[--ragged-max-tokens N] [--ragged-max-seq-rows N]] [--sp N] [--spec-k K]
[--prefill-chunk N] [--decode-steps-per-dispatch K
[--decode-dispatch-pipeline] [--lane-prefill-max-tokens N]]
[--max-tokens N] [--output-path F] [--runtime-server H:P
[--advertise-host H]] [--protocol tokens]``.

Counterpart of ``dynamo_tpu.launch.run``:

Inputs:  http (chat and completions) | text (a prompt per line, until an
         empty line) | stdin (every line of stdin) | batch:FILE.jsonl |
         none (bring the engine up and wait) | dyn://ns/comp/ep (serve as
         a discoverable worker of the distributed runtime, under the
         daemon at --runtime-server or an in-process runtime)
Outputs: torch | echo_core | echo_full | pystr:FILE.py | pytok:FILE.py

Core engines (torch, echo_core, pytok) ride the canonical link
preprocessor → backend (detokenizer) → engine; full engines (echo_full,
pystr) speak OpenAI themselves. The model directory holds ``config.json``
and a tokenizer (``tokenizer.json`` or ``tokenizer.model``, read by the
port's own readers), with its chat template in ``tokenizer_config.json``,
and for ``out=torch`` the checkpoint's ``*.safetensors``, loaded onto the
device in the engine's dtype and quantization (``engine/weights.py``);
``--random-weights`` serves weights from ``EngineConfig.seed`` instead. A
directory whose checkpoint does not load exits non-zero with the loader's
message.

A ``dyn://`` worker speaks ``--protocol tokens``: the bare token-level
engine (``out=torch`` or ``out=echo_core``) behind the endpoint, for a
KV-routing processor (``components/processor.py``) that tokenizes and
detokenizes; it publishes its ``ForwardPassMetrics`` (plus the daemon
link's counters) as its stats and its KV events on the component's
``kv_events`` subject. ``--protocol openai`` on a ``dyn://`` input (the
full pipeline on the worker, registered for discovery-driven frontends)
and ``out=dyn://`` wait for ``llm/discovery.py``, ``llm/engines/remote.py``
and the registry card (ROADMAP A7, A10).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
from typing import Tuple

from ..engine.config import KV_QUANTIZATIONS, WEIGHT_QUANTIZATIONS

logger = logging.getLogger("dynamo_tpu_torch.launch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo-tpu-torch-run",
        description="PyTorch/CUDA LLM serving launcher (in=SRC out=ENGINE)")
    p.add_argument("io", nargs="*", metavar="in=|out=",
                   help="in=http|text|stdin|batch:F|none|dyn://ns/comp/ep "
                        "out=torch|echo_core|echo_full|pystr:F|pytok:F")
    p.add_argument("--runtime-server",
                   help="discovery daemon host:port (default: in-process "
                        "runtime — single-process deployments)")
    p.add_argument("--advertise-host",
                   help="address other hosts can dial back")
    p.add_argument("--protocol", choices=["openai", "tokens"],
                   default="openai",
                   help="worker wire protocol for in=dyn://: openai = full "
                        "pipeline on the worker (not ported yet); tokens = "
                        "core engine only (preprocessing lives in a "
                        "KV-routing processor)")
    p.add_argument("--model-path",
                   help="HF-style model dir (config.json + tokenizer)")
    p.add_argument("--model-name", help="served model name "
                                        "(default: basename of model path)")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="tokens per KV block (0 = auto-select)")
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--host-kv-blocks", type=int, default=0,
                   help="host KV offload tier size in blocks (pinned "
                        "host memory on the GPU; 0 = off)")
    p.add_argument("--kv-disk-dir", default="",
                   help="persistent disk KV tier directory "
                        "(llm/kv/diskstore.py): host-tier evictions "
                        "spill here and a restarted engine pointed at "
                        "the same dir warm-starts from the previous "
                        "run's cache; needs --kv-disk-blocks and "
                        "--host-kv-blocks")
    p.add_argument("--kv-disk-blocks", type=int, default=0,
                   help="disk KV tier capacity in blocks (0 = off)")
    p.add_argument("--no-prefix-reuse", action="store_true")
    p.add_argument("--quantization", default="none",
                   choices=list(WEIGHT_QUANTIZATIONS),
                   help="weight-only quantization: int8 (per-channel) or "
                        "int4 (grouped, int8 lm head); -noembed keeps the "
                        "embedding in bf16")
    p.add_argument("--kv-quantization", default="none",
                   choices=list(KV_QUANTIZATIONS),
                   help="int8 KV pool with per-token in-row scales")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="split prompt prefill into fixed-size chunk "
                        "dispatches (0 = whole-prompt)")
    p.add_argument("--decode-steps-per-dispatch", type=int, default=1,
                   help="fuse K decode steps per dispatch (one CUDA graph "
                        "replay on the card; EOS/cancel react at K-step "
                        "granularity)")
    p.add_argument("--lane-prefill-max-tokens", type=int, default=0,
                   help="admissions with <= this many un-cached prompt "
                        "tokens ride the decode batch as planned inputs "
                        "when the engine is busy (continuous batching; "
                        "0 disables, needs K>1)")
    p.add_argument("--decode-dispatch-pipeline", action="store_true",
                   help="overlap each dispatch's token harvest with the "
                        "next dispatch (requires K>1 or --ragged; finish "
                        "reaction widens to <=2K-1 steps)")
    p.add_argument("--ragged", action="store_true",
                   help="unified ragged dispatch (engine/ragged.py): ONE "
                        "forward pass serves mixed prefill+decode batches "
                        "— admissions ride the batch as prefill lanes, "
                        "continuous batching becomes the only serving "
                        "code path")
    p.add_argument("--ragged-max-tokens", type=int, default=0,
                   help="token capacity of one ragged dispatch (0 = "
                        "auto: max_num_seqs + 2*ragged-max-seq-rows)")
    p.add_argument("--ragged-max-seq-rows", type=int, default=64,
                   help="per-sequence row budget per ragged dispatch "
                        "(longer prompts stream across dispatches)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: max prompt-lookup draft "
                        "tokens verified per step (engine/spec/; 0 "
                        "disables; per-request override via "
                        "nvext.speculation)")
    p.add_argument("--sequence-parallel-size", "--sp", type=int, default=1,
                   dest="sp",
                   help="sequence-parallel prefill of long cold prompts "
                        "(ring attention) over the first SP cards, or over "
                        "SP shards on the CPU with --device cpu")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from EngineConfig.seed instead "
                        "of the model directory's checkpoint")
    p.add_argument("--output-path", help="batch: output JSONL path")
    p.add_argument("--max-tokens", type=int, default=256,
                   help="text/stdin/batch: generation budget")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def parse_io(io_args) -> Tuple[str, str]:
    src, out = "http", "torch"
    for a in io_args:
        if a.startswith("in="):
            src = a[3:]
        elif a.startswith("out="):
            out = a[4:]
        else:
            raise SystemExit(f"unrecognized positional arg {a!r} "
                             "(expected in=... / out=...)")
    if src.startswith("dyn://"):
        parts = src[len("dyn://"):].split("/")
        if len(parts) != 3 or not all(parts):
            raise SystemExit(f"bad in= source {src!r}: expected "
                             f"dyn://namespace/component/endpoint")
    elif src not in ("http", "text", "stdin", "none") and not \
            src.startswith("batch:"):
        raise SystemExit(f"unknown in= source {src!r}")
    if out.startswith("dyn://"):
        raise SystemExit(f"unknown out= engine {out!r}: a remote engine "
                         f"needs llm/engines/remote.py and "
                         f"llm/discovery.py (ROADMAP A7, A10)")
    if out not in ("torch", "echo_core", "echo_full") and not (
            out.startswith("pystr:") or out.startswith("pytok:")):
        raise SystemExit(f"unknown out= engine {out!r}")
    return src, out


def model_name(args) -> str:
    if args.model_name:
        return args.model_name
    if args.model_path:
        return os.path.basename(os.path.normpath(args.model_path))
    return "echo"


def build_core(args, mesh=None):
    """EngineCore from CLI flags: the model directory's checkpoint (or
    with ``--random-weights`` bf16 weights from seed 0), quantized as the
    flags ask. ``mesh``: a mesh the caller built
    (``parallel.sharding.make_mesh``, which may repeat one card); by
    default ``--sp`` > 1 builds one over the first cards, or over
    ``["cpu"] * sp`` with ``--device cpu``."""
    from ..engine.config import EngineConfig, ModelConfig
    from ..engine.core import DTYPES, EngineCore
    from ..engine.weights import load_params_auto
    from ..parallel.sharding import make_mesh
    try:
        if mesh is None and args.sp > 1:
            mesh = make_mesh(sp=args.sp, devices=(["cpu"] * args.sp
                                                  if args.device == "cpu"
                                                  else None))
        ecfg = EngineConfig(max_model_len=args.max_model_len,
                            kv_block_size=args.kv_block_size,
                            num_kv_blocks=args.num_kv_blocks,
                            max_num_seqs=args.max_num_seqs,
                            enable_prefix_reuse=not args.no_prefix_reuse,
                            host_kv_blocks=args.host_kv_blocks,
                            kv_disk_dir=args.kv_disk_dir,
                            kv_disk_blocks=args.kv_disk_blocks,
                            quantization=args.quantization,
                            kv_quantization=args.kv_quantization,
                            ragged_dispatch=args.ragged,
                            ragged_max_tokens=args.ragged_max_tokens,
                            ragged_max_seq_rows=args.ragged_max_seq_rows,
                            prefill_chunk=args.prefill_chunk,
                            decode_steps_per_dispatch=(
                                args.decode_steps_per_dispatch),
                            decode_dispatch_pipeline=(
                                args.decode_dispatch_pipeline),
                            lane_prefill_max_tokens=(
                                args.lane_prefill_max_tokens),
                            spec_k=args.spec_k,
                            sp=mesh.shape["sp"] if mesh is not None else 1)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    model_cfg = ModelConfig.from_model_dir(args.model_path)
    params = None
    if not args.random_weights:
        try:
            params, model_cfg = load_params_auto(
                args.model_path, model_cfg, device=args.device,
                dtype=DTYPES[ecfg.dtype], quantization=ecfg.quantization)
        except (OSError, ValueError, NotImplementedError) as e:
            raise SystemExit(f"checkpoint loading failed: {e}")
        logger.info("loaded the checkpoint under %s", args.model_path)
    return EngineCore(model_cfg, ecfg, params=params, device=args.device,
                      mesh=mesh)


def model_card(args):
    from ..llm.model_card import ModelDeploymentCard
    if not args.model_path:
        raise SystemExit("this out= engine needs --model-path (tokenizer)")
    return ModelDeploymentCard.from_local_path(args.model_path,
                                               display_name=model_name(args))


def link_pipeline(engine, mdc):
    """Core engines ride the canonical link preprocessor → backend →
    engine; a full engine (``mdc`` None) is the pipeline."""
    if mdc is None:
        return engine
    from ..llm.backend import Backend
    from ..llm.preprocessor import OpenAIPreprocessor
    from ..runtime import link
    return link(OpenAIPreprocessor(mdc), Backend(mdc), engine)


def build_pipeline(args, core):
    """(pipeline, card): preprocessor → backend → TorchEngine(core)."""
    from ..llm.engines.torch_engine import TorchEngine
    mdc = model_card(args)
    return link_pipeline(TorchEngine(core), mdc), mdc


def build_engine_parts(args, out: str):
    """(engine, card, core): the engine ``out`` names, the model card a
    core engine is linked with (None for a full engine, which speaks
    OpenAI itself) and the ``EngineCore`` (None but for ``out=torch``)."""
    if out == "torch":
        if not args.model_path:
            raise SystemExit("out=torch needs --model-path")
        try:
            core = build_core(args)
        except RuntimeError as e:     # no CUDA device and --device cuda
            raise SystemExit(str(e))
        from ..llm.engines.torch_engine import TorchEngine
        return TorchEngine(core), model_card(args), core
    if out == "echo_full":
        from ..llm.engines.echo import EchoEngineFull
        return EchoEngineFull(), None, None
    if out == "echo_core":
        from ..llm.engines.echo import EchoEngineCore
        return EchoEngineCore(), model_card(args), None
    # user python-file engines (reference engines/python.rs:57-354)
    from ..llm.engines.python_file import (PythonFileEngineCore,
                                           PythonFileEngineFull)
    kind, _, path = out.partition(":")
    engine_args = {"model_path": args.model_path,
                   "model_name": model_name(args)}
    if kind == "pystr":
        return PythonFileEngineFull(path, engine_args), None, None
    return PythonFileEngineCore(path, engine_args), model_card(args), None


def build_engine(args, out: str):
    """(pipeline, core or None) for ``out``."""
    engine, mdc, core = build_engine_parts(args, out)
    return link_pipeline(engine, mdc), core


async def serve(args, core, ready=None, pipeline=None) -> None:
    """Serve chat and completions until cancelled; calls ``ready.set()``
    (an ``asyncio.Event`` or a ``threading.Event``) once listening. The
    pipeline is ``core``'s (``build_pipeline``) unless one is given."""
    from ..llm.http import HttpService
    if pipeline is None:
        pipeline, _ = build_pipeline(args, core)
    svc = HttpService(port=args.http_port, host=args.http_host)
    svc.manager.add_chat_model(model_name(args), pipeline)
    svc.manager.add_completion_model(model_name(args), pipeline)
    await svc.start()
    args.http_port = svc.port
    logger.info("serving %s on http://%s:%d/v1", model_name(args),
                args.http_host, svc.port)
    print(f"READY http://{args.http_host}:{svc.port}/v1", flush=True)
    if ready is not None:
        ready.set()
    try:
        await svc.run_forever()
    finally:
        if core is not None:
            await core.stop()


async def collect_chat_text(stream) -> str:
    """Fold a chat chunk stream to its first choice's text; raises on
    Annotated error items so failures surface instead of reading as empty
    output (delegates to the OpenAI aggregator — one fold implementation)."""
    from ..llm.protocols.openai import aggregate_chat_stream
    folded = await aggregate_chat_stream(stream)
    choices = folded.get("choices") or []
    if not choices:
        return ""
    return (choices[0].get("message") or {}).get("content") or ""


async def run_text(args, pipeline, interactive: bool) -> None:
    """in=text / in=stdin: each line of stdin is a one-message chat; its
    reply is printed. Interactive input ends at an empty line."""
    from ..runtime import Context
    name = model_name(args)
    loop = asyncio.get_running_loop()
    if interactive and sys.stdin.isatty():
        print(f"model: {name} — empty line or Ctrl-D to exit")
    while True:
        if interactive and sys.stdin.isatty():
            print("> ", end="", flush=True)
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line:
            return                      # EOF
        if not line.strip():
            if interactive:
                return                  # empty line exits the REPL
            continue                    # piped input: skip blanks, keep going
        req = {"model": name, "max_tokens": args.max_tokens, "stream": True,
               "messages": [{"role": "user", "content": line.strip()}]}
        stream = await pipeline.generate(Context(req))
        print(await collect_chat_text(stream))


async def run_batch(args, pipeline, path: str) -> None:
    """batch:FILE.jsonl — one JSON per line: {"text": ...} (completion
    prompt) or {"messages": [...]} (chat). Results go to --output-path
    (default: <input>.out.jsonl)."""
    from ..runtime import Context
    name = model_name(args)
    out_path = args.output_path or (path.rsplit(".jsonl", 1)[0] + ".out.jsonl")
    done = 0
    failed = 0

    def _read_lines() -> list:
        with open(path) as fin:
            return fin.readlines()

    # file reads/writes ride to_thread so generation on this loop keeps
    # stepping during the I/O
    lines = await asyncio.to_thread(_read_lines)
    fout = await asyncio.to_thread(open, out_path, "w")
    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                messages = d.get("messages") or [
                    {"role": "user",
                     "content": d.get("text", d.get("prompt", ""))}]
                req = {"model": name, "stream": True,
                       "max_tokens": d.get("max_tokens", args.max_tokens),
                       "messages": messages}
                if "temperature" in d:
                    req["temperature"] = d["temperature"]
                stream = await pipeline.generate(Context(req))
                text = await collect_chat_text(stream)
                out_line = json.dumps({**d, "response": text}) + "\n"
            except json.JSONDecodeError as e:
                failed += 1
                out_line = json.dumps({"input": line,
                                       "error": str(e)}) + "\n"
            except Exception as e:  # noqa: BLE001 — per-row isolation
                failed += 1
                out_line = json.dumps({**d, "error": str(e)}) + "\n"
            await asyncio.to_thread(fout.write, out_line)
            done += 1
    finally:
        await asyncio.to_thread(fout.close)
    level = logging.WARNING if failed else logging.INFO
    logger.log(level, "batch complete: %d requests (%d failed) → %s",
               done, failed, out_path)
    if failed:
        raise SystemExit(1)


async def make_runtime(args):
    from ..runtime.distributed import DistributedRuntime
    if args.runtime_server:
        return await DistributedRuntime.connect(args.runtime_server,
                                                advertise=args.advertise_host)
    return DistributedRuntime.in_process()


async def run_worker_endpoint(args, engine, core, runtime, path: str,
                              mdc=None) -> None:
    """in=dyn://ns/comp/ep — serve as a discoverable worker instance
    (reference input/endpoint.rs:34-115): the stats handler publishes the
    core's ForwardPassMetrics; KV events go to the component's kv_events
    subject for KV-aware routers. ``--protocol tokens`` serves the bare
    core engine (a KV-routing processor tokenizes and detokenizes: the
    examples/llm Processor→Router→Worker shape)."""
    from ..llm.protocols.annotated import encode_annotated_json
    from ..llm.protocols.common import PreprocessedRequest
    from ..runtime.distributed import Endpoint
    if mdc is None:
        raise SystemExit(
            "--protocol tokens needs a token-level engine "
            "(out=torch or out=echo_core), not a full-pipeline one")
    endpoint = Endpoint.parse_path(runtime, path)
    stats_handler = None
    if core is not None:
        def stats_handler():
            from ..runtime import netstore
            d = core.metrics().to_dict()
            # process-wide daemon-link counters ride the worker's scrape
            d["netstore_retries_total"] = netstore.retries_total()
            d["netstore_deadline_exceeded_total"] = \
                netstore.deadline_exceeded_total()
            # and so do this process's kernel launch counts (a router
            # reads ForwardPassMetrics and drops the key)
            d["kernel_launches"] = kernel_launches()
            return d
        await wire_kv_events(core, runtime, endpoint)
    if core is not None and core.device.type == "cuda":
        import torch
        logger.info("device memory after bring-up: %.2f GiB reserved",
                    torch.cuda.memory_reserved(core.device) / 2**30)
    await endpoint.serve(
        engine,
        decode_req=lambda raw: PreprocessedRequest.from_dict(
            json.loads(raw)),
        encode_resp=encode_annotated_json,
        stats_handler=stats_handler)
    logger.info("worker serving %s (%s protocol)", endpoint.path,
                args.protocol)
    print(f"READY {endpoint.path} worker {runtime.worker_id:x}", flush=True)
    await asyncio.Event().wait()


async def wire_kv_events(core, runtime, endpoint) -> None:
    """Attach a KvEventPublisher to the engine → bus subject
    ``evt.{ns}.{comp}.kv_events`` (reference kv_router/publisher.rs). The
    core's pool hooks are tier-aware: a device eviction whose hash
    survives in the host or disk tier re-announces with its tier instead
    of removing it, and disk spills and evictions announce with
    tier="disk". A warm-started disk tier is announced at once, and the
    pool re-announces itself after a lease reclaim."""
    from ..llm.kv_router.publisher import KvEventPublisher
    component = runtime.namespace(endpoint.namespace).component(
        endpoint.component)
    lease = await runtime.primary_lease()

    async def sink(ev) -> None:
        await component.publish_event("kv_events", ev)

    core.kv_event_publisher = KvEventPublisher(worker_id=lease.id, sink=sink)
    if core.disk_store is not None and len(core.disk_store) > 0:
        # warm-started disk tier: announce the recovered prefixes so the
        # router's radix index routes matching prompts here for a
        # promote instead of a cold recompute elsewhere (off the loop:
        # the store's inventory is read under its lock)
        n = await asyncio.to_thread(core.reannounce_kv)
        logger.info("announced %d KV blocks at bring-up (%d disk-"
                    "resident from the previous run)", n,
                    len(core.disk_store))

    # transient lease expiry → the reclaim replays discovery keys, but the
    # router's radix index of OUR blocks was wiped by the DELETE events:
    # re-announce the pool so KV-aware routing recovers
    prev = getattr(runtime.store, "on_lease_reclaimed", None)

    def reclaimed(lease_id: int) -> None:
        if prev is not None:
            prev(lease_id)
        if lease_id == lease.id:
            n = core.reannounce_kv()
            logger.info("re-announced %d stored KV blocks after lease "
                        "reclaim", n)

    runtime.store.on_lease_reclaimed = reclaimed


def kernel_launches() -> dict:
    """Every kernel's launch count in this process (``Kernel.launches``):
    a worker's share of the kernels its engine ran."""
    from ..engine.kernels import KERNELS
    return {name: k.launches for name, k in KERNELS.items()}


async def amain(argv=None) -> None:
    args = build_parser().parse_args(argv)
    src, out = parse_io(args.io)
    dyn = src.startswith("dyn://")
    if dyn and args.protocol == "openai":
        raise SystemExit(
            "in=dyn:// with --protocol openai (the full pipeline on the "
            "worker, registered for discovery-driven frontends) needs "
            "llm/discovery.py and the registry card (ROADMAP A7, A10); "
            "serve --protocol tokens behind components/processor.py")
    if dyn or src == "none":
        engine, mdc, core = build_engine_parts(args, out)
        runtime = await make_runtime(args)
        try:
            if dyn:
                await run_worker_endpoint(args, engine, core, runtime, src,
                                          mdc=mdc)
            else:
                await asyncio.Event().wait()
        finally:
            if core is not None:
                await core.stop()
                logger.info("kernel launches %s",
                            json.dumps(kernel_launches()))
            await runtime.shutdown()
        return
    pipeline, core = build_engine(args, out)
    if src == "http":
        await serve(args, core, pipeline=pipeline)
        return
    try:
        if src == "text":
            await run_text(args, pipeline, interactive=True)
        elif src == "stdin":
            await run_text(args, pipeline, interactive=False)
        else:
            await run_batch(args, pipeline, src[len("batch:"):])
    finally:
        if core is not None:
            await core.stop()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
