"""KV-aware processor frontend: OpenAI HTTP → tokenize → KV-routed dispatch
to token-protocol workers → detokenize.

A copy of ``dynamo_tpu.components.processor`` in its single-model mode.
Reference: the Processor + Router components of the disagg reference graph
(examples/llm/components/{processor,kv_router}.py; SURVEY.md §2.6, §3.3) —
preprocessing happens *before* routing so the router can match the prompt's
block hashes against its radix index::

    python -m dynamo_tpu_torch.components.processor \\
        --runtime-server HOST:PORT --model-path DIR \\
        --endpoint dyn://dynamo/worker/generate --port 8080 --kv-block-size 16

Workers: ``python -m dynamo_tpu_torch.launch.run
in=dyn://dynamo/worker/generate out=torch --protocol tokens --model-path DIR
--runtime-server HOST:PORT``. ``--port 0`` takes a free port; the
``READY http://HOST:PORT/v1`` line on standard output names it.

Not ported yet: the multi-model ``--registry`` mode (``llm/registry.py``,
ROADMAP A10; the flag raises), and the router-side watches of the KV tier
weights (``llm/kv/admin.py``) and of the tenant policies
(``llm/tenancy.py``), ROADMAP A7 and A10.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

logger = logging.getLogger("dynamo_tpu_torch.components.processor")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dynamo-tpu-torch-processor")
    p.add_argument("--runtime-server", required=True)
    p.add_argument("--model-path", help="HF-style model dir (tokenizer)")
    p.add_argument("--model-name")
    p.add_argument("--registry", action="store_true",
                   help="multi-model mode over the model registry (not "
                        "ported yet: giving it raises)")
    p.add_argument("--endpoint", default="dyn://dynamo/worker/generate")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="must match the workers' engine block size")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


async def amain(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.registry:
        raise SystemExit("--registry (multi-model multiplexing) needs "
                         "llm/registry.py (ROADMAP A10)")
    if not args.model_path:
        raise SystemExit("pass --model-path")

    from ..llm.backend import Backend
    from ..llm.engines.kv_routed import KvRoutedEngine
    from ..llm.http import HttpService
    from ..llm.model_card import ModelDeploymentCard
    from ..llm.preprocessor import OpenAIPreprocessor
    from ..runtime import link
    from ..runtime.distributed import DistributedRuntime, Endpoint

    name = args.model_name or os.path.basename(
        os.path.normpath(args.model_path))
    mdc = await asyncio.to_thread(ModelDeploymentCard.from_local_path,
                                  args.model_path, display_name=name)
    runtime = await DistributedRuntime.connect(args.runtime_server)
    engine = None
    try:
        endpoint = Endpoint.parse_path(runtime, args.endpoint)
        engine = await KvRoutedEngine.start(endpoint,
                                            block_size=args.kv_block_size)
        pipeline = link(OpenAIPreprocessor(mdc), Backend(mdc), engine)
        svc = HttpService(port=args.port, host=args.host)
        svc.manager.add_chat_model(name, pipeline)
        svc.manager.add_completion_model(name, pipeline)
        await svc.start()
        logger.info("processor serving %s on %s:%d → %s (KV-aware)",
                    name, args.host, svc.port, args.endpoint)
        print(f"READY http://{args.host}:{svc.port}/v1", flush=True)
        await svc.run_forever()
    finally:
        if engine is not None:
            await engine.close()
        await runtime.shutdown()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
