"""The launcher: ``python -m dynamo_tpu_torch.launch.run in=http out=torch
--model-path DIR [--random-weights] [--http-port N] [--device cuda|cpu]``.

Counterpart of ``dynamo_tpu.launch.run`` for its main path: an OpenAI
completions server over the canonical pipeline link preprocessor →
backend (detokenizer) → engine, with the engine's KV flags. The model
directory holds ``config.json`` and a tokenizer (``tokenizer.model`` for
the native SentencePiece engine, or ``tokenizer.json`` where the
``tokenizers`` package is installed). Checkpoint loading is not ported yet,
so ``--random-weights`` (weights from ``EngineConfig.seed`` on the
device) is required.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from typing import Tuple

logger = logging.getLogger("dynamo_tpu_torch.launch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo-tpu-torch-run",
        description="PyTorch/CUDA LLM serving launcher (in=http out=torch)")
    p.add_argument("io", nargs="*", metavar="in=|out=",
                   help="in=http out=torch")
    p.add_argument("--model-path", required=True,
                   help="HF-style model dir (config.json + tokenizer)")
    p.add_argument("--model-name", help="served model name "
                                        "(default: basename of model path)")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--no-prefix-reuse", action="store_true")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from EngineConfig.seed (checkpoint "
                        "loading is not implemented yet)")
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
    if src != "http" or out != "torch":
        raise SystemExit(f"only in=http out=torch is implemented (got "
                         f"in={src} out={out})")
    return src, out


def model_name(args) -> str:
    return args.model_name or os.path.basename(
        os.path.normpath(args.model_path))


def build_core(args):
    """EngineCore from CLI flags (random bf16 weights, seed 0)."""
    from ..engine.config import EngineConfig, ModelConfig
    from ..engine.core import EngineCore
    if not args.random_weights:
        raise SystemExit("checkpoint loading is not implemented yet: pass "
                         "--random-weights")
    try:
        ecfg = EngineConfig(max_model_len=args.max_model_len,
                            kv_block_size=args.kv_block_size,
                            num_kv_blocks=args.num_kv_blocks,
                            max_num_seqs=args.max_num_seqs,
                            enable_prefix_reuse=not args.no_prefix_reuse)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    model_cfg = ModelConfig.from_model_dir(args.model_path)
    return EngineCore(model_cfg, ecfg, device=args.device)


def build_pipeline(args, core):
    """(pipeline, card): preprocessor → backend → TorchEngine(core)."""
    from ..llm.backend import Backend
    from ..llm.engines.torch_engine import TorchEngine
    from ..llm.model_card import ModelDeploymentCard
    from ..llm.preprocessor import OpenAIPreprocessor
    from ..runtime import link
    mdc = ModelDeploymentCard.from_local_path(args.model_path,
                                              display_name=model_name(args))
    return link(OpenAIPreprocessor(mdc), Backend(mdc), TorchEngine(core)), mdc


async def serve(args, core, ready=None) -> None:
    """Serve completions until cancelled; calls ``ready.set()`` (an
    ``asyncio.Event`` or a ``threading.Event``) once listening."""
    from ..llm.http import HttpService
    pipeline, _ = build_pipeline(args, core)
    svc = HttpService(port=args.http_port, host=args.http_host)
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
        await core.stop()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    parse_io(args.io)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        core = build_core(args)
    except RuntimeError as e:     # no CUDA device and --device cuda
        raise SystemExit(str(e))
    try:
        asyncio.run(serve(args, core))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
