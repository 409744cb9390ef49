"""The launcher: ``python -m dynamo_tpu_torch.launch.run in=http out=torch
--model-path DIR [--random-weights] [--http-port N] [--device cuda|cpu]
[--quantization int8|int4|...] [--kv-quantization int8] [--ragged
[--ragged-max-tokens N] [--ragged-max-seq-rows N]] [--sp N]
[--prefill-chunk N] [--decode-steps-per-dispatch K
[--decode-dispatch-pipeline] [--lane-prefill-max-tokens N]]``.

Counterpart of ``dynamo_tpu.launch.run`` for its main path: an OpenAI
completions server over the canonical pipeline link preprocessor →
backend (detokenizer) → engine, with the engine's KV flags. The model
directory holds ``config.json`` and a tokenizer (``tokenizer.model`` for
the native SentencePiece engine, or ``tokenizer.json`` where the
``tokenizers`` package is installed) and the checkpoint's
``*.safetensors``, loaded onto the device in the engine's dtype and
quantization (``engine/weights.py``); ``--random-weights`` serves weights
from ``EngineConfig.seed`` instead. A directory whose checkpoint does not
load exits non-zero with the loader's message.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from typing import Tuple

from ..engine.config import KV_QUANTIZATIONS, WEIGHT_QUANTIZATIONS

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
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="tokens per KV block (0 = auto-select)")
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=8)
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
    p.add_argument("--sequence-parallel-size", "--sp", type=int, default=1,
                   dest="sp",
                   help="sequence-parallel prefill of long cold prompts "
                        "(ring attention) over the first SP cards, or over "
                        "SP shards on the CPU with --device cpu")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from EngineConfig.seed instead "
                        "of the model directory's checkpoint")
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
