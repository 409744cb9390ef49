"""Engine-internal request/response protocol.

Reference: lib/llm/src/protocols/common.rs:43-650 (StopConditions,
SamplingOptions, OutputOptions, FinishReason) and common/llm_backend.rs:20-127
(BackendInput/BackendOutput/LLMEngineOutput). These are the types that flow
between the OpenAI preprocessor, the detokenizing Backend operator, and the
model engine — token ids in, token ids (+ optional text) out.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class FinishReason(str, enum.Enum):
    """Reference FinishReason (protocols/common.rs): why a stream ended."""

    EOS = "eos"
    LENGTH = "length"
    STOP = "stop"
    ERROR = "error"
    CANCELLED = "cancelled"
    TOOL_CALLS = "tool_calls"

    def to_openai(self) -> str:
        if self in (FinishReason.EOS, FinishReason.STOP):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        if self is FinishReason.TOOL_CALLS:
            return "tool_calls"
        return "error" if self is FinishReason.ERROR else "stop"


@dataclasses.dataclass
class StopConditions:
    """Reference StopConditions (protocols/common.rs:43+)."""

    max_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    stop: Optional[List[str]] = None
    stop_token_ids_hidden: Optional[List[int]] = None
    ignore_eos: bool = False

    def apply_ignore_eos(self) -> None:
        """ignore_eos means the hidden EOS stop-ids must not fire
        (reference common.rs `apply_ignore_eos`)."""
        if self.ignore_eos:
            self.stop_token_ids_hidden = []


@dataclasses.dataclass
class SamplingOptions:
    """Reference SamplingOptions (protocols/common.rs)."""

    n: int = 1
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    greedy: bool = False


@dataclasses.dataclass
class OutputOptions:
    """Reference OutputOptions: what the engine should attach per token."""

    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    echo: bool = False
    skip_special_tokens: bool = True


@dataclasses.dataclass
class PreprocessedRequest:
    """The canonical engine input (reference ``PreprocessedRequest`` =
    ``BackendInput``, lib/llm/src/protocols/common/preprocessor.rs:25)."""

    token_ids: List[int]
    stop_conditions: StopConditions = dataclasses.field(default_factory=StopConditions)
    sampling_options: SamplingOptions = dataclasses.field(default_factory=SamplingOptions)
    output_options: OutputOptions = dataclasses.field(default_factory=OutputOptions)
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    mdc_sum: Optional[str] = None
    annotations: List[str] = dataclasses.field(default_factory=list)
    # Disaggregation extensions (ours; reference carries these in nvext /
    # RemotePrefillParams, container/deps/vllm patch:3584-3645):
    prefix_hit_len: int = 0
    estimated_prefix_hit_blocks: int = 0
    # Speculative decoding (engine/spec/, docs/speculative.md): max
    # draft tokens verified per step for this request. None = the
    # engine's live default (llmctl spec set-k); 0 = explicitly off;
    # n > 0 clamps to the engine's compiled maximum (EngineConfig
    # spec_k). Surfaces as nvext.speculation on the OpenAI edge.
    speculation: Optional[int] = None
    # Multi-tenant serving plane (llm/tenancy.py, appended — DL004
    # append-only evolution): tenant id + QoS class ("interactive" |
    # "standard" | "batch") from nvext.tenant/nvext.priority — the
    # router's fair-share admission and the KV tiers' per-tenant quota
    # accounting key on these; session_id (nvext.session_id) groups
    # requests so exported traces preserve prefix-reuse structure
    # (tools/fleetsim.py export-trace). None = the implicit single
    # tenant (old senders decode unchanged).
    tenant_id: Optional[str] = None
    qos: Optional[str] = None
    session_id: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        """Wire decode for the token protocol (processor → worker hop)."""
        d = dict(d)
        if isinstance(d.get("stop_conditions"), dict):
            d["stop_conditions"] = StopConditions(**d["stop_conditions"])
        if isinstance(d.get("sampling_options"), dict):
            d["sampling_options"] = SamplingOptions(**d["sampling_options"])
        if isinstance(d.get("output_options"), dict):
            d["output_options"] = OutputOptions(**d["output_options"])
        return cls(**d)


BackendInput = PreprocessedRequest


@dataclasses.dataclass
class BackendOutput:
    """One step of engine output (reference ``BackendOutput`` /
    ``LLMEngineOutput``, common/llm_backend.rs:20-127)."""

    token_ids: List[int] = dataclasses.field(default_factory=list)
    tokens: Optional[List[str]] = None
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    log_probs: Optional[List[float]] = None
    top_logprobs: Optional[List[Dict[int, float]]] = None
    finish_reason: Optional[FinishReason] = None
    # serving metrics piggybacked on the final chunk
    kv_transfer_us: Optional[int] = None

    @classmethod
    def final(cls, reason: FinishReason) -> "BackendOutput":
        return cls(finish_reason=reason)

    @classmethod
    def from_dict(cls, d: dict) -> "BackendOutput":
        d = dict(d)
        if d.get("finish_reason") is not None:
            d["finish_reason"] = FinishReason(d["finish_reason"])
        return cls(**d)


LLMEngineOutput = BackendOutput

