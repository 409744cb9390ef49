"""Tool-calling: request-side choice validation + response-side matching
(a copy of ``dynamo_tpu.llm.tools``).

Reference: lib/llm/src/preprocessor/tools{.rs,/request.rs,/response.rs} —
``ToolCallingMatcher`` parses an LLM's final message as JSON in the shapes
models actually emit ({"name", "parameters"} or {"name", "arguments"},
singly or as a list) and produces OpenAI ``tool_calls`` entries. Tool
*rendering* happens in the chat template (the HF templates take a ``tools``
kwarg — PromptFormatter.render passes it through).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Dict, List, Optional, Union

__all__ = ["ToolChoice", "ToolCallingMatcher"]


class ToolChoice:
    """Normalized ``tool_choice``: none | auto | required | a named tool
    (reference tools/request.rs)."""

    NONE = "none"
    AUTO = "auto"
    REQUIRED = "required"

    def __init__(self, raw: Union[str, Dict[str, Any], None],
                 has_tools: bool):
        self.forced_name: Optional[str] = None
        if isinstance(raw, dict):
            # only the OpenAI named-tool shape is valid:
            # {"type": "function", "function": {"name": ...}}
            name = (raw.get("function") or {}).get("name")
            if raw.get("type") != "function" or not isinstance(name, str):
                raise ValueError(f"invalid tool_choice object: {raw!r}")
            self.mode = self.REQUIRED
            self.forced_name = name
        elif raw in (self.NONE, self.AUTO, self.REQUIRED):
            self.mode = raw
        elif raw is None:
            # OpenAI default: auto when tools are present, none otherwise
            self.mode = self.AUTO if has_tools else self.NONE
        else:
            raise ValueError(f"invalid tool_choice: {raw!r}")

    @property
    def active(self) -> bool:
        return self.mode != self.NONE


def _as_call(name: str, args: Dict[str, Any]) -> dict:
    return {
        "id": f"call-{uuid.uuid4()}",
        "type": "function",
        "function": {"name": name, "arguments": json.dumps(args)},
    }


class ToolCallingMatcher:
    """Parse a complete assistant message into tool calls.

    Accepted shapes (reference tools.rs:53-115):
    - ``{"name": n, "parameters": {...}}`` and a list of those
    - ``{"name": n, "arguments": {...}}`` and a list of those

    Returns [] when the message isn't a tool call; raises when a specific
    tool was forced (`tool_choice = {"type": "function", ...}` or
    "required") but nothing parseable came back.
    """

    def __init__(self, choice: ToolChoice):
        self.choice = choice

    @staticmethod
    def _parse_one(obj: Any) -> Optional[dict]:
        if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
            return None
        for key in ("parameters", "arguments"):
            if isinstance(obj.get(key), dict):
                return _as_call(obj["name"], obj[key])
        return None

    def get_calls(self, message: str) -> List[dict]:
        if not self.choice.active:
            return []
        try:
            data = json.loads(message.strip())
        except (json.JSONDecodeError, ValueError):
            data = None
        calls: List[dict] = []
        if data is not None:
            items = data if isinstance(data, list) else [data]
            parsed = [self._parse_one(x) for x in items]
            if parsed and all(p is not None for p in parsed):
                calls = parsed  # type: ignore[assignment]
        if not calls and self.choice.mode == ToolChoice.REQUIRED:
            raise ValueError(
                "tool choice was required but no tool was called")
        if (self.choice.forced_name
                and any(c["function"]["name"] != self.choice.forced_name
                        for c in calls)):
            raise ValueError(
                f"model called a tool other than the forced "
                f"{self.choice.forced_name!r}")
        return calls
