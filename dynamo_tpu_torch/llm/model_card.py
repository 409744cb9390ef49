"""Model Deployment Card (MDC): the model metadata preprocessing needs.

Counterpart of ``dynamo_tpu.llm.model_card`` for the completions path:
the tokenizer artifact, context length, vocab size and EOS/BOS ids, read
from an HF-style model directory (reference ``ModelDeploymentCard``,
lib/llm/src/model_card/model.rs, and its construction from a local repo,
model_card/create.rs). The chat template is not read: chat completions
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from .tokenizer import load_tokenizer, read_special_token_ids


@dataclasses.dataclass
class ModelInfo:
    """Reference model_card `ModelInfo`: generation-relevant config."""

    model_type: str = "llama"
    context_length: int = 4096
    vocab_size: int = 0
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    bos_token_id: Optional[int] = None


@dataclasses.dataclass
class ModelDeploymentCard:
    display_name: str
    service_name: str
    model_path: Optional[str] = None
    tokenizer_file: Optional[str] = None
    model_info: ModelInfo = dataclasses.field(default_factory=ModelInfo)

    _tokenizer: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)

    def tokenizer(self):
        if self._tokenizer is None:
            src = self.tokenizer_file or self.model_path
            if src is None:
                raise RuntimeError(f"MDC {self.display_name} has no tokenizer artifact")
            self._tokenizer = load_tokenizer(src)
        return self._tokenizer

    @classmethod
    def from_local_path(cls, model_dir: str,
                        display_name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build from an HF-style directory: the tokenizer (tokenizer.json,
        else a SentencePiece tokenizer.model), config.json and
        generation_config.json / tokenizer_config.json for the special ids."""
        name = display_name or os.path.basename(os.path.normpath(model_dir))
        card = cls(display_name=name, service_name=name, model_path=model_dir)
        tok_file = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tok_file):
            card.tokenizer_file = tok_file
        tk = card.tokenizer()
        specials = read_special_token_ids(model_dir, tk)
        cfg: Dict[str, Any] = {}
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        card.model_info = ModelInfo(
            model_type=cfg.get("model_type", "llama"),
            context_length=int(cfg.get("max_position_embeddings", 4096)),
            vocab_size=int(cfg.get("vocab_size", tk.vocab_size)),
            eos_token_ids=specials["eos_token_ids"],
            bos_token_id=specials["bos_token_id"],
        )
        return card
