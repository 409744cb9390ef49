"""Speculative decoding: a host-side drafter proposes up to k tokens a
sequence, the engine scores all k + 1 positions in one verify dispatch
(``engine/programs.py`` ``VerifyProgram``, or spec spans of the ragged
program's row-sampled form), and acceptance is lockstep token equality.

Counterpart of ``dynamo_tpu.engine.spec`` (a copy: the modules are pure
Python). Every position samples with the key plain decode would use at
that stream index, so accepted streams equal plain decode's, greedy and
seeded alike.

- ``drafter.py``: the ``Drafter`` interface, the n-gram
  ``PromptLookupDrafter`` and the acceptance rule ``accept_lockstep``;
- ``admin.py``: the KV-store key and value of the live draft budget.
"""

from .admin import SPEC_PREFIX, SpecConfig, spec_config_key
from .drafter import Drafter, PromptLookupDrafter, accept_lockstep

__all__ = [
    "Drafter", "PromptLookupDrafter", "accept_lockstep",
    "SPEC_PREFIX", "SpecConfig", "spec_config_key",
]
