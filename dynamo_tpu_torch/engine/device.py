"""Device selection shared by every entry point of the package.

Entry points run on the card by default (``device="cuda"``). Without a
CUDA device they raise instead of silently moving to the CPU; the CPU is
used only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda|cpu)")
    return dev
