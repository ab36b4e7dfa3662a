"""Where an entry point runs: the card unless the caller asks for the
CPU, and never the CPU in place of a missing card."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and no
    card is present (the caller must pass ``device="cpu"`` to run the
    plain PyTorch versions instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
