"""Device resolution (the port's counterpart of core/jaxconfig.py).

Every entry point takes an explicit `device`.  Asking for CUDA where there
is no card raises: the port never falls back to the CPU silently, so a
measurement that names the card really ran on it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` -> torch.device; raises RuntimeError for CUDA without a card.

    Also pins the float32 matmul/convolution precision to full float32.
    Nothing on the assembler's path multiplies floats; the setting is stated
    once so that no later kernel inherits TF32 by accident."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
