"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: they take
`device=` (default "cuda") and raise when no CUDA device is present. They
never carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
