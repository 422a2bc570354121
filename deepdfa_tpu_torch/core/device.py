"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A request
for CUDA on a machine without it raises: the port never carries on
silently on the CPU, where every timing would describe the wrong
machine.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means "cuda". Raises RuntimeError when CUDA is asked for
    and `torch.cuda.is_available()` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
