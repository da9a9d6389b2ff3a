"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there is no
silent fallback, so a run that meant to measure the card cannot end up
measuring the CPU's plain versions.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and CUDA
    is not available; pass ``device="cpu"`` to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: dlq_tpu_torch entry points run on the card "
            "by default; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
