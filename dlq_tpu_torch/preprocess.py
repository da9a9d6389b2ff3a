"""ImageNet normalization constants and the uint8 preprocess fold (the port's
copy of ``dlq_tpu/data/preprocess.py:16-17`` and of the fold its deploy
stems apply, ``dlq_tpu/quant/model_quant.py:581`` and
``dlq_tpu/ops/pallas_vit_block.py:704-716``).

A normalized image is ``x = (u / 255 - mean) / std = (u - 255 mean) / (255
std)``, so a conv on it equals a conv of ``u - 255 mean`` against weights
scaled by ``1 / (255 std_c)`` along the input channel; zero padding of the
shifted image is zero padding of ``x``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def fold_u8(w_hwio: torch.Tensor, u8: torch.Tensor, mean: Optional[np.ndarray] = None,
            std: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fold as its jitted forwards compute it, held in fp32:
    the fp32 HWIO weight times ``1 / (255 std)`` (fp32) along I, rounded to
    bf16, and the image ``u - bf16(255 mean)``. The reference writes that
    difference as a bf16 subtraction, but XLA fuses it into the conv and
    keeps it unrounded (its default excess precision), where it is exact in
    fp32. A conv of the two in fp32 (TF32 off) is the reference's conv with
    fp32 sums."""
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    inv = np.float32(1.0) / (np.float32(255.0) * std)
    inv_t = torch.from_numpy(inv).to(w_hwio.device)
    w = (w_hwio.float() * inv_t[:, None]).to(torch.bfloat16).float()
    m255 = torch.from_numpy(np.float32(255.0) * mean).to(u8.device).to(torch.bfloat16)
    x = u8.float() - m255.float()
    return w, x
