"""Quantization configuration dataclasses (same fields, checks and presets
as ``dlq_tpu.quant.qconfig``, so a store's ``qconfig`` block reads into
either package)."""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QScheme:
    """How one tensor class (weights or activations) is quantized.

    bits:      8 (int8), 4 (int4), or 2 (int2, stored as int8 values)
    symmetric: symmetric (zero_point=0) vs affine
    axis:      per-channel axis in the tensor's stored layout; None = per-tensor.
               For HWIO conv weights and IO dense weights the output-channel
               axis is -1.
    group:     group size along the contraction (input-channel) axis for
               group-wise scales; None = whole axis.
    """

    bits: int = 8
    symmetric: bool = True
    axis: Optional[int] = -1
    group: Optional[int] = None

    def __post_init__(self):
        if self.bits not in (2, 4, 8):
            raise ValueError(f"bits must be 2, 4 or 8, got {self.bits}")
        if self.bits != 8 and not self.symmetric:
            raise ValueError("sub-8-bit paths are symmetric-only")

    @property
    def qmax(self) -> int:
        return {8: 127, 4: 7, 2: 1}[self.bits]

    @property
    def qmin(self) -> int:
        if self.symmetric:
            return -self.qmax
        return -(2 ** (self.bits - 1))


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Whole-model PTQ recipe."""

    weights: QScheme = QScheme(bits=8, symmetric=True, axis=-1)
    acts: Optional[QScheme] = QScheme(bits=8, symmetric=True, axis=None)  # None => weight-only
    calibration: str = "minmax"  # "minmax" | "percentile" | "mse"
    percentile: float = 99.99
    # mixed precision: (fnmatch pattern, scheme) pairs consulted in order;
    # first match wins, else `weights`
    weight_overrides: Tuple[Tuple[str, QScheme], ...] = ()

    @property
    def weight_only(self) -> bool:
        return self.acts is None

    def scheme_for(self, site: str) -> QScheme:
        """Weight scheme for one site (mixed-precision lookup)."""
        for pattern, scheme in self.weight_overrides:
            if fnmatch.fnmatch(site, pattern):
                return scheme
        return self.weights


INT8_PER_TENSOR = QConfig(weights=QScheme(8, True, None), acts=QScheme(8, True, None))
INT8_PER_CHANNEL = QConfig(weights=QScheme(8, True, -1), acts=QScheme(8, True, None))
INT4_WEIGHT_ONLY_G128 = QConfig(weights=QScheme(4, True, -1, group=128), acts=None)
INT4_WEIGHT_ONLY_PER_OC = QConfig(weights=QScheme(4, True, -1), acts=None)
INT4A8_PER_CHANNEL = QConfig(weights=QScheme(4, True, -1), acts=QScheme(8, True, None))
