"""Numeric-diff metrics and acceptance gates (same definitions as
``dlq_tpu.numerics``: max_abs / mean_abs / cosine / relative L2, and top-k
agreement, the per-stage ``StageReport``). Inputs may be numpy arrays or
tensors on any device."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# fp32 reorder tolerance of the reference's acceptance gates
DEFAULT_ATOL = 1e-4


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Diff:
    max_abs: float
    mean_abs: float
    cosine: float
    rel_l2: float

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"max_abs={self.max_abs:.6e} mean_abs={self.mean_abs:.6e} "
            f"cosine={self.cosine:.8f} rel_l2={self.rel_l2:.6e}"
        )


def diff(got, expect) -> Diff:
    """max_abs / mean_abs / cosine / relative-L2 between two arrays."""
    a = _np(got).astype(np.float64).ravel()
    b = _np(expect).astype(np.float64).ravel()
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    cos = float(a @ b / (na * nb)) if na > 0 and nb > 0 else (1.0 if na == nb else 0.0)
    rel = float(np.linalg.norm(a - b) / nb) if nb > 0 else float(na > 0)
    return Diff(
        max_abs=float(d.max()) if d.size else 0.0,
        mean_abs=float(d.mean()) if d.size else 0.0,
        cosine=cos,
        rel_l2=rel,
    )


def check(got, expect, atol: float = DEFAULT_ATOL, what: str = "") -> Diff:
    """Acceptance gate: raises AssertionError iff max_abs > atol."""
    d = diff(got, expect)
    if d.max_abs > atol:
        raise AssertionError(f"[FAIL] {what}: {d} (atol={atol:g})")
    return d


def top1_agreement(logits_a, logits_b) -> float:
    """Fraction of rows whose argmax agrees."""
    a, b = _np(logits_a), _np(logits_b)
    if a.ndim == 1:
        a, b = a[None], b[None]
    return float(np.mean(np.argmax(a, -1) == np.argmax(b, -1)))


def topk_agreement(logits_a, logits_b, k: int = 5) -> float:
    """Fraction of rows whose top-``k`` classes under ``logits_a`` hold the
    argmax of ``logits_b``."""
    a, b = _np(logits_a), _np(logits_b)
    if a.ndim == 1:
        a, b = a[None], b[None]
    ta = np.argsort(-a, axis=-1)[:, :k]
    ref = np.argmax(b, -1)[:, None]
    return float(np.mean(np.any(ta == ref, axis=-1)))


@dataclasses.dataclass
class StageReport:
    """Per-stage diff table."""

    stages: Dict[str, Diff] = dataclasses.field(default_factory=dict)

    def add(self, name: str, got, expect) -> Diff:
        d = diff(got, expect)
        self.stages[name] = d
        return d

    def worst(self) -> Optional[str]:
        if not self.stages:
            return None
        return max(self.stages, key=lambda s: self.stages[s].max_abs)

    def to_json(self) -> Dict[str, Dict[str, float]]:
        return {k: v.to_json() for k, v in self.stages.items()}

    def __str__(self) -> str:
        w = max((len(s) for s in self.stages), default=0)
        return "\n".join(f"{s:<{w}}  {d}" for s, d in self.stages.items())
