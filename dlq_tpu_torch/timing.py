"""Per-stage timing and CUDA-event kernel timing.

``StageTimer`` accumulates host-clock milliseconds per named stage; a stage
that passes tensors to ``sync_result`` waits for the device before the
clock stops. ``time_fn`` times a callable on the card with CUDA events after
a warmup: events bracket ``iters`` back-to-back calls on the current
stream, so the figure is device time per call, not enqueue time. It needs
a card and raises without one.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Any, Dict

import torch


def _sync(x: Any) -> Any:
    """Wait for the device if ``x`` holds CUDA tensors."""
    leaves = x if isinstance(x, (list, tuple)) else [x]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return x


class StageTimer:
    """Accumulates wall milliseconds per named stage across calls."""

    def __init__(self):
        self.ms: "OrderedDict[str, float]" = OrderedDict()
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_result: Any = None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync_result is not None:
                _sync(sync_result)
            self.add(name, (time.perf_counter() - t0) * 1e3)

    def sync(self, x: Any) -> Any:
        return _sync(x)

    def add(self, name: str, ms: float) -> None:
        self.ms[name] = self.ms.get(name, 0.0) + ms
        self.calls[name] = self.calls.get(name, 0) + 1

    def total_ms(self) -> float:
        return sum(self.ms.values())

    def report(self, title: str = "timing") -> str:
        """Per-stage table: ms, calls, % of total."""
        total = self.total_ms() or 1.0
        w = max([len(k) for k in self.ms] + [5])
        lines = [f"== {title} ==", f"{'stage':<{w}}  {'ms':>12}  {'calls':>6}  {'%':>6}"]
        for k, v in self.ms.items():
            lines.append(f"{k:<{w}}  {v:>12.3f}  {self.calls[k]:>6}  {100*v/total:>5.1f}%")
        lines.append(f"{'TOTAL':<{w}}  {total:>12.3f}")
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {"stages_ms": dict(self.ms), "calls": dict(self.calls),
                "total_ms": self.total_ms()}


def time_fn(fn, *args, iters: int = 20, warmup: int = 3, reps: int = 3, spin_cycles: int = 0,
            **kw) -> Dict[str, float]:
    """Device milliseconds per call of ``fn(*args, **kw)``: after ``warmup``
    calls, ``reps`` windows of ``iters`` calls each, bracketed by CUDA
    events; returns the median, best and mean window average.

    A call much shorter than its host-side cost (a kernel of a few
    microseconds behind a Python wrapper) leaves the card waiting on the
    host, and the window then times the host. With ``spin_cycles`` the card
    first spins that many clock cycles, so the host enqueues the whole
    window while the card is busy and the events bracket device time; the
    result then also gives the longest host enqueue of a window and the
    shortest spin (``enqueue_ms_max``, ``spin_ms_min``): the window is
    device time only where the first is below the second."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures on the card; CUDA is not available")
    for _ in range(warmup):
        fn(*args, **kw)
    torch.cuda.synchronize()
    samples, enqueue, spin = [], [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            spun = torch.cuda.Event(enable_timing=True)
            spun.record()
            t0 = time.perf_counter()
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn(*args, **kw)
        end.record()
        if spin_cycles:
            enqueue.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
        if spin_cycles:
            spin.append(spun.elapsed_time(start))
    samples.sort()
    out = {"ms_median": samples[len(samples) // 2], "ms_best": samples[0],
           "ms_mean": sum(samples) / len(samples), "iters": float(iters)}
    if spin_cycles:
        out.update(enqueue_ms_max=max(enqueue), spin_ms_min=min(spin))
    return out
