"""What the four probe modules share: the pattern table, the kernel wrapper,
the reference's three checks, and the run loop.

Each probe module has, per pattern, a ``Spec`` (the reference's printed
name, the input and output shapes and dtypes, the tolerance), a plain
PyTorch version in ``PLAIN`` and a hand-written kernel in the module's
``csrc/<source>.cu`` (the copy patterns share ``probe_common.cuh``'s
``stage_kernel``), reached through one C entry
``dlq_<source>(pattern, a, b, c, out, s1, s2, stream)`` whose ``pattern``
is the key's index in the module's ``SPEC``.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and counts each launch on ``.launches`` and, per pattern key,
on ``.by_shape``. ``run`` is the counterpart of the reference's ``run``
helper: it runs each pattern once, holds it against the reference's numpy
expectation with the reference's own check, on the card also against its
plain version (``held``), prints ``[OK]/[FAIL] name: ...`` and returns one
``Result`` per pattern. Unlike the reference's helper it catches nothing:
a build or launch error propagates.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlq_tpu_torch import _build
from dlq_tpu_torch.device import DeviceLike, resolve_device
from dlq_tpu_torch.timing import time_fn

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Spec:
    """One pattern. ``atol``: the reference's tolerance against its numpy
    expectation, by the probe's check. Against its plain version the kernel
    must be identical where ``exact`` (integer outputs, copies, exact bf16
    scaling), else within ``held``'s limits. ``flops`` counts
    tensor-core operations (2 per multiply-add) at ``peak`` ("int8" or
    "bf16"); ``read_bytes`` the input bytes the function reads where it
    reads a window of its input (None: every input once). ``scalars`` are
    the probe's fp32 constants (``s1``, ``s2`` of the C entry). ``library``
    names the one PyTorch call that computes the same function, or why there
    is none."""
    name: str
    ins: Tuple[Tuple[Shape, torch.dtype], ...]
    out: Tuple[Shape, torch.dtype]
    exact: bool
    atol: float
    flops: float = 0.0
    peak: str = ""
    read_bytes: Optional[int] = None
    scalars: Tuple[float, float] = (0.0, 0.0)
    library: str = ""


# --- the reference's checks: (got, expect, atol) -> (ok, printed text) -----

def _as_f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        t = t.float() if t.dtype == torch.bfloat16 else t
        t = t.numpy()
    return np.asarray(t).astype(np.float64)


def check_max_abs_below(got, expect, atol):
    """probe_mosaic_patterns: ``max|got - expect| < atol`` in fp32, finite."""
    g = got.detach().cpu().float().numpy()
    err = float(np.abs(g - np.asarray(expect, np.float32)).max())
    return err < atol and bool(np.isfinite(g).all()), f"max_abs={err:.3g}"


def check_rel(got, expect, atol):
    """probe_batched_dot: ``max|got - expect| / max|expect| <= atol``."""
    g, e = _as_f64(got), _as_f64(expect)
    err = float(np.abs(g - e).max())
    rel = err / max(1e-9, float(np.abs(e).max()))
    return rel <= atol and bool(np.isfinite(g).all()), f"rel={rel:.3g}"


def check_max_abs(got, expect, atol):
    """probe_block_patterns, probe_stem_patterns: ``max|got - expect| <= atol``."""
    g, e = _as_f64(got), _as_f64(expect)
    err = float(np.abs(g - e).max())
    return err <= atol and bool(np.isfinite(g).all()), f"max_abs={err:.3g}"


def bf16(a: np.ndarray) -> torch.Tensor:
    """A float64 draw as bf16, through fp32 (as ``jnp.asarray(a, bf16)``
    converts it with 64-bit mode off)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def i8(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int8))


def copy_of(view: torch.Tensor) -> torch.Tensor:
    """The plain version of a copy pattern: ``view``'s elements, contiguous."""
    return torch.empty(view.shape, dtype=view.dtype, device=view.device).copy_(view)


# a kernel against its plain version where the pattern is not exact: both
# sum in fp32 in different orders. On the H100 an fp32 output read rel
# <= 4.2e-7 of max|plain| (rounding it to bf16 reads ~3e-3), and a bf16
# output one bf16 step on <= 0.05% of its elements (attention probabilities
# left unrounded differ on 9-42%)
PLAIN_REL = 1e-4
PLAIN_SHARE = 0.01


def held(got: torch.Tensor, ref: torch.Tensor, spec: Spec) -> Tuple[bool, str, float]:
    """The kernel against its plain version: identical where ``spec.exact``;
    else an fp32 output within ``PLAIN_REL`` of max|plain|, and a bf16
    output within one bf16 step of max|plain| everywhere and different on at
    most ``PLAIN_SHARE`` of its elements. Returns (ok, text, max abs
    difference)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False, f"{tuple(got.shape)} {got.dtype} against {tuple(ref.shape)} {ref.dtype}", \
            float("inf")
    g, r = got.double(), ref.double()
    err = float((g - r).abs().max())
    if spec.exact:
        same = torch.equal(got, ref)
        return same, "identical" if same else f"differs max_abs={err:.3g}", err
    finite = bool(torch.isfinite(g).all())
    top = float(r.abs().max())
    if got.dtype == torch.float32:
        rel = err / max(1e-9, top)
        return finite and rel <= PLAIN_REL, f"rel={rel:.3g} (limit {PLAIN_REL:g})", err
    if got.dtype != torch.bfloat16:
        raise TypeError(f"{spec.name}: no limit against the plain version for {got.dtype}")
    step = 2.0 ** (math.frexp(top)[1] - 8) if top else 0.0   # bf16: 8 significant bits
    share = float((g != r).double().mean())
    ok = finite and err <= step and share <= PLAIN_SHARE
    return ok, (f"max_abs={err:.3g} share={share:.3g} (limits one step = {step:.3g}, "
                f"share {PLAIN_SHARE:g})"), err


# --- the kernel wrapper -----------------------------------------------------

@functools.cache
def _entry(source: str):
    lib = _build.library(source)
    prepare = getattr(lib, f"dlq_{source}_prepare")
    prepare.restype = ctypes.c_int
    prepare.argtypes = []
    _build.check(prepare(), f"{source} prepare")
    fn = getattr(lib, f"dlq_{source}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_args(source: str, key: str, spec: Spec, xs: Sequence[torch.Tensor]) -> None:
    if len(xs) != len(spec.ins):
        raise ValueError(f"{source} {key}: {len(spec.ins)} inputs expected, got {len(xs)}")
    dev = xs[0].device
    for x, (shape, dtype) in zip(xs, spec.ins):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{source} {key}: every input must lie on one CUDA device")
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{source} {key}: input {tuple(x.shape)} {x.dtype} "
                             f"(contiguous {x.is_contiguous()}), the kernel takes "
                             f"{shape} {dtype} contiguous")


def make_wrapper(source: str, spec: Dict[str, Spec], plain: Dict[str, Callable]):
    """The module's kernel wrapper ``fn(key, *inputs)``: the plain version
    ``plain[key]`` for CPU tensors, the kernel for CUDA tensors."""
    keys = tuple(spec)

    def wrapper(key: str, *xs: torch.Tensor) -> torch.Tensor:
        if key not in spec:
            raise KeyError(f"{source}: no pattern {key!r} (patterns: {keys})")
        if all(x.device.type == "cpu" for x in xs):
            return plain[key](*xs)
        s = spec[key]
        _check_args(source, key, s, xs)
        out = torch.empty(s.out[0], dtype=s.out[1], device=xs[0].device)
        ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
        rc = _entry(source)(keys.index(key), *ptrs, out.data_ptr(), s.scalars[0],
                            s.scalars[1], _build.stream_ptr(xs[0].device))
        _build.check(rc, f"{source} {key}")
        wrapper.launches += 1
        wrapper.by_shape[key] += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = source
    wrapper.prepare = lambda: _entry(source)   # build and load the library, no launch
    wrapper.launches = 0
    wrapper.by_shape = collections.Counter()
    return wrapper


def nbytes(spec: Spec, xs: Sequence[torch.Tensor]) -> int:
    """Bytes the pattern must move: its input (or the window it reads) once
    and its output once."""
    out = int(np.prod(spec.out[0])) * torch.empty((), dtype=spec.out[1]).element_size()
    read = spec.read_bytes if spec.read_bytes is not None else sum(
        x.numel() * x.element_size() for x in xs)
    return read + out


# --- the run loop -----------------------------------------------------------

Case = Tuple[str, Tuple[torch.Tensor, ...], np.ndarray]
SPIN_CYCLES = 40_000_000   # ~20 ms of device spin at the H100's ~2 GHz


def spun_ms(fn: Callable[[], object], iters: int = 1, warmup: int = 0, reps: int = 1) -> float:
    """Device ms per call of ``fn()`` (``time_fn``'s median window), with the
    card spinning while the host enqueues each window; raises if the host
    took longer than the spin, as the window would then time the host."""
    r = time_fn(fn, iters=iters, warmup=warmup, reps=reps, spin_cycles=SPIN_CYCLES)
    if r["enqueue_ms_max"] >= r["spin_ms_min"]:
        raise RuntimeError(f"enqueue {r['enqueue_ms_max']} ms outlasted the spin "
                           f"{r['spin_ms_min']} ms")
    return r["ms_median"]


@dataclasses.dataclass
class Result:
    """One pattern's run: its inputs and output on the device, the reference's
    check against the numpy expectation (``vs_expect``) and, on the card,
    ``held`` against the plain version (``vs_plain``, ``err``) and the
    device time of that one launch (``ms``)."""
    key: str
    spec: Spec
    xs: Tuple[torch.Tensor, ...]
    got: torch.Tensor
    ok: bool
    vs_expect: str
    vs_plain: Optional[str] = None
    err: Optional[float] = None
    ms: Optional[float] = None


def run(wrapper, spec: Dict[str, Spec], plain: Dict[str, Callable], cases: Sequence[Case],
        check, device: DeviceLike = None) -> List[Result]:
    """Run every pattern once on ``device`` (None: the card) and print the
    reference's line for it; on the card the line also holds the kernel
    against its plain version and gives the device time of that one launch.
    Returns one ``Result`` per pattern."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        wrapper.prepare()
    results = []
    for key, inputs, expect in cases:
        s = spec[key]
        xs = tuple(x.to(dev) for x in inputs)
        res = Result(key, s, xs, None, False, "")
        if dev.type == "cuda":
            outs = []
            res.ms = spun_ms(lambda: outs.append(wrapper(key, *xs)))
            res.got = outs[0]
        else:
            res.got = wrapper(key, *xs)
        res.ok, res.vs_expect = check(res.got, expect, s.atol)
        text = res.vs_expect
        if dev.type == "cuda":
            same, res.vs_plain, res.err = held(res.got, plain[key](*xs), s)
            res.ok = res.ok and same
            text += f" vs_plain={res.vs_plain} ms={res.ms:.4f}"
        print(f"[{'OK' if res.ok else 'FAIL'}] {s.name}: {text}", flush=True)
        results.append(res)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={dev.type} ({name}) fails={fails(results)}", flush=True)
    return results


def fails(results: Sequence[Result]) -> int:
    return sum(not r.ok for r in results)


def cli(main: Callable[..., int], argv=None) -> int:
    """``python -m dlq_tpu_torch.tools.probe_<name> [--device cpu]``; exit
    status 1 when any pattern failed."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    return 1 if main(device=args.device) else 0
