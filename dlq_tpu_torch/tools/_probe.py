"""What the four probe modules share: the pattern table, the kernel wrapper,
the reference's three checks, the run loop, and the plans of the three
Hopper forms the probes share (``stage_plan``, ``attention_plan``,
``nt_dot_plan``).

Each probe module has, per pattern, a ``Spec`` (the reference's printed
name, the input and output shapes and dtypes, the tolerance), a plain
PyTorch version in ``PLAIN`` and a hand-written kernel in the module's
``csrc/<source>.cu`` (the copy patterns share ``probe_common.cuh``'s
``stage_kernel``, the NT dots its ``nt_dot_hopper_kernel``, the attention
patterns its ``attention_kernel``),
reached through one C entry ``dlq_<source>(pattern, a, b, c, out, s1, s2,
stream)`` whose ``pattern`` is the key's index in the module's ``SPEC``.
The patterns in the module's ``FIRST_FORMS`` run on a redesigned Hopper
form; their first forms stay callable through ``dlq_<source>_first``.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and counts each launch on ``.launches``, per pattern key on
``.by_shape``, and, for a redesigned pattern, on ``.by_form["hopper"]``;
``wrapper.first(key, *xs)`` launches the first form, counted on
``.by_form["first"]`` only. A pattern whose ``Spec`` is ``settable`` takes
the caller's fp32 scale (``scale=``) in place of the probe's. ``run`` is the
counterpart of the reference's ``run`` helper: it runs each pattern once,
holds it against the
reference's numpy expectation with the reference's own check, on the card
also against its plain version (``held``), prints ``[OK]/[FAIL] name:
...`` and returns one ``Result`` per pattern. Unlike the reference's helper
it catches nothing: a build or launch error propagates.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import math
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    the probe's fp32 constants (``s1``, ``s2`` of the C entry); where
    ``settable``, a caller may give its own ``s1`` (``fn(key, *xs,
    scale=s)``), which the plain version takes as ``scale``. ``library``
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
    settable: bool = False
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

_ENTRY_ARGS = ((ctypes.c_int,) + (ctypes.c_void_p,) * 4
               + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p))


@functools.cache
def _lib(source: str):
    lib = _build.library(source)
    prepare = getattr(lib, f"dlq_{source}_prepare")
    prepare.restype = ctypes.c_int
    prepare.argtypes = []
    _build.check(prepare(), f"{source} prepare")
    return lib


@functools.cache
def _fn(source: str, suffix: str, argtypes: tuple):
    fn = getattr(_lib(source), f"dlq_{source}{suffix}")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _entry(source: str, suffix: str = ""):
    """``dlq_<source>`` (the Hopper forms), or with ``suffix="_first"`` the
    first forms of the redesigned patterns."""
    return _fn(source, suffix, _ENTRY_ARGS)


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


def make_wrapper(source: str, spec: Dict[str, Spec], plain: Dict[str, Callable],
                 first_forms: Sequence[str] = ()):
    """The module's kernel wrapper ``fn(key, *inputs)``: the plain version
    ``plain[key]`` for CPU tensors, the kernel for CUDA tensors; the patterns
    in ``first_forms`` run on their Hopper form, and ``fn.first(key,
    *inputs)`` runs their first form."""
    keys = tuple(spec)

    def s1_of(key: str, scale: Optional[float]) -> float:
        if scale is None:
            return spec[key].scalars[0]
        if not spec[key].settable:
            raise ValueError(f"{source} {key}: the pattern takes no scale from the caller")
        return float(np.float32(scale))

    def launch(suffix: str, key: str, xs: Sequence[torch.Tensor],
               scale: Optional[float]) -> torch.Tensor:
        s = spec[key]
        _check_args(source, key, s, xs)
        out = torch.empty(s.out[0], dtype=s.out[1], device=xs[0].device)
        ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
        rc = _entry(source, suffix)(keys.index(key), *ptrs, out.data_ptr(), s1_of(key, scale),
                                    s.scalars[1], _build.stream_ptr(xs[0].device))
        _build.check(rc, f"{source}{suffix} {key}")
        return out

    def wrapper(key: str, *xs: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
        if key not in spec:
            raise KeyError(f"{source}: no pattern {key!r} (patterns: {keys})")
        if all(x.device.type == "cpu" for x in xs):
            s1_of(key, scale)
            return plain[key](*xs) if scale is None else plain[key](*xs, scale=scale)
        out = launch("", key, xs, scale)
        wrapper.launches += 1
        wrapper.by_shape[key] += 1
        if key in first_forms:
            wrapper.by_form["hopper"] += 1
        return out

    def first(key: str, *xs: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
        """The first form of redesigned pattern ``key`` (CUDA tensors only):
        what the card tests and ``chip_smoke.py`` hold the Hopper form to;
        counted on ``by_form["first"]`` only."""
        if key not in first_forms:
            raise KeyError(f"{source}: {key!r} has no first form "
                           f"(redesigned: {tuple(first_forms)})")
        out = launch("_first", key, xs, scale)
        wrapper.by_form["first"] += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = source
    wrapper.prepare = lambda: _lib(source)   # build and load the library, no launch
    wrapper.first = first
    wrapper.launches = 0
    wrapper.by_shape = collections.Counter()
    wrapper.by_form = collections.Counter()
    return wrapper


# --- the Hopper forms' plans (probe_common.cuh) ------------------------------

class Window(NamedTuple):
    """A copy pattern: out [I][J][E bytes], contiguous, from the input's
    bytes at base + i*si + j*sj + e (``probe_common.cuh``'s ``Window``)."""
    base: int
    si: int
    sj: int
    I: int  # noqa: E741
    J: int
    E: int


STAGE_THREADS = 256
STAGE_SHARE = 16 * STAGE_THREADS   # output bytes a block: one 16-byte granule a thread
STAGE_MODES = ("g16", "g8", "halves")   # the C side's StageMode 0, 1, 2 (-1: refused)
SMEM_MAX = 232448


class StagePlan(NamedTuple):
    mode: Optional[str]   # None: refused
    grid: int
    threads: int
    smem: int
    flat: Window          # the window the kernel walks: the same bytes, flattened


def flatten(w: Window) -> Window:
    """``w`` with its pieces merged where they touch (sj == E: one piece a
    row), then its rows (one piece a row and si == E: one row)."""
    if w.J > 1 and w.sj == w.E:
        w = w._replace(E=w.E * w.J, J=1, sj=0)
    if w.J == 1 and w.I > 1 and w.si == w.E:
        w = w._replace(E=w.E * w.I, I=1, si=0)
    return w


def stage_plan(w: Window) -> StagePlan:
    """``stage_kernel``'s launch (``probe_common.cuh: stage_plan``): a block
    per 4 KB share of the output, one 16-byte output granule a thread, on
    the flattened window. The source granules: ``g16``, one 16-byte copy
    (E, base, si, sj multiples of 16); ``halves``, the 4-byte pieces at
    bytes 4..7 of each 8-byte group of 16-byte-aligned rows (E 4, sj 8, base
    4 mod 16), two 16-byte copies whose words 1 and 3 are kept; ``g8``, two
    8-byte copies (multiples of 8). Shared memory: the block's staged bytes
    (two granules a thread for ``halves``)."""
    refused = StagePlan(None, 0, STAGE_THREADS, 0, w)
    row = w.J * w.E
    if (min(w.I, w.J, w.E) < 1 or min(w.base, w.si, w.sj) < 0 or row % 16
            or row * w.I >= 2 ** 31):
        return refused
    f = flatten(w)
    if all(v % 16 == 0 for v in (f.E, f.base, f.si, f.sj)):
        mode = "g16"
    elif f.E == 4 and f.sj == 8 and f.base % 16 == 4 and f.si % 16 == 0:
        mode = "halves"
    elif all(v % 8 == 0 for v in (f.E, f.base, f.si, f.sj)):
        mode = "g8"
    else:
        return refused
    grid = -(-(row * w.I // 16) // STAGE_THREADS)
    return StagePlan(mode, grid, STAGE_THREADS, STAGE_SHARE * (2 if mode == "halves" else 1), f)


def stage_sources(w: Window, granules: torch.Tensor) -> torch.Tensor:
    """The kernel's index math on the flattened window: for each output
    granule o (16 bytes at output byte 16 o), the source byte offset of each
    byte it stages, [n, 16] (32 for ``halves``: its two aligned granules
    whole), in staging order."""
    plan = stage_plan(w)
    if plan.mode is None:
        raise ValueError(f"stage_kernel refuses {w}")
    f = plan.flat
    if f.I > 1:
        rg = f.J * f.E // 16
        i = granules // rg
        q = 16 * (granules - i * rg)
    else:
        i, q = torch.zeros_like(granules), 16 * granules
    r = f.base + i * f.si

    def piece(qq):
        if f.J == 1:
            return r + qq
        j = qq // f.E
        return r + j * f.sj + (qq - j * f.E)

    if plan.mode == "halves":
        return (r + 2 * q - 4)[:, None] + torch.arange(32)
    if plan.mode == "g16":
        return piece(q)[:, None] + torch.arange(16)
    halves = (piece(q)[:, None] + torch.arange(8), piece(q + 8)[:, None] + torch.arange(8))
    return torch.cat(halves, 1)


def stage_apply(src: torch.Tensor, w: Window, times2: bool = False) -> torch.Tensor:
    """``stage_kernel`` block by block in torch on the flat bytes ``src``
    (uint8): each block's threads stage their granules' source bytes, keep
    words 1 and 3 of each staged 16 bytes for ``halves``, double the bf16
    values where ``times2``, and store 16 bytes at their output granule.
    Returns the output's bytes."""
    plan = stage_plan(w)
    total = w.I * w.J * w.E // 16
    out = torch.empty(16 * total, dtype=torch.uint8)
    for b in range(plan.grid):
        o = torch.arange(b * plan.threads, min(total, (b + 1) * plan.threads))
        staged = src[stage_sources(w, o)]
        if plan.mode == "halves":
            staged = staged.view(-1, 8, 4)[:, 1::2].reshape(-1, 16)
        if times2:
            staged = (staged.contiguous().view(torch.bfloat16) * 2).view(torch.uint8)
        out[(16 * o)[:, None] + torch.arange(16)] = staged
    return out


ATTN_TILE = 64     # query rows a block (4 warps of 16)
ATTN_CHUNK = 64    # keys a TMA box (and an mbarrier)
ATTN_BOX = 64 * 128


class AttnPlan(NamedTuple):
    grid: Tuple[int, int]   # (query tiles, units)
    threads: int
    chunks: int
    smem: int


def attention_plan(rows: int, units: int, key_tiles: int) -> AttnPlan:
    """``attention_kernel``'s launch (``probe_common.cuh: AttnPlan``): a block
    of 4 warps per (64-row query tile, unit); keys padded to key_tiles x 8 in
    64-key chunks, one TMA box each; shared memory 1,024 bytes of room to
    align the swizzled boxes, the Q box, the K and V chunks, and an mbarrier
    for Q, each K chunk and V."""
    chunks = -(-key_tiles * 8 // ATTN_CHUNK)
    return AttnPlan((-(-rows // ATTN_TILE), units), 128, chunks,
                    1024 + (1 + 2 * chunks) * ATTN_BOX + (chunks + 2) * 8)


NT_ROWS = 16         # output rows a block, and q rows a box
NT_COLS = 32         # output columns a block, and k rows a box
NT_ROW_BYTES = 128   # bytes of a box row: 64 bf16


class NtTile(NamedTuple):
    """One block of ``nt_dot_hopper_kernel``: sample ``b``, output rows
    ``m0 ..`` and columns ``n0 ..``, and its two warps, each (first row,
    first column, whether it runs: a warp whose 16 rows or 16 columns lie
    wholly past M or N does no products)."""
    b: int
    m0: int
    n0: int
    warps: Tuple[Tuple[int, int, bool], ...]


def nt_dot_plan(batch: int, m: int, n: int) -> List[NtTile]:
    """``nt_dot_hopper_kernel``'s grid (x: column tile, y: row tile, z:
    sample), block by block: 16 x 32 outputs, warp w owning the 16 rows at
    m0 + 16 (w >> 1) and the 16 columns at n0 + 16 (w & 1); a running warp
    stores no row >= m and no column >= n."""
    tiles = []
    for b in range(batch):
        for mt in range(-(-m // NT_ROWS)):
            for nt in range(-(-n // NT_COLS)):
                m0, n0 = mt * NT_ROWS, nt * NT_COLS
                warps = tuple((m0 + 16 * (w >> 1), n0 + 16 * (w & 1),
                               m0 + 16 * (w >> 1) < m and n0 + 16 * (w & 1) < n)
                              for w in range(NT_ROWS // 16 * 2))
                tiles.append(NtTile(b, m0, n0, warps))
    return tiles


def nt_dot_launch(batch: int, m: int, n: int) -> Tuple[int, ...]:
    """(grid x, y, z, threads, tile rows, tile columns, bytes of the q and k
    boxes): what the C side's ``dlq_<probe>_nt_plan`` reports."""
    return (-(-n // NT_COLS), -(-m // NT_ROWS), batch, 32 * (NT_ROWS // 16 * 2), NT_ROWS, NT_COLS,
            (NT_ROWS + NT_COLS) * NT_ROW_BYTES)


# --- the C side's plans, windows and odd windows (card only) -----------------

def c_window(source: str, key_index: int) -> Tuple[Window, bool]:
    """Pattern ``key_index``'s window and op (x 2 in bf16) in ``source``'s C
    table (``kStaged``)."""
    v = (ctypes.c_longlong * 7)()
    fn = _fn(source, "_window", (ctypes.c_int, ctypes.c_void_p))
    _build.check(fn(key_index, ctypes.cast(v, ctypes.c_void_p)), f"{source} window {key_index}")
    return Window(*v[:6]), bool(v[6])


def c_stage_plan(source: str, w: Window) -> StagePlan:
    """``probe_common.cuh``'s ``stage_plan`` of ``w``, as ``source`` computes it."""
    v = (ctypes.c_longlong * 6)(*w)
    plan = (ctypes.c_longlong * 10)()
    fn = _fn(source, "_stage_plan", (ctypes.c_void_p, ctypes.c_void_p))
    _build.check(fn(ctypes.cast(v, ctypes.c_void_p), ctypes.cast(plan, ctypes.c_void_p)),
                 f"{source} stage_plan")
    mode = STAGE_MODES[plan[0]] if plan[0] >= 0 else None
    return StagePlan(mode, *plan[1:4], Window(*plan[4:10]))


def c_plan(source: str, name: str, n: int) -> Tuple[int, ...]:
    """The ``n`` ints ``source``'s ``dlq_<source>_<name>`` entry reports (a
    Hopper form's launch constants)."""
    v = (ctypes.c_int * n)()
    fn = _fn(source, f"_{name}", (ctypes.c_void_p,))
    _build.check(fn(ctypes.cast(v, ctypes.c_void_p)), f"{source} {name}")
    return tuple(v)


def stage_window(source: str, x: torch.Tensor, w: Window, times2: bool = False,
                 first: bool = False) -> torch.Tensor:
    """Window ``w`` of the CUDA tensor ``x``'s bytes on ``stage_kernel`` (or
    its first form), as uint8 [I * J * E]; a window the form refuses
    raises. Not counted: no pattern of a probe run."""
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("stage_window: a contiguous CUDA tensor")
    out = torch.empty(w.I * w.J * w.E, dtype=torch.uint8, device=x.device)
    v = (ctypes.c_longlong * 6)(*w)
    fn = _fn(source, "_stage", (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 4)
    rc = fn(int(first), int(times2), ctypes.cast(v, ctypes.c_void_p), x.data_ptr(),
            out.data_ptr(), _build.stream_ptr(x.device))
    _build.check(rc, f"{source} stage {w}")
    return out


def differing(got: torch.Tensor, ref: torch.Tensor) -> int:
    """The outputs of ``got`` whose bits differ from ``ref``'s, a NaN against
    a NaN counting as equal whatever its bits."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise ValueError(f"{tuple(got.shape)} {got.dtype} against {tuple(ref.shape)} {ref.dtype}")
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    differ = got.view(as_int) != ref.view(as_int)
    if got.is_floating_point():
        differ &= ~(torch.isnan(got) & torch.isnan(ref))
    return int(differ.sum())


def exhaustive(fn, spec: Dict[str, Spec], plain: Dict[str, Callable], cases) -> List[dict]:
    """Each case (label, key, input, scale or None) on the Hopper form, the
    first form and the plain version: the outputs differing from the first
    form bit for bit (NaN for NaN), and from the plain version, bit for bit
    where the pattern is exact, else by ``held`` on the outputs of the
    non-NaN inputs with every NaN input giving NaN. One row each, ``ok``
    where nothing differs from the first form and the plain version holds."""
    rows = []
    for label, key, x, scale in cases:
        got, first = fn(key, x, scale=scale), fn.first(key, x, scale=scale)
        ref = plain[key](x) if scale is None else plain[key](x, scale=scale)
        d_first, d_plain = differing(got, first), differing(got, ref)
        if spec[key].exact:
            ok_plain, text = d_plain == 0, "identical" if d_plain == 0 else "differs"
        else:
            nan = torch.isnan(x) if x.is_floating_point() else torch.zeros_like(x, dtype=torch.bool)
            ok_plain, text, _ = held(got[~nan], ref[~nan], spec[key])
            nan_kept = bool(torch.isnan(got[nan]).all() and torch.isnan(ref[nan]).all())
            ok_plain = ok_plain and nan_kept
            text += f" nan_inputs={int(nan.sum())} nan_out={nan_kept}"
        rows.append({"case": label, "pattern": key, "outputs": got.numel(),
                     "differing_from_first": d_first, "differing_from_plain": d_plain,
                     "vs_plain": text, "ok": d_first == 0 and ok_plain})
    return rows


def launch_floor_ms(source: str = "probe_mosaic") -> float:
    """One empty kernel's device ms under ``spun_ms``'s timing: what any of
    the probes' microsecond launches costs at the least."""
    fn = _fn(source, "_empty", (ctypes.c_void_p,))
    st = _build.stream_ptr(torch.device("cuda"))
    return spun_ms(lambda: _build.check(fn(st), f"{source} empty"), 20, warmup=2, reps=3)


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
SPIN_TRIES = 3             # timings a call gets, the spin doubled after each one the host outlasted


def spun_ms(fn: Callable[[], object], iters: int = 1, warmup: int = 0, reps: int = 1) -> float:
    """Device ms per call of ``fn()`` (``time_fn``'s median window), with the
    card spinning while the host enqueues each window. A timing in which the
    host took longer than the spin timed the host, not the card: it is
    thrown away and taken again with twice the spin (a stall of the host,
    such as a shared core taken away for tens of ms, outlasts 20 ms of
    spin), each such timing named on stderr; raises if the host outlasts
    the spin in all ``SPIN_TRIES``."""
    cycles, outlasted = SPIN_CYCLES, []
    for _ in range(SPIN_TRIES):
        r = time_fn(fn, iters=iters, warmup=warmup, reps=reps, spin_cycles=cycles)
        if r["enqueue_ms_max"] < r["spin_ms_min"]:
            return r["ms_median"]
        outlasted.append(f"enqueue {r['enqueue_ms_max']} ms against spin {r['spin_ms_min']} ms")
        print(f"spun_ms: timing again, the host outlasted the spin: {outlasted[-1]}",
              file=sys.stderr)
        cycles *= 2
    raise RuntimeError("the host outlasted the spin in every timing: " + "; ".join(outlasted))


LIBRARY_ROUNDS = 5   # rounds of (kernel, library, library, kernel): ten alternating pairs


def library_turns(fn, key, lib, xs, rounds: int = LIBRARY_ROUNDS) -> dict:
    """A pattern and its one PyTorch call timed in turns, ``rounds`` rounds of
    (kernel, library, library, kernel), device time on a spinning card: two
    alternating pairs a round (kernel-library and library-kernel), each read
    within one stretch of the card's clocks. Returns the times, each pair's
    kernel / library ratio, their median and the pairs the kernel lost
    (slower than the library call)."""
    calls = {"kernel": lambda: fn(key, *xs), "library": lambda: lib(*xs)}
    times = {"kernel": [], "library": []}
    for _ in range(rounds):
        for tag in ("kernel", "library", "library", "kernel"):
            times[tag].append(spun_ms(calls[tag], 20, warmup=2, reps=3))
    ratios = [k / b for k, b in zip(times["kernel"], times["library"])]
    return {**times, "ratios": ratios, "median_ratio": float(np.median(ratios)),
            "pairs": len(ratios), "pairs_kernel_lost": sum(r > 1.0 for r in ratios)}


def first_form_turns(fn, key, xs, rounds: int = 1) -> dict:
    """A redesigned pattern against its first form: equal on every output
    (raises otherwise), then device time on a spinning card in turns,
    ``rounds`` rounds of (first, Hopper, Hopper, first)."""
    hop, first = fn(key, *xs), fn.first(key, *xs)
    if differing(hop, first):
        raise AssertionError(f"{fn.__name__} {key}: the Hopper form differs from its first form "
                             f"at {differing(hop, first)} outputs")
    times = {"first": [], "hopper": []}
    for _ in range(rounds):
        for tag in ("first", "hopper", "hopper", "first"):
            call = fn.first if tag == "first" else fn
            times[tag].append(spun_ms(lambda: call(key, *xs), 20, warmup=2, reps=3))
    return {"equal_to_first_form": True, "first_form_ms": times["first"],
            "hopper_in_turns_ms": times["hopper"]}


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
