"""The port's probes (K19-K22, through their plain versions on the CPU)
against the reference's ``tools/probe_*.py``.

Each reference probe is loaded by path and its ``main()`` run once per
module (interpret-mode Pallas on the CPU, as its own run there does), with
``jax.experimental.pallas.pallas_call`` and ``jax.jit`` shimmed to record
each pattern's ``pallas_call`` callable and the concrete inputs it was first
called with. Every reference line must print ``[OK]``. Then, per pattern,
the port's plain version on the port's inputs and the recorded JAX kernel
under ``jax.jit`` on the same inputs (converted to jnp):

  * integer, copy and exact-scaling patterns: equal bit for bit (block O
    too, which is one step off the reference's own float64 expectation);
  * float patterns: within the reference's own tolerance by its own check
    (mosaic 3, 5, 6: ``max_abs < 2e-2``; batched A, B, D: ``rel <= 2e-2``).
    Measured on the CPU: mosaic 3 max_abs 3.8e-6, 5 equal, 6 max_abs
    0.00049 (one bf16 step of a few outputs); batched A rel 1.4e-7, B rel
    2.6e-7, D rel 0.0019 (max_abs 0.0078, one bf16 step).

On the card each kernel is held against its plain version by a limit of
its own, far tighter than the reference's (``_probe.held``): the limit
passes a float64 re-computation of each float pattern and refuses the
faults it is there to catch (an fp32 output rounded to bf16, attention
probabilities not rounded to bf16, a tanh truncated to bf16). Each library
yardstick computes its pattern's function: identical for the copies and
stem E, within two bf16 steps of max|plain| for the bf16 calls.

Per probe also: the port's inputs equal the reference's draws bit for bit,
``main(device="cpu")`` returns 0 and prints the reference's pattern names in
order, all ``[OK]``, and a perturbed plain version makes ``main`` return
nonzero. One subprocess imports the four modules and finds neither ``jax``
nor ``dlq_tpu`` loaded.
"""

import contextlib
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools import probe_batched_dot as TB
from dlq_tpu_torch.tools import probe_block_patterns as TK
from dlq_tpu_torch.tools import probe_mosaic_patterns as TM
from dlq_tpu_torch.tools import probe_stem_patterns as TS

REPO = Path(__file__).resolve().parent.parent
PROBES = {"probe_mosaic_patterns": TM, "probe_batched_dot": TB,
          "probe_block_patterns": TK, "probe_stem_patterns": TS}
CASES = [(tool, key) for tool, mod in PROBES.items() for key in mod.SPEC]
LIBRARY_CASES = [(tool, key) for tool, mod in PROBES.items() for key in mod.LIBRARY]


def _record(tool):
    """Run ``tools/<tool>.py``'s main(); returns (its printed lines,
    [[pallas_call callable, the concrete inputs of its first call], ...])."""
    real_pc, real_jit = jpl.pallas_call, jax.jit
    recs = []

    def pallas_call(*a, **k):
        f = real_pc(*a, **k)
        recs.append([f, None])
        return f

    def jit(f, *a, **k):
        j = real_jit(f, *a, **k)
        rec = next((r for r in recs if r[0] is f), None)
        if rec is None:
            return j

        def call(*args):
            if rec[1] is None:
                rec[1] = args
            return j(*args)

        return call

    spec = importlib.util.spec_from_file_location(f"_reference_{tool}", REPO / "tools" / f"{tool}.py")
    mod = importlib.util.module_from_spec(spec)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLQ_COMPILE_CACHE", "off")   # the probe would enable a cache under ~
        mp.delenv("DLQ_PLATFORM", raising=False)
        mp.setattr(jpl, "pallas_call", pallas_call)
        mp.setattr(jax, "jit", jit)
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(buf):
            mod.main()
    return buf.getvalue().splitlines(), recs


@pytest.fixture(scope="module")
def reference():
    """tool -> (lines, records), each probe run once for the module."""
    cache = {}

    def get(tool):
        if tool not in cache:
            cache[tool] = _record(tool)
        return cache[tool]

    return get


@pytest.fixture(scope="module")
def port_cases():
    """tool -> {key: (inputs, expectation)}, each probe's cases made once."""
    cache = {}

    def get(tool):
        if tool not in cache:
            cache[tool] = {k: (xs, e) for k, xs, e in PROBES[tool].cases()}
        return cache[tool]

    return get


def _to_jnp(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _bits(a) -> np.ndarray:
    """The array's raw bits (bf16 as uint16), for bit-for-bit equality."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("tool", list(PROBES))
def test_reference_probe_all_ok(reference, tool):
    """The reference probe itself prints one [OK] line per pattern."""
    lines, recs = reference(tool)
    status = [ln for ln in lines if ln.startswith("[")]
    assert len(status) == len(PROBES[tool].SPEC) == len(recs)
    assert all(ln.startswith("[OK] ") for ln in status), status


@pytest.mark.parametrize("tool", list(PROBES))
def test_inputs_equal_reference_draws(reference, port_cases, tool):
    """The port's inputs are the reference's draws, bit for bit (bf16 made
    from float64 through fp32, as ``jnp.asarray`` makes them)."""
    _, recs = reference(tool)
    mod = PROBES[tool]
    for key, (fn, args) in zip(mod.SPEC, recs):
        xs, _ = port_cases(tool)[key]
        assert args is not None and len(args) == len(xs)
        for x, a in zip(xs, args):
            assert tuple(x.shape) == tuple(a.shape)
            assert np.array_equal(_bits(x), _bits(a)), f"{tool} {key}"


@pytest.mark.parametrize("tool,key", CASES)
def test_pattern_matches_jax_kernel(reference, port_cases, tool, key):
    """The port's plain version against the recorded JAX kernel on the same
    inputs: bit for bit where the pattern is exact, else within the
    reference's tolerance by the reference's check."""
    mod = PROBES[tool]
    spec = mod.SPEC[key]
    _, recs = reference(tool)
    fn = recs[list(mod.SPEC).index(key)][0]
    xs, _ = port_cases(tool)[key]
    got = mod.PLAIN[key](*xs)
    want = jax.jit(fn)(*[_to_jnp(x) for x in xs])
    assert tuple(got.shape) == tuple(want.shape) == spec.out[0]
    assert got.dtype == spec.out[1]
    if spec.exact:
        assert np.asarray(want).dtype.itemsize == got.element_size()
        assert np.array_equal(_bits(got), _bits(want)), f"{tool} {key}"
    else:
        ok, text = mod.CHECK(got, np.asarray(want).astype(np.float64), spec.atol)
        assert ok, f"{tool} {key}: {text}"


def test_block_o_follows_the_kernel_not_its_expectation(port_cases):
    """Block O: the port's fp32 product equals the reference's kernel (the
    case above) and sits one step off the probe's float64 expectation."""
    xs, expect = port_cases("probe_block_patterns")["O"]
    got = TK.PLAIN["O"](*xs).numpy().astype(np.float64)
    assert np.abs(got - expect).max() == 1.0


@pytest.mark.parametrize("tool", list(PROBES))
def test_main_on_cpu(reference, tool, capsys):
    """``main(device="cpu")`` passes every pattern, printing the reference's
    pattern names in its order."""
    assert PROBES[tool].main(device="cpu") == 0
    ours = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    lines, _ = reference(tool)
    theirs = [ln.split(":")[0] for ln in lines if ln.startswith("[")]
    assert ours == theirs


@pytest.mark.parametrize("tool", list(PROBES))
def test_perturbed_plain_fails_main(monkeypatch, tool, capsys):
    """A plain version that is off (by 2 in its last pattern) makes main()
    count one FAIL: no failure is swallowed."""
    mod = PROBES[tool]
    key = list(mod.SPEC)[-1]
    right = mod.PLAIN[key]
    monkeypatch.setitem(mod.PLAIN, key, lambda *xs: right(*xs) + 2)
    assert mod.main(device="cpu") == 1
    assert f"[FAIL] {mod.SPEC[key].name}" in capsys.readouterr().out


def test_modules_import_no_jax():
    """The four modules import neither jax nor dlq_tpu."""
    code = ("import sys\n"
            "import dlq_tpu_torch.tools.probe_mosaic_patterns, dlq_tpu_torch.tools.probe_batched_dot\n"
            "import dlq_tpu_torch.tools.probe_block_patterns, dlq_tpu_torch.tools.probe_stem_patterns\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dlq_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _attention_variant(q, k, v, scale, n_valid, dtype, round_p):
    """One head of mosaic 6 / batched D in ``dtype``; ``round_p``: the
    probabilities rounded to bf16 before a v, as the kernels do."""
    q, k, v = (t.to(dtype) for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * scale
    s[..., n_valid:] = -1e30
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a = p / p.sum(-1, keepdim=True)
    a = a.to(torch.bfloat16).to(dtype) if round_p else a
    return (a @ v).to(torch.bfloat16)


def _mosaic6(dtype, round_p):
    def f(qkv):
        out = torch.empty((256, 256), dtype=torch.bfloat16)
        for h in range(4):
            q, k, v = (qkv[:, o + 64 * h: o + 64 * h + 64] for o in (0, 256, 512))
            out[:, 64 * h: 64 * h + 64] = _attention_variant(q, k, v, 0.125, 197, dtype, round_p)
        return out
    return f


def _batched_d(dtype, round_p):
    def f(x):
        y = x.reshape(8, 200, 576)
        out = torch.zeros((8, 200, 192), dtype=torch.bfloat16)
        out[..., :64] = _attention_variant(y[..., 0:64], y[..., 64:128], y[..., 128:192], 1.0,
                                           200, dtype, round_p)
        return out
    return f


def _truncated_tanh(x):
    """tanh in fp32 cut to bf16 by dropping the low 16 bits (no rounding)."""
    bits = torch.tanh(x.float()).view(torch.int32) & -65536
    return bits.view(torch.float32).to(torch.bfloat16)


F64 = torch.float64
# (tool, key, variant, name): re-computations in float64 the limit passes,
# and faults it refuses
LIMIT_CASES = [
    ("probe_mosaic_patterns", "3", lambda q, k: q.double() @ k.double().t(), "f64"),
    ("probe_mosaic_patterns", "3", lambda q, k: (q.float() @ k.float().t()).bfloat16().float(),
     "bf16 out"),
    ("probe_mosaic_patterns", "5", lambda x: torch.tanh(x.double()).to(torch.bfloat16), "f64"),
    ("probe_mosaic_patterns", "5", _truncated_tanh, "truncated"),
    ("probe_mosaic_patterns", "6", _mosaic6(F64, True), "f64"),
    ("probe_mosaic_patterns", "6", _mosaic6(torch.float32, False), "p unrounded"),
    ("probe_batched_dot", "A", lambda q, k: torch.bmm(q.double(), k.double().transpose(1, 2)),
     "f64"),
    ("probe_batched_dot", "A", lambda q, k: torch.bmm(q.float(), k.float().transpose(1, 2))
     .bfloat16().float(), "bf16 out"),
    ("probe_batched_dot", "B", lambda a, v: torch.bmm(a.double(), v.double()), "f64"),
    ("probe_batched_dot", "B", lambda a, v: torch.bmm(a.float(), v.float()).half().float(),
     "fp16 out"),
    ("probe_batched_dot", "D", _batched_d(F64, True), "f64"),
    ("probe_batched_dot", "D", _batched_d(torch.float32, False), "p unrounded"),
]


@pytest.mark.parametrize("tool,key,variant,name", LIMIT_CASES,
                         ids=[f"{t}-{k}-{n}" for t, k, _, n in LIMIT_CASES])
def test_plain_limit(port_cases, tool, key, variant, name):
    """``_probe.held``'s limit for a float pattern against its plain version:
    a float64 re-computation passes (it rounds like a kernel that sums in
    another order), the fault fails. On the H100: mosaic 3 and batched A/B
    rel <= 4.2e-7, mosaic 5 identical, mosaic 6 and batched D one bf16 step
    (``PERF.md``)."""
    mod = PROBES[tool]
    spec = mod.SPEC[key]
    xs, _ = port_cases(tool)[key]
    got, ref = variant(*xs), mod.PLAIN[key](*xs)
    ok, text, _ = _probe.held(got.to(ref.dtype), ref, spec)
    assert ok == (name == "f64"), f"{tool} {key} {name}: {text}"


@pytest.mark.parametrize("tool,key", LIBRARY_CASES)
def test_library_computes_the_pattern(port_cases, tool, key):
    """Each library yardstick computes its pattern's function on the same
    inputs: identical where its output dtype is the pattern's, within two
    bf16 steps of max|plain| where it rounds to bf16 (bf16 ``matmul``,
    ``tanh``, SDPA on the attention columns)."""
    mod = PROBES[tool]
    xs, _ = port_cases(tool)[key]
    got, ref = mod.LIBRARY[key](*xs), mod.PLAIN[key](*xs)
    if key == "6" and tool == "probe_mosaic_patterns":
        got = got.transpose(1, 2).reshape(256, 256)
    if key == "D" and tool == "probe_batched_dot":
        got, ref = got[:, 0], ref[..., :64]
    assert tuple(got.shape) == tuple(ref.shape)
    if got.dtype == ref.dtype and mod.SPEC[key].exact:
        assert torch.equal(got, ref)
    else:
        assert got.dtype == torch.bfloat16
        top = float(ref.double().abs().max())
        err = float((got.double() - ref.double()).abs().max())
        assert err <= 2 * 2.0 ** (np.frexp(top)[1] - 8), f"{err} at max {top}"


@pytest.mark.parametrize("outlasted", [0, 1, _probe.SPIN_TRIES - 1, _probe.SPIN_TRIES])
def test_spun_ms_retimes_what_the_host_outlasted(monkeypatch, outlasted):
    """``spun_ms`` returns only a timing whose host enqueue stayed inside
    the spin: one the host outlasted is taken again with twice the spin,
    and after ``SPIN_TRIES`` outlasted timings it raises, returning none of
    them. ``time_fn`` is replaced by a stand-in whose first ``outlasted``
    timings the host outlasts."""
    calls = []

    def time_fn(fn, iters, warmup, reps, spin_cycles):
        calls.append(spin_cycles)
        late, spin = len(calls) <= outlasted, 20.0 * spin_cycles / _probe.SPIN_CYCLES
        return {"ms_median": 99.0 if late else 0.5,
                "enqueue_ms_max": 2 * spin if late else 1.0, "spin_ms_min": spin}

    monkeypatch.setattr(_probe, "time_fn", time_fn)
    if outlasted == _probe.SPIN_TRIES:
        with pytest.raises(RuntimeError, match="outlasted the spin in every timing"):
            _probe.spun_ms(lambda: None, 20, warmup=2, reps=3)
    else:
        assert _probe.spun_ms(lambda: None, 20, warmup=2, reps=3) == 0.5
    assert calls == [_probe.SPIN_CYCLES * 2 ** i for i in range(min(outlasted + 1, _probe.SPIN_TRIES))]
