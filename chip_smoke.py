"""Smoke run of the PyTorch/CUDA port on one GPU (ResNet-18 W8A8, 224 px).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, one JSON line each:
  1. environment: torch, nvcc, the card's name and power limit, kernel build time;
  2. every kernel (K1 conv_int8, K2 matmul_int8, K3 basic_block) at every
     distinct shape the main paths give it at batch 256, held against its plain
     PyTorch version on the card (int8 and fp32 outputs bit-identical), with
     CUDA-event times of the kernel, the plain version, the library call
     where one exists, and the least time the card could take (the bound);
  3. the main path: ResNet-18 (seeded random weights) calibrated and quantized
     with Engine.quantized, saved as a store, loaded with
     Engine.from_store(ctx="fused2") and driven through classify; gates as
     bench.py: top-1 agreement 1.0 and logits cosine >= 0.999 against the
     port's fp32 engine; launch counts per forward; the stem's own time;
     then a torch.profiler window over a few forwards (device time by
     kernel, device idle share);
  4. the same store under PallasBlockCtx (identity blocks as K3), with
     its own profile;
  5. ctx="deploy" and ctx="pallas" at batch 64.
Then the card's name and power limit, the kernel summary line and, last,
{"ok": true, "device": {...}}. Any failed gate raises before those lines.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 (hopper-kernels guide table)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
BATCH = 256
SEED = 0
NO_INT8_CONV = "none: no PyTorch call computes an int8 conv with int32 accumulation on CUDA"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_row(row) -> None:
    emit({k: v for k, v in row.items() if k != "key"})


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters=20, warmup=2, reps=3) -> float:
    from dlq_tpu_torch.timing import time_fn

    return time_fn(fn, iters=iters, warmup=warmup, reps=reps)["ms_median"]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def conv_cases():
    """Every (geometry, epilogue) K1 gets on the fused2 / block main paths of
    ResNet-18 at 224 px: (H, C, OC, k, stride, relu, int8_out, launches per
    fused2 forward, launches per PallasBlockCtx forward)."""
    return [
        (56, 64, 64, 3, 1, True, True, 2, 2),       # layer1.x.conv1
        (56, 64, 64, 3, 1, False, True, 2, 2),      # layer1.x.conv2
        (56, 64, 128, 3, 2, True, True, 1, 1),      # layer2.0.conv1
        (56, 64, 128, 1, 2, False, True, 1, 1),     # layer2.0.down
        (28, 128, 128, 3, 1, True, True, 1, 0),     # layer2.1.conv1
        (28, 128, 128, 3, 1, False, True, 2, 1),    # layer2.0.conv2, layer2.1.conv2
        (28, 128, 256, 3, 2, True, True, 1, 1),     # layer3.0.conv1
        (28, 128, 256, 1, 2, False, True, 1, 1),    # layer3.0.down
        (14, 256, 256, 3, 1, True, True, 1, 0),     # layer3.1.conv1
        (14, 256, 256, 3, 1, False, True, 2, 1),    # layer3.0.conv2, layer3.1.conv2
        (14, 256, 512, 3, 2, True, True, 1, 1),     # layer4.0.conv1
        (14, 256, 512, 1, 2, False, True, 1, 1),    # layer4.0.down
        (7, 512, 512, 3, 1, True, True, 1, 1),      # layer4.1.conv1
        (7, 512, 512, 3, 1, False, True, 1, 1),     # layer4.0.conv2
        (7, 512, 512, 3, 1, False, False, 1, 1),    # layer4.1.conv2 (fp32 final junction)
        (224, 3, 64, 7, 2, True, False, 0, 0),      # the deploy/pallas stem (byte-gather path)
    ]


def _rand_int8(gen, shape, dev, lo=-127):
    return torch.randint(lo, 128, shape, generator=gen, device=dev, dtype=torch.int8)


def _epi_params(gen, oc, k, dev):
    """Per-OC combined scales and biases that put y at ~0.05 std, and an
    output scale that spreads the int8 outputs over the range."""
    base = 0.05 / (73.0 * 73.0 * math.sqrt(k))
    scale = (base * (0.5 + torch.rand(oc, generator=gen, device=dev))).float().contiguous()
    bias = (0.02 * torch.randn(oc, generator=gen, device=dev)).float().contiguous()
    return scale, bias, 0.05 / 40.0


def check_conv_kernels(dev):
    from dlq_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, out_hw, pack_conv_weight

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (h, c, oc, k, s, relu, int8_out, n_f2, n_blk) in conv_cases():
        pad = k // 2
        x = _rand_int8(gen, (BATCH, h, h, c), dev)
        pk = pack_conv_weight(_rand_int8(gen, (k, k, c, oc), dev))
        scale, bias, osc = _epi_params(gen, oc, k * k * c, dev)
        osc = osc if int8_out else None
        got = conv_int8(x, pk, s, pad, scale, bias, relu, osc)
        ref = conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"conv_int8 {h}x{h}x{c}->{oc} k{k}s{s}: max_abs_err {err}")
        oh, ow = out_hw(h, h, k, k, s, pad)
        ops = 2.0 * BATCH * oh * ow * oc * k * k * c
        # input bytes the conv reads: all of x, or for k < stride (the 1x1/s2
        # downsamples) only the pixels under a tap
        x_bytes = min(x.numel(), BATCH * oh * ow * k * k * c)
        nbytes = x_bytes + k * k * c * oc + 8 * oc + got.numel() * got.element_size()
        b_ms, b_by = bound(ops, nbytes)
        row = {"kernel": "conv_int8", "key": (BATCH, h, h, c, oc, k, k, s, pad, relu, int8_out),
               "shape": f"{BATCH}x{h}x{h}x{c}->{oc} {k}x{k}/s{s}",
               "relu": relu, "out": "int8" if int8_out else "fp32", "max_abs_err": err,
               "ms": time_ms(lambda: conv_int8(x, pk, s, pad, scale, bias, relu, osc)),
               "plain_ms": time_ms(lambda: conv_int8_plain(x, pk, s, pad, scale, bias, relu, osc),
                                   iters=2, warmup=1, reps=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": NO_INT8_CONV,
               "launches_fused2": n_f2, "launches_block": n_blk}
        emit_row(row)
        rows.append(row)
    return rows


def check_matmul_kernel(dev):
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8, matmul_int8_plain, pack_dense_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    m, k, n = BATCH, 512, 1000                       # the fc
    x = _rand_int8(gen, (m, k), dev)
    pk = pack_dense_weight(_rand_int8(gen, (k, n), dev))
    scale, bias, _ = _epi_params(gen, n, k, dev)
    got = matmul_int8(x, pk, scale, bias)
    ref = matmul_int8_plain(x, pk, scale, bias)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if err != 0.0:
        raise AssertionError(f"matmul_int8 fc: max_abs_err {err}")
    wt = pk.wk[:, :k].t()                            # [K, N], column-major
    b_ms, b_by = bound(2.0 * m * n * k, m * k + k * n + 8 * n + 4 * m * n)
    row = {"kernel": "matmul_int8", "key": (m, k, n), "shape": f"{m}x{k}@{k}x{n}",
           "relu": False, "out": "fp32",
           "max_abs_err": err, "ms": time_ms(lambda: matmul_int8(x, pk, scale, bias)),
           "plain_ms": time_ms(lambda: matmul_int8_plain(x, pk, scale, bias), iters=5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: torch._int_mm(x, wt)),
           "library": "torch._int_mm (int32 product only, no epilogue)",
           "launches_fused2": 1, "launches_block": 1}
    emit_row(row)
    return [row]


def check_block_kernel(dev):
    from dlq_tpu_torch.ops.block_fused import basic_block_fused, basic_block_plain
    from dlq_tpu_torch.ops.conv_int8 import pack_conv_weight

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    for h, c in ((28, 128), (14, 256)):               # layer2.1, layer3.1
        x = _rand_int8(gen, (BATCH, h, h, c), dev, lo=0)   # block inputs are post-relu
        s1, b1, _ = _epi_params(gen, c, 9 * c, dev)
        s2, b2, _ = _epi_params(gen, c, 9 * c, dev)
        pack = {"w1": pack_conv_weight(_rand_int8(gen, (3, 3, c, c), dev)), "s1": s1, "b1": b1,
                "w2": pack_conv_weight(_rand_int8(gen, (3, 3, c, c), dev)), "s2": s2, "b2": b2,
                "inv": (float(np.float32(40.0 / 0.05)), float(np.float32(40.0 / 0.05)),
                        float(np.float32(0.7)))}
        got = basic_block_fused(x, pack)
        ref = basic_block_plain(x, pack)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"basic_block {h}x{h}x{c}: max_abs_err {err}")
        ops = 2.0 * 2 * BATCH * h * h * c * 9 * c
        b_ms, b_by = bound(ops, 2 * x.numel() + 2 * 9 * c * c + 16 * c)
        row = {"kernel": "basic_block", "key": (BATCH, h, h, c), "shape": f"{BATCH}x{h}x{h}x{c}",
               "relu": True,
               "out": "int8", "max_abs_err": err, "ms": time_ms(lambda: basic_block_fused(x, pack)),
               "plain_ms": time_ms(lambda: basic_block_plain(x, pack), iters=2, warmup=1, reps=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library": NO_INT8_CONV,
               "launches_fused2": 0, "launches_block": 1}
        emit_row(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the main paths
# ---------------------------------------------------------------------------

def _wrappers():
    from dlq_tpu_torch.ops.block_fused import basic_block_fused
    from dlq_tpu_torch.ops.conv_int8 import conv_int8
    from dlq_tpu_torch.ops.matmul_int8 import matmul_int8

    return {"conv_int8": conv_int8, "matmul_int8": matmul_int8, "basic_block": basic_block_fused}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        fn.by_shape.clear()


def read_counts():
    """(launches per kernel, launches per kernel and shape key)."""
    ws = _wrappers()
    return ({k: fn.launches for k, fn in ws.items()},
            {k: dict(fn.by_shape) for k, fn in ws.items()})


def expect_counts(got, per_forward, forwards, what):
    want = {k: v * forwards for k, v in per_forward.items()}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} ({forwards} forwards)")


def expected_by_shape(path: str, forwards: int):
    """Launches per kernel and shape key that ``conv_cases`` and the block
    sites give a main path over ``forwards`` forwards."""
    col = {"fused2": 7, "block": 8}[path]
    conv = {}
    for case in conv_cases():
        h, c, oc, k, s, relu, int8_out = case[:7]
        if case[col]:
            key = (BATCH, h, h, c, oc, k, k, s, k // 2, relu, int8_out)
            conv[key] = conv.get(key, 0) + case[col] * forwards
    block = ({(BATCH, 28, 28, 128): forwards, (BATCH, 14, 14, 256): forwards}
             if path == "block" else {})
    return {"conv_int8": conv, "matmul_int8": {(BATCH, 512, 1000): forwards},
            "basic_block": block}


def expect_by_shape(got, path, forwards, what):
    want = expected_by_shape(path, forwards)
    if got != want:
        raise AssertionError(f"{what}: launches per shape {got}, expected {want}")


def gate(logits, ref, what, min_cos):
    from dlq_tpu_torch import numerics

    agree = numerics.top1_agreement(logits, ref)
    cos = numerics.diff(logits, ref).cosine
    if agree < 1.0 or cos < min_cos:
        raise AssertionError(f"{what}: top-1 agreement {agree}, cosine {cos} (need 1.0, {min_cos})")
    return agree, cos


def main_paths(dev, card):
    from dlq_tpu_torch.engine import Engine
    from dlq_tpu_torch.models.resnet import (
        ResNetConfig, flatten_folded, fold_resnet, folded_forward, init_resnet, qforward,
        qforward_fused2,
    )
    from dlq_tpu_torch.ops.block_fused import pack_fused_blocks
    from dlq_tpu_torch.quant.model_quant import PallasBlockCtx
    from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL
    from dlq_tpu_torch.quant.store import load_quantized, save_quantized

    cfg = ResNetConfig(depth=18, num_classes=1000)
    folded = fold_resnet(init_resnet(SEED, cfg), cfg)
    flat = flatten_folded(folded)
    rng = np.random.default_rng(SEED)
    calib = [rng.normal(0, 1, (8, 224, 224, 3)).astype(np.float32)]
    nb = 4
    images = rng.normal(0, 1, (nb * BATCH, 224, 224, 3)).astype(np.float32)
    x0 = images[:BATCH]

    fp32 = Engine.fp32(folded_forward, folded, cfg, batch=BATCH, device=dev, name="resnet18_fp32")
    ref_logits = fp32(x0).float().cpu().numpy()

    t0 = time.perf_counter()
    eng_q = Engine.quantized(qforward, flat, cfg, INT8_PER_CHANNEL, calib_batches=calib,
                             batch=BATCH, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        save_quantized(tmp, "resnet18", eng_q.qflat, eng_q.act_scales, INT8_PER_CHANNEL,
                       meta={"config": {"num_classes": 1000, "small_input": False}})
        eng = Engine.from_store(tmp, ctx="fused2", batch=BATCH, device=dev)
        setup_s = time.perf_counter() - t0
        eng.classify(images[:BATCH])                   # warm (first launches)
        eng.stats.images_timed, eng.stats.ms_total = 0, 0.0

        # ---- phase 3: the fused2 main path ----
        reset_counts()
        preds = eng.classify(images, pipeline=2)
        counts, shapes = read_counts()
        expect_counts(counts, {"conv_int8": 19, "matmul_int8": 1, "basic_block": 0}, nb, "fused2")
        expect_by_shape(shapes, "fused2", nb, "fused2")
        logits_f2, taps_f2 = _taps(eng, x0, cfg, qforward_fused2)
        if not np.array_equal(preds[:BATCH], logits_f2.argmax(-1)):
            raise AssertionError("fused2: classify and the taps forward disagree")
        agree, cos = gate(logits_f2, ref_logits, "fused2 vs fp32", 0.999)
        xt = torch.from_numpy(x0).to(dev)
        ms = time_ms(lambda: eng._fn(eng.params, xt), iters=10)
        # the 224 px stem alone (bf16 conv, int8 requant, int8 maxpool): no kernel of this port
        with torch.inference_mode():
            stem_ms = time_ms(lambda: eng.params.maxpool(
                eng.params.conv_stem_bf16("stem", xt, out_site="layer1.0.conv1")), iters=10)
        emit({"phase": "main_path_fused2", "model": "resnet18", "size": 224, "batch": BATCH,
              "batches": nb, "img_per_s_classify": eng.stats.images_per_sec,
              "ms_per_batch": ms, "img_per_s_device": BATCH / (ms / 1e3),
              "stem_maxpool_ms": stem_ms,
              "launches": counts, "launches_per_forward": {k: v / nb for k, v in counts.items()},
              "top1_agreement_vs_fp32": agree, "logits_cosine_vs_fp32": cos,
              "setup_s": setup_s, "card": card})
        profile_forward(eng, xt, "fused2")
        out["fused2"] = (counts, shapes)

        # ---- phase 4: PallasBlockCtx on the same store ----
        qflat, scales, qcfg = load_quantized(tmp)
        qflat = {k: {n: (t.to(dev) if t is not None else None) for n, t in v.items()}
                 for k, v in qflat.items()}
        scales = {k: v.to(dev) for k, v in scales.items()}
        packs = pack_fused_blocks(qflat, scales, cfg)
        if set(packs) != {"layer2.1", "layer3.1"}:
            raise AssertionError(f"block sites {sorted(packs)}")
        blk = Engine(lambda c, x: qforward_fused2(c, x, cfg),
                     PallasBlockCtx(qflat, scales, qcfg, packs), batch=BATCH, device=dev,
                     name="resnet18_block")
        blk.classify(images[:BATCH])
        blk.stats.images_timed, blk.stats.ms_total = 0, 0.0
        reset_counts()
        preds_b = blk.classify(images, pipeline=2)
        counts_b, shapes_b = read_counts()
        expect_counts(counts_b, {"conv_int8": 15, "matmul_int8": 1, "basic_block": 2}, nb,
                      "PallasBlockCtx")
        expect_by_shape(shapes_b, "block", nb, "PallasBlockCtx")
        logits_b, taps_b = _taps(blk, x0, cfg, qforward_fused2)
        agree_b, cos_b = gate(logits_b, logits_f2, "PallasBlockCtx vs fused2", 0.9999)
        eq = {k: float((taps_b[k] == taps_f2[k]).mean()) for k in ("layer2", "layer3")}
        if min(eq.values()) < 0.999:
            raise AssertionError(f"PallasBlockCtx block outputs agree on {eq} (< 0.999)")
        ms_b = time_ms(lambda: blk._fn(blk.params, xt), iters=10)
        emit({"phase": "main_path_block", "batch": BATCH, "batches": nb,
              "img_per_s_classify": blk.stats.images_per_sec, "ms_per_batch": ms_b,
              "img_per_s_device": BATCH / (ms_b / 1e3), "launches": counts_b,
              "launches_per_forward": {k: v / nb for k, v in counts_b.items()},
              "top1_agreement_vs_fused2": agree_b, "logits_cosine_vs_fused2": cos_b,
              "block_output_equal_fraction": eq, "preds_equal_fused2": float((preds_b == preds).mean()),
              "card": card})
        profile_forward(blk, xt, "block")
        out["PallasBlockCtx"] = (counts_b, shapes_b)

        # ---- phase 5: fp32-interchange contexts at batch 64 ----
        for name in ("deploy", "pallas"):
            e = Engine.from_store(tmp, ctx=name, batch=64, device=dev)
            reset_counts()
            lg = e(x0[:64]).float().cpu().numpy()
            c = read_counts()[0]
            expect_counts(c, {"conv_int8": 20, "matmul_int8": 1, "basic_block": 0}, 1, name)
            agree_d, cos_d = gate(lg, ref_logits[:64], f"{name} vs fp32", 0.999)
            emit({"phase": f"ctx_{name}", "batch": 64, "launches": c,
                  "top1_agreement_vs_fp32": agree_d, "logits_cosine_vs_fp32": cos_d})
    out["forwards"] = nb
    return out


def profile_forward(eng, xt, what, forwards=3):
    """Where one forward's device time goes: torch.profiler (CUPTI) over a
    few back-to-back forwards; device kernel time by kernel name, and the
    share of the wall window in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(forwards):
                eng._fn(eng.params, xt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    kern.sort(key=lambda e: -e.self_device_time_total)
    emit({"phase": f"profile_{what}", "forwards": forwards,
          "wall_ms_per_forward": wall_us / forwards / 1e3,
          "device_ms_per_forward": dev_us / forwards / 1e3 if dev_us else "not measured",
          "device_idle_share": 1.0 - dev_us / wall_us if dev_us else "not measured",
          "top_kernels": [{"name": e.key[:160], "ms_per_forward": e.self_device_time_total / forwards / 1e3,
                           "launches_per_forward": e.count / forwards} for e in kern[:12]]})


def _taps(eng, x, cfg, qf):
    with torch.inference_mode():
        logits, taps = qf(eng.params, torch.from_numpy(x).to(eng.device), cfg, taps=True)
    torch.cuda.synchronize()
    return (logits.float().cpu().numpy(),
            {k: v.float().cpu().numpy() for k, v in taps.items()})


def summary(rows, paths):
    """One entry per kernel. ``launches`` is the count of the main path's
    run (``forwards`` forwards at batch 256; fused2 for K1/K2,
    PallasBlockCtx for K3); ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are per forward: each shape's time times its launches
    per forward, as counted per shape on that run."""
    meta = {
        "conv_int8": ("dlq_tpu_torch/csrc/conv_int8.cu",
                      "dlq_tpu/ops/pallas_conv.py:143 int8_conv3x3_s1 (+ :317 int8_conv3x3_s1_dp)",
                      "fused2"),
        "matmul_int8": ("dlq_tpu_torch/csrc/matmul_int8.cu",
                        "dlq_tpu/ops/pallas_matmul.py:61 int8_matmul", "fused2"),
        "basic_block": ("dlq_tpu_torch/csrc/basic_block.cu",
                        "dlq_tpu/ops/pallas_block.py:155 basic_block_fused", "PallasBlockCtx"),
    }
    nf = paths["forwards"]
    out = []
    for name, (src, repl, path) in meta.items():
        counts, shapes = paths[path]
        rs = [r for r in rows if r["kernel"] == name]
        w = [shapes[name].get(r["key"], 0) / nf for r in rs]

        def tot(f):
            vals = [r[f] for r in rs]
            return None if any(v is None for v in vals) else sum(n * v for n, v in zip(w, vals))

        bounds = [(n * r["bound_ms"], r["bound_by"]) for n, r in zip(w, rs) if n]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                    "launches": counts[name], "forwards": nf,
                    "launches_per_forward": counts[name] / nf,
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
                    "bound_by": max(bounds)[1] if bounds else rs[0]["bound_by"],
                    "library_ms": tot("library_ms"), "library": rs[0]["library"],
                    "per": f"launches: the {path} run of {nf} forwards; times: one {path} "
                           f"forward at batch {BATCH}"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dlq_tpu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                            check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_v, "card": card, "device_name": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "build_s_per_source": secs})

    rows = check_conv_kernels(dev) + check_matmul_kernel(dev) + check_block_kernel(dev)
    paths = main_paths(dev, card)
    kernels = summary(rows, paths)
    print(card_line())
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
