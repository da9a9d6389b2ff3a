"""Build and load the port's CUDA kernels.

Each ``dlq_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface, ``build/dlq_tpu_torch/lib<name>.so``
under the repository root, at first use; ``ctypes`` loads it. No PyTorch
headers are included, so a build takes seconds. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

A library is rebuilt when it is older than its source or the shared header.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside each library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build" / "dlq_tpu_torch"
SOURCES = ("conv_int8", "matmul_int8", "basic_block", "bottleneck_block", "vit_pre_w8", "mhsa",
           "vit_post_w8", "vit_pre_w4a8", "vit_post_w4a8", "matmul_int4a8", "vit_pre_w4",
           "vit_post_w4", "matmul_int4", "vit_pre_bf16", "vit_post_bf16", "layernorm", "mhsa_i8",
           "probe_mosaic", "probe_batched_dot", "probe_block", "probe_stem", "depthwise_int8")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(d.stat().st_mtime > out.stat().st_mtime for d in deps)


def _command(name: str, tmp: Path) -> List[str]:
    return [nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-lineinfo", "-o", str(tmp), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES, force: bool = False) -> Dict[str, float]:
    """Compile every stale source in parallel; returns wall seconds per
    source (0.0 for one already up to date). Raises on a failed build with
    the compiler's output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.so.tmp{os.getpid()}"
        log = open(BUILD / f"lib{n}.log", "w")
        procs[n] = (subprocess.Popen(_command(n, tmp), stdout=log, stderr=subprocess.STDOUT),
                    tmp, log)
    secs = {n: 0.0 for n in names}
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        logs = "\n".join((BUILD / f"lib{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return secs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if stale). Kernel
    wrappers call this only when they launch, never at import."""
    if _stale(name):
        build_all((name,))
    return ctypes.CDLL(str(lib_path(name)))


def ptxas_report(lib: str, mark: str) -> dict:
    """From kernel library ``lib``'s -Xptxas -v report (``build/lib<lib>.log``):
    its entries whose names hold ``mark``, their register counts and their
    largest stack frame and spill stores and loads (bytes), and the
    library's count of C7520 warnings (ptxas serializing every wgmma of a
    kernel)."""
    text = (BUILD / f"lib{lib}.log").read_text()
    regs, props, entry, fn = {}, {}, None, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            props[fn] = tuple(int(g) for g in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            regs[entry] = int(m.group(1))
    mine = [k for k in regs if mark in k]
    if not mine:
        raise AssertionError(f"{lib}: no kernel named *{mark}* in its ptxas report")
    worst = [max(props.get(k, (0, 0, 0))[i] for k in mine) for i in range(3)]
    return {"entries": len(mine), "registers": sorted({regs[k] for k in mine}),
            "stack_frame_max": worst[0], "spill_stores_max": worst[1], "spill_loads_max": worst[2],
            "c7520_warnings": text.count("C7520")}


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
