"""Digests of K5's (``vit_pre_w8``) and K11's (``vit_pre_w4``) outputs on
seeded inputs, over every form they take: the Hopper form at Dp 128, 192
and 256, the first form through its own entry at those Dp and by the rule
at Dp 64 and 320, bf16 and fp32 residuals, a row count that ends in a short
tile and a short last block. The inputs are made on the host from a numpy
seed, so the digests depend only on the kernels. ``EXPECTED`` holds the
digests of the sources before K8 and K14 took these kernels' Hopper bodies
(``csrc/vit_pre_iw.cuh`` and ``csrc/vit_pre_hw.cuh``): equal digests show
that K5's and K11's outputs did not move, bit for bit.

    python -m dlq_tpu_torch.tools.pre_digest      # on a card; exit 1 if one differs
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

# sha256 of each kernel's outputs over the cases below, by the sources
# before these bodies were shared (commit 067f839, NVIDIA H100 80GB HBM3;
# the kernels are deterministic)
EXPECTED = {"vit_pre_w8": "1e5581d070b1f5a817080a6cc066a59ef2b03e0749d46481ddf174f9161895c5",
            "vit_pre_w4": "5be817c8a7125e6b4ec46cb1aea264f08107bdcb9eea0e7d606b0268b9474813"}

DPS = (64, 128, 192, 256, 320)
ROWS = (3, 437)   # [B, Np]: 1,311 rows, not a multiple of 64 or 128


def _layer(rng: np.random.Generator, dp: int, w4: bool, dev) -> dict:
    """A K5 (int8 weights) or K11 (int4 halves-packed, bf16 activations)
    layer's LN1 + QKV parameters, zero past d_valid = Dp - 32."""
    from dlq_tpu_torch.ops.matmul_int4a8 import pack_halves_kmajor

    d, n = dp - 32, 3 * dp
    if w4:
        w = rng.integers(-8, 8, (dp, n)).astype(np.int8)   # [K, N]
        w[d:] = 0
        w[:, np.arange(n) % dp >= d] = 0
        wqkv = pack_halves_kmajor(torch.from_numpy(w), dp, n)
        s = rng.uniform(0.5, 1.5, n) / (4.6 * np.sqrt(dp))
    else:
        w = rng.integers(-127, 128, (n, dp)).astype(np.int8)   # K-major [N, K]
        w[:, d:] = 0
        wqkv = torch.from_numpy(w)
        s = rng.uniform(0.5, 1.5, n) / (60.0 * 73.0 * np.sqrt(dp))
    ln = np.stack([rng.uniform(0.5, 1.5, dp), rng.normal(0, 0.1, dp)]).astype(np.float32)
    ln[:, d:] = 0
    blk = {"wqkv": wqkv.to(dev), "sqkv": torch.from_numpy(s.astype(np.float32)).to(dev),
           "bqkv": torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(dev),
           "ln1": torch.from_numpy(ln).to(dev)}
    if not w4:
        blk["inv_act"] = (40.0, 30.0, 40.0, 30.0)
    return blk


def digests(dev) -> dict:
    """{kernel: sha256 hex of its outputs over every case, in order}."""
    from dlq_tpu_torch.ops import vit_block as vb

    fns = {"vit_pre_w8": (vb.vit_block_pre_w8, vb.vit_block_pre_w8_first, False),
           "vit_pre_w4": (vb.vit_block_pre_w4, vb.vit_block_pre_w4_first, True)}
    out = {}
    for name, (kern, first, w4) in fns.items():
        h = hashlib.sha256()
        rng = np.random.default_rng(1500 + w4)
        for dp in DPS:
            blk = _layer(rng, dp, w4, dev)
            yn = rng.normal(0, 1, (*ROWS, dp)).astype(np.float32)
            yn[..., dp - 32:] = 0
            for dt in (torch.bfloat16, torch.float32):
                y = torch.from_numpy(yn).to(dev, dt)
                for fn in (kern, first):
                    got = fn(y, blk, dp - 32)
                    h.update(got.view(torch.int16).cpu().numpy().tobytes())
        out[name] = h.hexdigest()
    torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pre_digest: CUDA is not available", file=sys.stderr)
        return 1
    got = digests(torch.device("cuda"))
    same = {k: got[k] == EXPECTED[k] for k in got}
    print(json.dumps({"pre_digest": got, "expected": EXPECTED, "equal": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
