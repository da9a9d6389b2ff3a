"""K19: the port of ``tools/probe_mosaic_patterns.py`` (its ``run`` helper's
``pallas_call``, ``:37/:39``): the patterns a fused ViT block kernel needs,
each as one hand-written kernel in ``csrc/probe_mosaic.cu``.

  1  lane-slice read at a 64-lane offset      bf16 [256, 768] -> [256, 64]
  2  writes into shared memory at 64-lane offsets (x 2)   [256, 256]
  3  NT bf16 dot, fp32 out (mma.sync m16n8k16)  [256, 64] x [256, 64]^T
     (16 x 32 output tiles, q and k rows by TMA: ``_probe.nt_dot_plan``)
  4  leading-dim merge [4, 256, 256] -> [1024, 256] (x 2)
  5  tanh epilogue: bf16(tanh(fp32(x)))         [256, 768]
     (a thread per ``TANH_VALUES`` values on every SM: ``tanh_launch``)
  6  the probe's 4-head attention on qkv [256, 768]: per head h, q/k/v at
     lanes 64h, 256 + 64h, 512 + 64h; s = (q k^T) * 0.125; keys >= 197 at
     -1e30; p = exp(s - max); a = bf16(p / sum p); out[:, 64h:] = bf16(a v)

Inputs are ``default_rng(0)`` draws in the reference's order; the check
against the numpy expectation is the reference's (``max_abs < 2e-2``,
finite); on the card the kernel is also held against its plain version:
identical for 1, 2 and 4, within 1e-4 of max|plain| for 3, and for 5 and 6
within one bf16 step of max|plain| on at most 1% of the outputs. 1, 2 and 4
run on ``probe_common.cuh``'s Hopper ``stage_kernel``, 3 on its Hopper
``nt_dot_hopper_kernel``, 5 on ``tanh_kernel``, 6 on its Hopper
``attention_kernel``; ``probe_mosaic.first`` runs their first forms.

    python -m dlq_tpu_torch.tools.probe_mosaic_patterns [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools._probe import Spec, Window

SOURCE = "probe_mosaic"
ATOL = 2e-2
BF = torch.bfloat16
HEADS, ROWS, HD, N_VALID, SCALE = 4, 256, 64, 197, 0.125

SPEC = {
    "1": Spec("lane-slice read @64", (((256, 768), BF),), ((256, 64), BF), True, ATOL,
              read_bytes=256 * 64 * 2, library="x[:, 64:128].contiguous()"),
    "2": Spec("lane-offset scratch writes", (((256, 256), BF),), ((256, 256), BF), True, ATOL,
              library="torch.mul(x, 2)"),
    "3": Spec("NT dot_general (contract lanes)", (((256, 64), BF), ((256, 64), BF)),
              ((256, 256), torch.float32), False, ATOL, flops=2 * 256 * 256 * 64, peak="bf16",
              library="torch.matmul(q, k.t()) (bf16 out)"),
    "4": Spec("reshape [4,256,256]->[1024,256]", (((4, 256, 256), BF),), ((1024, 256), BF),
              True, ATOL, library="torch.mul(y, 2).reshape(1024, 256)"),
    "5": Spec("tanh epilogue", (((256, 768), BF),), ((256, 768), BF), False, ATOL,
              library="torch.tanh(x) (bf16: tanh in fp32, rounded to bf16)"),
    # the products the data needs: 197 unmasked keys for q k^T and a v
    "6": Spec("full in-kernel MHSA (4 heads)", (((256, 768), BF),), ((256, 256), BF), False,
              ATOL, flops=HEADS * 2 * (2 * ROWS * N_VALID * HD), peak="bf16",
              library="F.scaled_dot_product_attention(q, k[:197], v[:197], scale=0.125) on the "
                      "[1, 4, 256, 64] head views (its probabilities unnormalised in bf16)"),
}


def attention_plain(qkv: torch.Tensor) -> torch.Tensor:
    """Pattern 6's arithmetic, head by head, as the probe's kernel states it."""
    out = torch.empty((ROWS, HEADS * HD), dtype=BF, device=qkv.device)
    masked = torch.arange(ROWS, device=qkv.device) >= N_VALID
    for h in range(HEADS):
        q, k, v = (qkv[:, o + HD * h: o + HD * h + HD].float() for o in (0, 256, 512))
        s = ((q @ k.t()) * SCALE).masked_fill(masked[None, :], -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        a = (p / p.sum(-1, keepdim=True)).to(BF)
        out[:, HD * h: HD * h + HD] = (a.float() @ v).to(BF)
    return out


PLAIN = {
    "1": lambda x: _probe.copy_of(x[:, 64:128]),
    "2": lambda x: x * 2,
    "3": lambda q, k: q.float() @ k.float().t(),
    "4": lambda y: (y * 2).reshape(1024, 256),
    "5": lambda x: torch.tanh(x.float()).to(BF),
    "6": attention_plain,
}

def _heads(qkv: torch.Tensor, lane: int, rows: int) -> torch.Tensor:
    """The [1, 4, rows, 64] head view of q (lane 0), k (256) or v (512)."""
    return qkv[:rows, lane: lane + 256].unflatten(1, (HEADS, HD)).transpose(0, 1)[None]


LIBRARY = {
    "1": lambda x: x[:, 64:128].contiguous(),
    "2": lambda x: torch.mul(x, 2),
    "3": lambda q, k: torch.matmul(q, k.t()),
    "4": lambda y: torch.mul(y, 2).reshape(1024, 256),
    "5": lambda x: torch.tanh(x),
    # keys >= 197 carry weight exp(-1e30 - max) = 0: attention over the first 197
    "6": lambda qkv: F.scaled_dot_product_attention(
        _heads(qkv, 0, ROWS), _heads(qkv, 256, N_VALID), _heads(qkv, 512, N_VALID),
        scale=SCALE),
}

# the copy patterns on probe_common.cuh's stage_kernel (csrc/probe_mosaic.cu's
# kStaged; the card tests hold the two equal): key -> (window over the
# input's bytes, x 2 in bf16)
WINDOWS = {
    "1": (Window(128, 1536, 0, 256, 1, 128), False),
    "2": (Window(0, 512, 128, 256, 4, 128), True),
    "4": (Window(0, 512, 0, 1024, 1, 512), True),
}
# the patterns on a Hopper form whose first form stays callable (probe_mosaic.first)
FIRST_FORMS = (*WINDOWS, "3", "5", "6")

# 5's Hopper form (csrc/probe_mosaic.cu: tanh_kernel): a thread per
# TANH_VALUES values (one load, one store), blocks of TANH_THREADS
TANH_THREADS, TANH_VALUES = 256, 4
TANH_N = 256 * 768


def tanh_launch() -> Tuple[int, int, int]:
    """(grid, threads, values a thread): what the C side's
    ``dlq_probe_mosaic_tanh_plan`` reports."""
    return (TANH_N // (TANH_THREADS * TANH_VALUES), TANH_THREADS, TANH_VALUES)


def tanh_values(t: torch.Tensor) -> torch.Tensor:
    """The element offsets thread ``t`` (global index) loads and stores,
    [..., TANH_VALUES], in the order of its 32-bit words' halves."""
    return (t * TANH_VALUES)[..., None] + torch.arange(TANH_VALUES)


def tanh_exhaustive_input() -> torch.Tensor:
    """A bf16 [256, 768] holding each of the 65,536 bit patterns three times:
    in order, reversed, and in a seeded order."""
    bits = np.arange(65536, dtype=np.int64)
    v = np.concatenate([bits, bits[::-1], np.random.default_rng(0).permutation(bits)])
    return torch.from_numpy(v.astype(np.uint16).view(np.int16)).view(BF).reshape(256, 768)


def exhaustive_cases():
    """(label, key, input, scale) of the card's exhaustive check of 5."""
    return [("5 every bf16 x3", "5", tanh_exhaustive_input(), None)]
KEY_TILES = 32   # attention_kernel's key tiles of 8 for pattern 6 (256 keys)

probe_mosaic = _probe.make_wrapper(SOURCE, SPEC, PLAIN, FIRST_FORMS)
CHECK = _probe.check_max_abs_below   # the reference's check


def _expect6(qkv: np.ndarray) -> np.ndarray:
    """The reference's ``ref6`` (numpy, fp32 products)."""
    out = np.zeros((256, 256), np.float32)
    for h in range(4):
        qh = qkv[:, 64 * h: 64 * h + 64]
        kh = qkv[:, 256 + 64 * h: 256 + 64 * h + 64]
        vh = qkv[:, 512 + 64 * h: 512 + 64 * h + 64]
        s = qh @ kh.T * 0.125
        s[:, 197:] = -1e30
        p = np.exp(s - s.max(-1, keepdims=True))
        attn = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        out[:, 64 * h: 64 * h + 64] = attn @ vh
    return out


def cases():
    """(key, inputs, the reference's numpy expectation) per pattern."""
    rng = np.random.default_rng(0)
    x = _probe.bf16(rng.normal(0, 1, (256, 768)))
    q = _probe.bf16(rng.normal(0, 1, (256, 64)))
    kk = _probe.bf16(rng.normal(0, 1, (256, 64)))
    y = _probe.bf16(rng.normal(0, 1, (4, 256, 256)))
    qkv = _probe.bf16(rng.normal(0, 1, (256, 768)))
    xf, yf = x.float().numpy(), y.float().numpy()
    return [
        ("1", (x,), xf[:, 64:128]),
        ("2", (x[:, :256].contiguous(),), xf[:, :256] * 2),
        ("3", (q, kk), q.float().numpy() @ kk.float().numpy().T),
        ("4", (y,), yf.reshape(1024, 256) * 2),
        ("5", (x,), np.tanh(xf).astype(np.float32)),
        ("6", (qkv,), _expect6(qkv.float().numpy())),
    ]


def results(device=None):
    """Run the six mosaic patterns; one ``_probe.Result`` each."""
    return _probe.run(probe_mosaic, SPEC, PLAIN, cases(), CHECK, device)


def main(device=None) -> int:
    """Run the six mosaic patterns; returns the number of FAILs."""
    return _probe.fails(results(device))


if __name__ == "__main__":
    sys.exit(_probe.cli(main))
