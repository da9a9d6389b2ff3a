"""K20: the port of ``tools/probe_batched_dot.py`` (its ``run`` helper's
``pallas_call``, ``:28/:30``): the batched dots of a per-(sample, head)
attention, each as one hand-written kernel in ``csrc/probe_batched_dot.cu``.

  A  batched NT dot  bf16 [8, 200, 64] x [8, 200, 64]^T -> fp32 [8, 200, 200]
     (16 x 32 output tiles, q and k rows by TMA: ``_probe.nt_dot_plan``)
  B  batched NN dot  bf16 [8, 200, 200] x [8, 200, 64] -> fp32 [8, 200, 64]
     (the B operand through ldmatrix.trans; 32 x 32 output tiles, the keys
     in four chunks: ``nn_dot_plan``)
  C  split reshape   bf16 [1600, 576] -> [8, 200, 576]
  D  one attention head per sample of x [1600, 576] viewed [8, 200, 576]:
     q, k, v = lanes 0, 64, 128 (64 wide); no scale, no mask;
     a = bf16(softmax(q k^T)); out [8, 200, 192] bf16 = [bf16(a v), 0, 0]

Inputs are ``default_rng(0)`` draws in the reference's order; the check
against the numpy expectation is the reference's (``max|got - expect| /
max|expect| <= 2e-2``, finite); on the card the kernel is also held against
its plain version: identical for C, within 1e-4 of max|plain| for A and B,
and for D within one bf16 step of max|plain| on at most 1% of the outputs.
A runs on ``probe_common.cuh``'s Hopper ``nt_dot_hopper_kernel``, B on
``nn_dot_hopper_kernel``, C on the Hopper ``stage_kernel``, D on the Hopper
``attention_kernel``; ``probe_batched_dot.first`` runs their first forms.

    python -m dlq_tpu_torch.tools.probe_batched_dot [--device cpu]
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlq_tpu_torch.tools import _probe
from dlq_tpu_torch.tools._probe import Spec, Window

SOURCE = "probe_batched_dot"
ATOL = 2e-2
BF = torch.bfloat16
B, NP, HD = 8, 200, 64

SPEC = {
    "A": Spec("A batched NT dot [8,200,64]^2 -> [8,200,200]", (((B, NP, HD), BF),) * 2,
              ((B, NP, NP), torch.float32), False, ATOL, flops=2 * B * NP * NP * HD,
              peak="bf16", library="torch.matmul(q, k.transpose(1, 2)) (bf16 out)"),
    "B": Spec("B batched NN dot [8,200,200]x[8,200,64]", (((B, NP, NP), BF), ((B, NP, HD), BF)),
              ((B, NP, HD), torch.float32), False, ATOL, flops=2 * B * NP * NP * HD,
              peak="bf16", library="torch.matmul(a, v) (bf16 out)"),
    "C": Spec("C split reshape [1600,576]->[8,200,576]", (((1600, 576), BF),),
              ((B, NP, 576), BF), True, ATOL,
              library="x.reshape(8, 200, 576).clone(memory_format=torch.contiguous_format)"),
    # reads lanes 0..191 of each row only
    "D": Spec("D full batched-attention head", (((1600, 576), BF),), ((B, NP, 192), BF),
              False, ATOL, flops=2 * (2 * B * NP * NP * HD), peak="bf16",
              read_bytes=1600 * 192 * 2,
              library="F.scaled_dot_product_attention(q, k, v, scale=1.0) on the [8, 1, 200, "
                      "64] views (its probabilities unnormalised in bf16; the 128 zero columns "
                      "not written)"),
}


def attention_plain(x: torch.Tensor) -> torch.Tensor:
    """Pattern D's arithmetic, as the probe's kernel states it."""
    y = x.reshape(B, NP, 576).float()
    q, k, v = y[..., 0:64], y[..., 64:128], y[..., 128:192]
    s = torch.bmm(q, k.transpose(1, 2))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a = (p / p.sum(-1, keepdim=True)).to(BF)
    out = torch.zeros((B, NP, 192), dtype=BF, device=x.device)
    out[..., 0:64] = torch.bmm(a.float(), v).to(BF)
    return out


PLAIN = {
    "A": lambda q, k: torch.bmm(q.float(), k.float().transpose(1, 2)),
    "B": lambda a, v: torch.bmm(a.float(), v.float()),
    "C": lambda x: _probe.copy_of(x.reshape(B, NP, 576)),
    "D": attention_plain,
}

def _head(x: torch.Tensor, lane: int) -> torch.Tensor:
    """The [8, 1, 200, 64] view of q (lane 0), k (64) or v (128)."""
    return x.reshape(B, NP, 576)[:, None, :, lane: lane + HD]


LIBRARY = {
    "A": lambda q, k: torch.matmul(q, k.transpose(1, 2)),
    "B": lambda a, v: torch.matmul(a, v),
    "C": lambda x: x.reshape(B, NP, 576).clone(memory_format=torch.contiguous_format),
    "D": lambda x: F.scaled_dot_product_attention(_head(x, 0), _head(x, 64), _head(x, 128),
                                                  scale=1.0),
}

# the copy pattern on probe_common.cuh's stage_kernel (csrc/probe_batched_dot.cu's
# kStaged; the card tests hold the two equal): key -> (window over the
# input's bytes, x 2 in bf16)
WINDOWS = {"C": (Window(0, 1152, 0, 1600, 1, 1152), False)}
# the patterns on a Hopper form whose first form stays callable
# (probe_batched_dot.first)
FIRST_FORMS = (*WINDOWS, "A", "B", "D")
KEY_TILES = 26   # attention_kernel's key tiles of 8 for D (200 keys and 8 pads)

# B's Hopper form (csrc/probe_batched_dot.cu: nn_dot_hopper_kernel)
NN_KP = 208      # keys padded to 13 k16 steps (200..207 zero)
NN_TILE = 32     # output rows and columns a block (4 warps of 16 x 16)
NN_CHUNK = 64    # keys a chunk: an a box (NN_TILE rows) and a v box (NN_TILE columns)
NN_BOX = NN_TILE * NN_CHUNK * 2   # bytes of a box


class NnTile(NamedTuple):
    """One block of ``nn_dot_hopper_kernel``: sample ``b``, output rows
    ``m0 ..`` and columns ``n0 ..`` (``NN_TILE`` each), and its 4 warps, each
    (first row, first column, the k16 steps in the order it runs them); a
    warp with no rows runs none."""
    b: int
    m0: int
    n0: int
    warps: Tuple[Tuple[int, int, Tuple[int, ...]], ...]


def nn_dot_chunks(kp: int = NN_KP) -> List[range]:
    """The k16 steps of each key chunk, in the order the chunks land."""
    per = NN_CHUNK // 16
    return [range(c * per, min((c + 1) * per, kp // 16)) for c in range(-(-kp // NN_CHUNK))]


def nn_dot_plan(batch: int = B, m: int = NP, n: int = HD, kp: int = NN_KP) -> List[NnTile]:
    """``nn_dot_hopper_kernel``'s grid (x: row tile, y: column tile, z:
    sample), block by block: warp w owns the 16 rows at m0 + 16 (w >> 1)
    and the 16 columns at n0 + 16 (w & 1), and runs each chunk's k16 steps
    in turn where it has rows."""
    steps = tuple(k for ch in nn_dot_chunks(kp) for k in ch)
    tiles = []
    for b in range(batch):
        for nt in range(n // NN_TILE):
            for mt in range(-(-m // NN_TILE)):
                m0, n0 = mt * NN_TILE, nt * NN_TILE
                warps = tuple((m0 + 16 * (w >> 1), n0 + 16 * (w & 1),
                               steps if m0 + 16 * (w >> 1) < m else ()) for w in range(4))
                tiles.append(NnTile(b, m0, n0, warps))
    return tiles


def nn_dot_launch(batch: int = B, m: int = NP, n: int = HD, kp: int = NN_KP) -> Tuple[int, ...]:
    """(grid x, y, z, threads, key chunks, box bytes): what the C side's
    ``dlq_probe_batched_dot_nn_plan`` reports."""
    return (-(-m // NN_TILE), n // NN_TILE, batch, 128, len(nn_dot_chunks(kp)), NN_BOX)


probe_batched_dot = _probe.make_wrapper(SOURCE, SPEC, PLAIN, FIRST_FORMS)
CHECK = _probe.check_rel   # the reference's check


def _expect_d(x2f: np.ndarray) -> np.ndarray:
    """The reference's numpy expectation of D."""
    x2f = x2f.reshape(8, 200, 576)
    s = np.einsum("bnh,bmh->bnm", x2f[:, :, 0:64], x2f[:, :, 64:128])
    p = np.exp(s - s.max(-1, keepdims=True))
    attn = (p / p.sum(-1, keepdims=True))
    av = np.einsum("bnm,bmh->bnh", attn.astype(np.float32), x2f[:, :, 128:192])
    exp = np.zeros((8, 200, 192), np.float32)
    exp[:, :, 0:64] = av
    return exp


def cases():
    """(key, inputs, the reference's numpy expectation) per pattern."""
    rng = np.random.default_rng(0)
    q = _probe.bf16(rng.normal(0, 1, (B, NP, HD)))
    k = _probe.bf16(rng.normal(0, 1, (B, NP, HD)))
    a = _probe.bf16(rng.uniform(0, 1, (B, NP, NP)))
    x2 = _probe.bf16(rng.normal(0, 1, (1600, 576)))
    qf, kf, af, x2f = (t.float().numpy() for t in (q, k, a, x2))
    return [
        ("A", (q, k), np.einsum("bnh,bmh->bnm", qf, kf)),
        ("B", (a, k), np.einsum("bnm,bmh->bnh", af, kf)),
        ("C", (x2,), x2f.reshape(8, 200, 576)),
        ("D", (x2,), _expect_d(x2f)),
    ]


def results(device=None):
    """Run the four batched-dot patterns; one ``_probe.Result`` each."""
    return _probe.run(probe_batched_dot, SPEC, PLAIN, cases(), CHECK, device)


def main(device=None) -> int:
    """Run the four batched-dot patterns; returns the number of FAILs."""
    return _probe.fails(results(device))


if __name__ == "__main__":
    sys.exit(_probe.cli(main))
