"""How far GPTQ's codes move when its Hessians move by fp32 rounding noise,
on the CPU, with the port's ``dlq_tpu_torch.quant.gptq``.

ResNet-18 (224 px, 1000 classes, the numpy-seeded ``init_resnet``, seed 0;
Hessians of the 8 calibration images of seed 18, as ``chip_smoke.py``'s
``ptq`` phase collects them), INT8_PER_CHANNEL: the codes of
``gptq_quantize_weights`` on the Hessians as collected, against its codes on
the same Hessians scaled entrywise by ``1 + eps * N(0, 1)`` (symmetric),
per site; and each site's GPTQ objective ``tr(dW^T H dW)`` (on the
unperturbed Hessian) of either codes. The card sums its Hessians in
another order than the CPU, so this is the yardstick of the card-against-CPU
gates in ``chip_smoke.py`` (``PTQ_GPTQ_CODE_SHARE``,
``PTQ_GPTQ_OBJECTIVE_REL``).

    python scripts/gptq_hessian_noise.py [--eps 1e-7 1e-6]

Prints one JSON line per eps.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dlq_tpu_torch.models.resnet import (  # noqa: E402
    ResNetConfig, flatten_folded, fold_resnet, init_resnet, qforward,
)
from dlq_tpu_torch.quant.gptq import collect_hessians, gptq_quantize_weights  # noqa: E402
from dlq_tpu_torch.quant.qconfig import INT8_PER_CHANNEL  # noqa: E402
from dlq_tpu_torch.quant.quantize import dequantize  # noqa: E402

SEED = 0


class Perturbed:
    """A collector's Hessians scaled entrywise by 1 + eps * N(0, 1), kept
    symmetric."""

    def __init__(self, col, eps: float, rng: np.random.Generator):
        self.meta, self.mean = col.meta, col.mean
        self.H = {}
        for site, h in col.H.items():
            n = rng.normal(0, 1, h.shape)
            self.H[site] = h * (1 + eps * (n + n.T) / 2)


def objective(w, qw, H) -> float:
    w64 = w.numpy().astype(np.float64)
    dw = w64 - dequantize(qw).numpy().astype(np.float64).reshape(qw.layout_shape)
    if dw.ndim == 4:
        dw = dw.transpose(2, 0, 1, 3)
    dw = dw.reshape(-1, dw.shape[-1])
    return float(np.einsum("ko,ko->", dw, H @ dw))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    args = ap.parse_args()
    cfg = ResNetConfig(depth=18, num_classes=1000)
    flat = flatten_folded(fold_resnet(init_resnet(SEED, cfg), cfg))
    calib = [np.random.default_rng(SEED + 18).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)]
    col = collect_hessians(qforward, flat, cfg, calib)
    base = gptq_quantize_weights(flat, INT8_PER_CHANNEL, col)
    rng = np.random.default_rng(1)
    for eps in args.eps:
        q = gptq_quantize_weights(flat, INT8_PER_CHANNEL, Perturbed(col, eps, rng))
        share = {s: float((q[s]["qw"].values != base[s]["qw"].values).float().mean())
                 for s in base}
        total = sum(base[s]["qw"].values.numel() for s in base)
        differ = sum(int((q[s]["qw"].values != base[s]["qw"].values).sum()) for s in base)
        rel = {}
        for s in base:
            a = objective(flat[s]["w"], q[s]["qw"], col.H[s])
            b = objective(flat[s]["w"], base[s]["qw"], col.H[s])
            rel[s] = abs(a - b) / b
        print(json.dumps({"eps": eps, "platform": "cpu", "code_share_differing": differ / total,
                          "code_share_by_site": share,
                          "objective_rel_diff_max": max(rel.values()),
                          "objective_rel_diff_by_site": rel}), flush=True)


if __name__ == "__main__":
    main()
