"""Quantized-model persistence: qflat params + act scales <-> Manifest.

Reads and writes the same store format as ``dlq_tpu.quant.store``: int8 /
packed-int4 values (layout ``KO``, logical shape recorded), fp32 scales,
fp32 biases, per-site activation scales, and the ``qconfig`` and
``w_shapes`` meta blocks. Tensors come back on the CPU; engines move them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch.manifest import Manifest, QuantMeta
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme
from dlq_tpu_torch.quant.quantize import QTensor

FlatParams = Dict[str, Dict[str, Any]]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_quantized(
    root: str,
    model: str,
    qflat: FlatParams,
    act_scales: Optional[Dict[str, torch.Tensor]],
    qcfg: QConfig,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a deployable quantized model directory; returns the manifest path."""
    m = Manifest(root, model=model, meta={
        "qconfig": {
            "weights": dataclasses.asdict(qcfg.weights),
            "acts": dataclasses.asdict(qcfg.acts) if qcfg.acts else None,
            "weight_overrides": [
                [pat, dataclasses.asdict(s)] for pat, s in qcfg.weight_overrides
            ],
            "calibration": qcfg.calibration,
            "percentile": qcfg.percentile,
        },
        **(meta or {}),
    })
    for site, p in qflat.items():
        qw: QTensor = p["qw"]
        scale_name = f"{site}.w.scale"
        # int2 values are stored in int8 arrays but keep their bit-width in
        # the manifest dtype so the round-trip preserves QTensor.bits
        dtype = {4: "int4", 2: "int2"}.get(qw.bits, "int8")
        m.add(
            f"{site}.w", _np(qw.values),
            dtype=dtype,
            logical_shape=qw.shape,
            layout="KO",
            kind="qweight",
            quant=QuantMeta(scheme="symmetric", axis=qw.axis, group=qw.group,
                            scale=scale_name),
        )
        m.add(scale_name, _np(qw.scale).astype(np.float32), kind="scale")
        # original layout shape so convs can reshape back
        m.meta.setdefault("w_shapes", {})[site] = list(qw.layout_shape)
        if p.get("b") is not None:
            m.add(f"{site}.b", _np(p["b"]).astype(np.float32), layout="O", kind="bias")
    for site, s in (act_scales or {}).items():
        m.add(f"{site}.act.scale", _np(s).astype(np.float32).reshape(-1), kind="act_scale")
    return m.save()


def load_quantized(root: str) -> Tuple[FlatParams, Dict[str, torch.Tensor], QConfig]:
    """Read back (qflat, act_scales, qcfg), CPU tensors, ready for a deploy
    context. A store's ``extra.*`` tensors (ViT extras) are not read by
    this slice."""
    m = Manifest.load(root)
    if "qconfig" not in m.meta:
        raise ValueError(
            f"{root}: manifest has no 'qconfig' meta block — this is a plain "
            "weight export, not a quantized store")
    qc = m.meta["qconfig"]
    qcfg = QConfig(
        weights=QScheme(**qc["weights"]),
        acts=QScheme(**qc["acts"]) if qc.get("acts") else None,
        calibration=qc.get("calibration", "minmax"),
        percentile=qc.get("percentile", 99.99),
        weight_overrides=tuple(
            (pat, QScheme(**d)) for pat, d in qc.get("weight_overrides", [])
        ),
    )
    w_shapes = m.meta.get("w_shapes", {})
    qflat: FlatParams = {}
    act_scales: Dict[str, torch.Tensor] = {}
    for tm in m:
        if tm.kind == "qweight":
            site = tm.name[: -len(".w")]
            qflat.setdefault(site, {})["qw"] = QTensor(
                values=torch.from_numpy(m.read(tm.name)),
                scale=torch.from_numpy(m.read(tm.quant.scale)),
                zero_point=None,
                bits={"int4": 4, "int2": 2}.get(tm.dtype, 8),
                axis=tm.quant.axis,
                group=tm.quant.group,
                shape=tuple(tm.shape),
                orig_shape=tuple(w_shapes.get(site, tm.shape)),
            )
        elif tm.kind == "bias":
            site = tm.name[: -len(".b")]
            qflat.setdefault(site, {})["b"] = torch.from_numpy(m.read(tm.name))
        elif tm.kind == "act_scale":
            site = tm.name[: -len(".act.scale")]
            arr = m.read(tm.name)
            act_scales[site] = torch.from_numpy(arr.reshape(()) if arr.size == 1 else arr)
    for p in qflat.values():
        p.setdefault("b", None)
    return qflat, act_scales, qcfg
