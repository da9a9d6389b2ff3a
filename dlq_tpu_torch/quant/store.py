"""Quantized-model persistence: qflat params + act scales <-> Manifest.

Reads and writes the same store format as ``dlq_tpu.quant.store``: int8 /
packed-int4 values (layout ``KO``, logical shape recorded), fp32 scales,
fp32 biases, per-site activation scales, the ``qconfig`` and ``w_shapes``
meta blocks, and a model's fp32 ``extra.*`` tensors (a ViT's cls, pos and
LayerNorm affines, nested names flattened with dots). Tensors come back on
the CPU; engines move them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch.manifest import Manifest, QuantMeta
from dlq_tpu_torch.quant.qconfig import QConfig, QScheme
from dlq_tpu_torch.quant.quantize import QTensor, unpack_int4

FlatParams = Dict[str, Dict[str, Any]]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_quantized(
    root: str,
    model: str,
    qflat: FlatParams,
    act_scales: Optional[Dict[str, torch.Tensor]],
    qcfg: QConfig,
    extras: Optional[Dict[str, Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a deployable quantized model directory; returns the manifest
    path. ``extras``: nested dicts/lists of fp32 tensors stored as
    ``extra.<dotted name>`` (``models.vit.vit_extras``)."""
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
    for name, arr in _flatten_extras(extras or {}):
        m.add(f"extra.{name}", _np(arr).astype(np.float32), kind="extra")
    return m.save()


def load_quantized(root: str) -> Tuple[FlatParams, Dict[str, torch.Tensor], QConfig,
                                       Dict[str, torch.Tensor]]:
    """Read back (qflat, act_scales, qcfg, extras), CPU tensors, ready for a
    deploy context; ``extras`` maps the flat dotted names to fp32 tensors
    (``unflatten_extras`` rebuilds the nesting)."""
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
    extras: Dict[str, torch.Tensor] = {}
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
        elif tm.kind == "extra":
            extras[tm.name[len("extra."):]] = torch.from_numpy(m.read(tm.name))
    for p in qflat.values():
        p.setdefault("b", None)
    return qflat, act_scales, qcfg, extras


def materialize_int8(qflat: FlatParams) -> FlatParams:
    """Unpack every per-OC int4 QTensor to int8 once (exact: the same
    integer values and scales, ``dlq_tpu/quant/store.py:132``): the store
    stays 4-bit on disk, the runtime weights are int8 (``int4_runtime=
    "int8"``). Group-wise int4 stays packed (its scales cannot fold into
    the int8 epilogue)."""
    out: FlatParams = {}
    for site, p in qflat.items():
        qw = p.get("qw")
        if qw is not None and qw.bits == 4 and qw.group is None:
            qw = QTensor(values=unpack_int4(qw.values, qw.shape).reshape(qw.layout_shape),
                         scale=qw.scale, zero_point=None, bits=8, axis=qw.axis, group=None,
                         shape=qw.layout_shape, orig_shape=qw.orig_shape)
            out[site] = {**p, "qw": qw}
        else:
            out[site] = p
    return out


def unflatten_extras(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``_flatten_extras``: dotted names -> nested dicts, with
    all-numeric-key levels turned back into lists (per-layer LN affines)."""
    root: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split(".")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v

    def fix(d):
        if isinstance(d, dict):
            if d and all(k.isdigit() for k in d):
                return [fix(d[str(i)]) for i in range(len(d))]
            return {k: fix(v) for k, v in d.items()}
        return d

    return fix(root)


def _flatten_extras(extras: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in extras.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten_extras(v, name + ".")
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                if isinstance(item, dict):
                    yield from _flatten_extras(item, f"{name}.{i}.")
                else:
                    yield f"{name}.{i}", item
        else:
            yield name, v
