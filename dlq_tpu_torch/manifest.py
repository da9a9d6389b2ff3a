"""Weight-exchange manifest: a directory of raw row-major ``.bin`` tensors
described by ``manifest.json``.

The on-disk format is the one ``dlq_tpu.manifest`` writes and reads
(version 2): per-tensor dtype, logical shape, layout and an optional
``quant`` block, int4 stored nibble-packed along axis 0. This is the port's
own copy of that reader/writer; it needs numpy only, and ``ml_dtypes`` only
for a bf16 tensor, which a W8A8 store does not contain.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

MANIFEST_VERSION = 2
MANIFEST_NAME = "manifest.json"

# dtype name <-> numpy dtype for raw .bin serialization. int4 tensors are
# stored packed two-nibbles-per-byte as uint8 with logical shape recorded.
_DTYPES: Dict[str, Any] = {
    "float32": np.float32,
    "float16": np.float16,
    "bfloat16": None,  # via ml_dtypes, resolved lazily
    "int32": np.int32,
    "int8": np.int8,
    "uint8": np.uint8,
    "int4": np.uint8,  # packed
    "int2": np.int8,   # stored as int8 values in [-1, 1]; bits kept in dtype
}


def _np_dtype(name: str):
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(_DTYPES[name])


@dataclasses.dataclass
class QuantMeta:
    """Per-tensor quantization block."""

    scheme: str = "symmetric"
    axis: Optional[int] = None
    group: Optional[int] = None
    scale: Optional[str] = None
    zero_point: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None or k == "axis"}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "QuantMeta":
        return QuantMeta(
            scheme=d.get("scheme", "symmetric"),
            axis=d.get("axis"),
            group=d.get("group"),
            scale=d.get("scale"),
            zero_point=d.get("zero_point"),
        )


@dataclasses.dataclass
class TensorMeta:
    """One tensor entry: shape is the LOGICAL shape (pre-packing for int4)."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    layout: str
    kind: str
    path: str
    quant: Optional[QuantMeta] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "shape": list(self.shape),
            "dtype": self.dtype,
            "layout": self.layout,
            "kind": self.kind,
            "path": self.path,
        }
        if self.quant is not None:
            d["quant"] = self.quant.to_json()
        return d

    @staticmethod
    def from_json(name: str, d: Dict[str, Any]) -> "TensorMeta":
        q = QuantMeta.from_json(d["quant"]) if "quant" in d else None
        return TensorMeta(
            name=name,
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            layout=d.get("layout", "raw"),
            kind=d.get("kind", "other"),
            path=d["path"],
            quant=q,
        )


class Manifest:
    """A directory of raw tensor .bin files described by ``manifest.json``."""

    def __init__(self, root: str, model: str = "", meta: Optional[Dict[str, Any]] = None):
        self.root = root
        self.model = model
        self.meta: Dict[str, Any] = dict(meta or {})
        self.tensors: Dict[str, TensorMeta] = {}

    def add(
        self,
        name: str,
        array: np.ndarray,
        *,
        layout: str = "raw",
        kind: str = "other",
        dtype: Optional[str] = None,
        logical_shape: Optional[Tuple[int, ...]] = None,
        quant: Optional[QuantMeta] = None,
    ) -> TensorMeta:
        """Add a tensor; writes ``<root>/<name>.bin`` immediately."""
        dtype = dtype or _dtype_name(array.dtype)
        rel = name + ".bin"
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        arr = np.ascontiguousarray(array)
        arr.tofile(path)
        tm = TensorMeta(
            name=name,
            shape=tuple(logical_shape if logical_shape is not None else arr.shape),
            dtype=dtype,
            layout=layout,
            kind=kind,
            path=rel,
            quant=quant,
        )
        self.tensors[name] = tm
        return tm

    def save(self) -> str:
        os.makedirs(self.root, exist_ok=True)
        doc = {
            "version": MANIFEST_VERSION,
            "model": self.model,
            "meta": self.meta,
            "tensors": {n: t.to_json() for n, t in sorted(self.tensors.items())},
        }
        path = os.path.join(self.root, MANIFEST_NAME)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path

    @staticmethod
    def load(root: str) -> "Manifest":
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            doc = json.load(f)
        ver = doc.get("version", 1)
        if ver > MANIFEST_VERSION:
            raise ValueError(
                f"{root}: manifest version {ver} is newer than this build "
                f"supports ({MANIFEST_VERSION}); refusing to guess at its schema")
        m = Manifest(root, model=doc.get("model", ""), meta=doc.get("meta", {}))
        for name, d in doc.get("tensors", {}).items():
            m.tensors[name] = TensorMeta.from_json(name, d)
        return m

    def read(self, name: str) -> np.ndarray:
        """Read a tensor back as numpy, with size validation."""
        tm = self.tensors[name]
        path = os.path.join(self.root, tm.path)
        data = np.fromfile(path, dtype=_np_dtype(tm.dtype))
        expect = _storage_elems(tm)
        if data.size != expect:
            raise ValueError(
                f"{name}: file {path} holds {data.size} elems of {tm.dtype}, "
                f"expected {expect} for logical shape {tm.shape}")
        return data.reshape(_storage_shape(tm))

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def __iter__(self) -> Iterator[TensorMeta]:
        return iter(self.tensors.values())

    def names(self):
        return list(self.tensors.keys())


def _dtype_name(dt) -> str:
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return "bfloat16"
    for name, npdt in _DTYPES.items():
        if npdt is not None and np.dtype(npdt) == dt and name != "int4":
            return name
    raise ValueError(f"unsupported dtype {dt}")


def _storage_shape(tm: TensorMeta) -> Tuple[int, ...]:
    if tm.dtype == "int4":
        # packed two-nibbles-per-byte along axis 0
        s = list(tm.shape)
        s[0] = (s[0] + 1) // 2
        return tuple(s)
    return tm.shape


def _storage_elems(tm: TensorMeta) -> int:
    return int(np.prod(_storage_shape(tm))) if tm.shape else 1
