"""Carry weights from the JAX package's numpy views into the port.

``from_jax_flat`` takes fp32 flat params ``{site: {"w": ndarray, "b":
ndarray | None}}`` (e.g. ``flatten_folded`` output converted with
``np.asarray``); ``from_jax_qflat`` takes the fields of each site's
``QTensor`` as numpy values plus the activation scales. Both carry any
flat site set (a Bottleneck net's ``layer*.*.conv3`` sites included) and
return the port's tensors on ``device`` (default: the card).
``from_jax_tree`` carries any nested dict/list of numpy arrays (a ViT's
``init_vit`` params or ``vit_extras``). Layouts are the same in both
packages, so nothing is transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dlq_tpu_torch.device import DeviceLike, resolve_device
from dlq_tpu_torch.quant.quantize import QTensor


def _t(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_flat(flat_np: Mapping[str, Mapping[str, Any]],
                  device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """fp32 flat params (numpy) -> the port's flat params on ``device``."""
    dev = resolve_device(device)
    return {site: {k: _t(v, dev) for k, v in p.items()} for site, p in flat_np.items()}


def from_jax_qflat(qflat_np: Mapping[str, Mapping[str, Any]],
                   act_scales_np: Optional[Mapping[str, Any]] = None,
                   device: DeviceLike = None) -> Tuple[Dict[str, Dict[str, Any]],
                                                      Dict[str, torch.Tensor]]:
    """Quantized flat params -> (qflat, act_scales) on ``device``.

    ``qflat_np[site]["qw"]`` maps the QTensor field names (values, scale,
    zero_point, bits, axis, group, shape, orig_shape) to numpy arrays or the
    static ints/tuples; ``qflat_np[site]["b"]`` is the fp32 bias or None."""
    dev = resolve_device(device)
    qflat: Dict[str, Dict[str, Any]] = {}
    for site, p in qflat_np.items():
        f = p["qw"]
        qw = QTensor(
            values=_t(f["values"], dev),
            scale=_t(np.asarray(f["scale"], np.float32), dev),
            zero_point=_t(f.get("zero_point"), dev),
            bits=int(f["bits"]),
            axis=f.get("axis"),
            group=f.get("group"),
            shape=tuple(f["shape"]),
            orig_shape=None if f.get("orig_shape") is None else tuple(f["orig_shape"]),
        )
        qflat[site] = {"qw": qw, "b": _t(p.get("b"), dev)}
    scales = {k: _t(np.asarray(v, np.float32), dev) for k, v in (act_scales_np or {}).items()}
    return qflat, scales


def from_jax_tree(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays (or anything ``np.asarray``
    takes) -> the same nesting of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _t(np.asarray(t), dev)

    return conv(tree)
