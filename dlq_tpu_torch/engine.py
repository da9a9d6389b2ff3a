"""Persistent batched inference engine (the counterpart of
``dlq_tpu.engine``).

Weights live on the device once, the deploy context (with its K-major
repacked weights) is built once, and batches stream through at a fixed
batch size: short batches are zero-padded and the padding rows dropped.
PyTorch runs eagerly, so there is no compile step; ``dispatch`` enqueues a
batch on the current CUDA stream and returns without waiting, and
``classify`` keeps up to ``pipeline`` batches in flight.

Entry points run on the card (``device=None``) and raise without one unless
the caller passes ``device="cpu"``. Mesh, tensor-parallel and wire options
of the reference engine are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from dlq_tpu_torch.device import DeviceLike, resolve_device
from dlq_tpu_torch.ops.qops import resolve_depthwise
from dlq_tpu_torch.quant.calibrate import calibrate
from dlq_tpu_torch.quant.model_quant import (
    DeployCtx, DynamicDeployCtx, SimulateCtx, make_sites_fn, quantize_weights,
)
from dlq_tpu_torch.quant.qconfig import QConfig
from dlq_tpu_torch.quant.quantize import QTensor
from dlq_tpu_torch.timing import StageTimer


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    images: int = 0          # every image submitted (sync or async)
    images_timed: int = 0    # images covered by a timed window
    ms_total: float = 0.0    # wall ms of the timed windows only

    @property
    def images_per_sec(self) -> float:
        """Throughput over the timed windows only (``__call__`` brackets each
        synchronous batch, ``classify`` its whole stream; ``dispatch`` is
        asynchronous and untimed)."""
        return self.images_timed / (self.ms_total / 1e3) if self.ms_total else 0.0


def to_device(tree: Any, device: torch.device) -> Any:
    """Move every tensor (and QTensor) in nested dicts/lists to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, QTensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor in nested dicts/lists to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def pad_to_batch(x: torch.Tensor, batch: int):
    """Zero-pad axis 0 up to ``batch`` on the tensor's own device; returns
    (padded, real rows)."""
    n = x.shape[0]
    if n == batch:
        return x, n
    if n > batch:
        raise ValueError(f"batch {n} > engine batch {batch}")
    return torch.cat([x, x.new_zeros((batch - n,) + tuple(x.shape[1:]))]), n


class Engine:
    """One forward + resident params; call it like a function."""

    def __init__(self, forward: Callable[[Any, torch.Tensor], torch.Tensor], params: Any, *,
                 batch: int = 32, device: DeviceLike = None,
                 input_dtype: torch.dtype = torch.float32, name: str = "engine"):
        self.device = resolve_device(device)
        self.batch = batch
        self.name = name
        self.input_dtype = input_dtype
        self.timer = StageTimer()
        self.stats = EngineStats()
        self._fn = forward
        self.params = params

    # ---------------- constructors ----------------

    @staticmethod
    def fp32(model_forward, params, cfg, *, device: DeviceLike = None, **kw) -> "Engine":
        dev = resolve_device(device)
        return Engine(lambda p, x: model_forward(p, x, cfg), to_device(params, dev),
                      device=dev, **kw)

    @staticmethod
    def bf16(model_forward, params, cfg, *, device: DeviceLike = None, **kw) -> "Engine":
        """Every floating leaf of ``params`` and the input in bf16, fp32
        logits out (``dlq_tpu/engine.py:120``): PyTorch's bf16 convs and
        matmuls, as the reference leaves them to XLA. Serves the unfolded
        ``resnet_forward`` and the folded ``qforward(ObserveCtx(p), ...)``."""
        dev = resolve_device(device)
        return Engine(lambda p, x: model_forward(p, x.to(torch.bfloat16), cfg).float(),
                      cast_floats(to_device(params, dev), torch.bfloat16), device=dev,
                      input_dtype=torch.bfloat16, **kw)

    @staticmethod
    def quantized(qforward, flat_params, cfg, qcfg: QConfig,
                  calib_batches: Optional[Iterable] = None,
                  act_scales: Optional[Dict[str, torch.Tensor]] = None,
                  simulate: bool = False, dynamic: bool = False,
                  depthwise: Optional[str] = None,
                  *, device: DeviceLike = None, **kw) -> "Engine":
        """PTQ an fp32 flat-param model into a deployed W8A8 engine
        (DeployCtx). ``calib_batches`` is required unless the config is
        weight-only, ``act_scales`` are given or ``dynamic``.
        ``dynamic``: run-time activation scales (DynamicDeployCtx, no
        calibration); ``simulate``: the fp32 fake-quant oracle
        (SimulateCtx), with the reference's guards (``dlq_tpu/engine.py:157-166``).
        ``depthwise``: the depthwise-conv implementation ("int8" | "fp32" |
        "stencil"), resolved once here (``ops.qops.resolve_depthwise``)."""
        if dynamic and qcfg.weight_only:
            raise ValueError("dynamic=True quantizes activations at runtime; "
                             "qcfg is weight-only (acts=None)")
        if dynamic and simulate:
            raise ValueError("simulate=True is the static fake-quant oracle; "
                             "it has no dynamic variant")
        dw = resolve_depthwise(depthwise)
        dev = resolve_device(device)
        flat = to_device(flat_params, dev)
        if not qcfg.weight_only and act_scales is None and not dynamic:
            if calib_batches is None:
                raise ValueError("activation quantization needs calib_batches, act_scales, "
                                 "or dynamic=True")
            batches = (torch.as_tensor(np.asarray(b), dtype=torch.float32, device=dev)
                       for b in calib_batches)
            act_scales = calibrate(make_sites_fn(qforward, cfg), flat, batches, qcfg)
        act_scales = to_device(act_scales or {}, dev)
        qflat = quantize_weights(flat, qcfg)
        if dynamic:
            ctx = DynamicDeployCtx(qflat, qcfg, depthwise=dw)
        elif simulate:
            ctx = SimulateCtx(qflat, act_scales, qcfg)
        else:
            ctx = DeployCtx(qflat, act_scales, qcfg, depthwise=dw)
        eng = Engine(lambda c, x: qforward(c, x, cfg), ctx, device=dev, **kw)
        eng.act_scales = act_scales
        eng.qflat = qflat
        eng.qcfg = qcfg
        return eng

    @staticmethod
    def from_store(qmanifest: str, ctx: str = "deploy", int4_runtime: str = "packed",
                   depthwise: Optional[str] = None, *,
                   device: DeviceLike = None, **kw) -> "Engine":
        """Cold-start an engine from a quantized store (``quant.store``), no
        calibration data or fp32 weights. ResNet-18/34/50/101/152 with ctx
        "deploy" | "pallas" | "fused" | "fused2" | "dynamic" (fused2 =
        fully-int8 interchange; "fused" is BasicBlock-only, as the
        reference's ``qforward_fused`` is; "dynamic" = DynamicDeployCtx,
        run-time activation scales, which a weight-only store refuses);
        LeNet-5 (``lenet5``, its config from the store's ``num_classes`` and
        ``in_channels``) and the MLP (``mlp``, ``MLPConfig()``) with the same
        five, each running its ``qforward``; MobileNetV2 with the same five, each running
        ``make_qforward`` under its context (``dlq_tpu/engine.py:245-252``;
        the config from ``num_classes`` and ``small_input`` only, as the
        reference's, so a store's width multiplier is not read), its
        depthwise convs by ``depthwise`` ("int8" | "fp32" | "stencil",
        resolved once: ``ops.qops.resolve_depthwise``); and DeiT
        (``deit_tiny``) with ctx "block" (the W8A8 block kernels K5/K6/K7,
        K8/K6/K9 on per-OC int4 weights with activations, K11/K6/K12 on
        weight-only per-OC int4 weights) |
        "deploy" (every dense on K2, or K10 for a per-OC int4 one with
        activations, K13 for a group-wise int4 weight-only one; attention on
        K6 on the card).

        int4_runtime: "packed" keeps per-OC int4 weights 4-bit on the card
        (the W4A8 kernels); "int8" unpacks them to int8 once at load
        (``materialize_int8``: the W8A8 kernels, the int4 store on disk
        only). Group-wise int4 always stays packed."""
        from dlq_tpu_torch.manifest import Manifest
        from dlq_tpu_torch.quant.store import load_quantized, materialize_int8

        dw = resolve_depthwise(depthwise)
        dev = resolve_device(device)
        man = Manifest.load(qmanifest)
        model = man.model
        mcfg = man.meta.get("config", {})
        qflat, act_scales, qcfg, extras = load_quantized(qmanifest)
        if int4_runtime == "int8":
            qflat = materialize_int8(qflat)
        elif int4_runtime != "packed":
            raise ValueError(f"int4_runtime must be 'packed' or 'int8', got {int4_runtime!r}")
        if model == "deit_tiny":
            return _vit_from_store(qflat, act_scales, qcfg, extras, mcfg, ctx, dev, **kw)
        from dlq_tpu_torch.quant import model_quant as MQ

        Ctxs = {"deploy": MQ.DeployCtx, "pallas": MQ.PallasDeployCtx,
                "fused": MQ.FusedDeployCtx, "fused2": MQ.FullFusedCtx}
        if model == "mobilenetv2":
            from dlq_tpu_torch.models.mobilenetv2 import (
                MobileNetV2Config, block_meta, make_qforward,
            )

            cfg = MobileNetV2Config(num_classes=mcfg.get("num_classes", 1000),
                                    small_input=bool(mcfg.get("small_input", False)))
            qf = make_qforward(block_meta(cfg))
        elif model.startswith("resnet"):
            from dlq_tpu_torch.models.resnet import (
                ResNetConfig, qforward, qforward_fused, qforward_fused2,
            )

            cfg = ResNetConfig(depth=int(model[6:]), num_classes=mcfg.get("num_classes", 1000),
                               small_input=bool(mcfg.get("small_input", False)))
            if ctx == "fused" and cfg.bottleneck:
                raise NotImplementedError(
                    f"ctx='fused' is BasicBlock-only; {model} runs with ctx='fused2', "
                    "'deploy' or 'pallas'")
            qf = {"fused": qforward_fused, "fused2": qforward_fused2}.get(ctx, qforward)
        elif model == "mlp":
            from dlq_tpu_torch.models.mlp import MLPConfig, qforward as qf

            cfg = MLPConfig()
        elif model == "lenet5":
            from dlq_tpu_torch.models.lenet import LeNetConfig, qforward as qf

            cfg = LeNetConfig(num_classes=mcfg.get("num_classes", 10),
                              in_channels=mcfg.get("in_channels", 1))
        else:
            raise ValueError(f"from_store: unsupported model {model}")
        if ctx == "dynamic":
            if qcfg.weight_only:
                raise ValueError("ctx='dynamic' quantizes activations at runtime; this store is "
                                 "weight-only (acts=None): use ctx='deploy'")
            c = MQ.DynamicDeployCtx(to_device(qflat, dev), qcfg, depthwise=dw)
        elif ctx in Ctxs:
            c = Ctxs[ctx](to_device(qflat, dev), to_device(act_scales, dev), qcfg, depthwise=dw)
        else:
            raise ValueError(f"ctx must be one of {sorted([*Ctxs, 'dynamic'])}, got {ctx!r}")
        eng = Engine(lambda cc, x: qf(cc, x, cfg), c, device=dev, name=f"{model}_{ctx}", **kw)
        eng.qcfg = qcfg
        eng.model_cfg = cfg
        return eng

    # ---------------- execution ----------------

    def _input(self, x) -> tuple:
        """A batch as a padded tensor on the engine's device: a tensor is
        padded where it lies (numpy on the host), then moved once."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        xp, n = pad_to_batch(x, self.batch)
        return xp.to(self.device, self.input_dtype), n

    def __call__(self, x) -> torch.Tensor:
        """Run one batch (padding included); returns the logits of the real
        rows, after the device has finished them."""
        xt, n = self._input(x)
        t0 = time.perf_counter()
        with self.timer.stage("forward"), torch.inference_mode():
            out = self.timer.sync(self._fn(self.params, xt))
        self.stats.batches += 1
        self.stats.images += n
        self.stats.images_timed += n
        self.stats.ms_total += (time.perf_counter() - t0) * 1e3
        return out[:n]

    def dispatch(self, x) -> torch.Tensor:
        """Asynchronous single-batch submit: pads, uploads and enqueues the
        forward; returns the device logits of the real rows without waiting."""
        xt, n = self._input(x)
        with torch.inference_mode():
            out = self._fn(self.params, xt)
        self.stats.batches += 1
        self.stats.images += n
        return out[:n]

    def classify(self, images, top: int = 1, pipeline: int = 2) -> np.ndarray:
        """Stream any number of images; returns argmax class indices (or the
        ``top`` best). ``images``: numpy or a tensor (sliced where it lies).
        Up to ``pipeline`` batches are in flight before the oldest is
        fetched."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        preds = []
        pending: list = []

        def drain():
            logits = pending.pop(0).float().cpu().numpy()
            preds.append(np.argsort(-logits, -1)[:, :top] if top > 1
                         else np.argmax(logits, -1))

        t0 = time.perf_counter()
        for i in range(0, len(images), self.batch):
            pending.append(self.dispatch(images[i: i + self.batch]))
            while len(pending) >= max(1, pipeline):
                drain()
        while pending:
            drain()
        self.stats.ms_total += (time.perf_counter() - t0) * 1e3
        self.stats.images_timed += len(images)
        return np.concatenate(preds)


def _vit_from_store(qflat, act_scales, qcfg: QConfig, extras, mcfg, ctx: str,
                    dev: torch.device, **kw) -> Engine:
    """DeiT from a store (``dlq_tpu/engine.py:264-383``). ctx="block": the
    stacked W8A8 forward (6 layers per chunk when the depth allows, else 1)
    on per-channel int8 block sites, the W4A8 block forward (K8 -> K6 -> K9
    per layer, bf16 between layers) on per-OC int4 block sites with
    activations, the W4A16 block forward (K11 -> K6 -> K12 per layer, bf16
    between layers, ``deit_tiny_block_w4``) on weight-only per-OC int4 block
    sites; group-wise or int8 weight-only stores raise the reference's
    ValueError. ctx="deploy": ``make_qforward`` under DeployCtx, attention on
    K6 on the card and plain on the CPU."""
    from dlq_tpu_torch.models.vit import ViTConfig, make_qforward
    from dlq_tpu_torch.ops.vit_block import (
        pack_vit_blocks_w4, pack_vit_blocks_w4a8, pack_vit_blocks_w8, stack_vit_blocks_w8,
        vit_forward_blockfused_w4a8c, vit_forward_blockfused_w4c, vit_forward_multiblock_w8,
    )
    from dlq_tpu_torch.quant.store import unflatten_extras

    cfg = ViTConfig(**{k: mcfg[k] for k in ("num_classes", "image_size", "patch", "dim",
                                            "depth", "heads", "mlp_ratio") if k in mcfg})
    ex = to_device(unflatten_extras(extras), dev)
    # route on the loaded block sites' effective widths (after int4_runtime)
    blk_qw = [p["qw"] for name, p in qflat.items()
              if name.startswith("l") and "." in name and "qw" in p]
    blk_bits = {(qw.bits, qw.group is None) for qw in blk_qw}
    w4_blocks = bool(blk_qw) and blk_bits == {(4, True)}
    if ctx == "block":
        # the reference's routing guards (dlq_tpu/engine.py:279-302)
        if not blk_qw:
            raise ValueError("ctx='block' needs transformer-block (l<i>.*) weight sites, but "
                             "this store has none: not a ViT-family artifact? use ctx='deploy'")
        if qcfg.weight_only and not w4_blocks:
            raise ValueError("ctx='block' on a weight-only store needs per-OC int4 weights; "
                             "group-wise or int8 weight-only stores have no fused block path: "
                             "use ctx='deploy'")
        if not w4_blocks and blk_bits != {(8, True)}:
            raise ValueError("ctx='block' needs per-channel int8 (or per-OC int4) across ALL "
                             f"transformer-block sites, got {sorted(blk_bits)}: use "
                             "ctx='deploy'")
        qd, sd = to_device(qflat, dev), to_device(act_scales, dev)
        if qcfg.weight_only:
            packed = pack_vit_blocks_w4(qd, ex, cfg, tight=True)
            eng = Engine(lambda p, x: vit_forward_blockfused_w4c(p, x, cfg, tight=True),
                         packed, device=dev, name="deit_tiny_block_w4", **kw)
        elif w4_blocks:
            packed = pack_vit_blocks_w4a8(qd, sd, ex, cfg, tight=True)
            eng = Engine(lambda p, x: vit_forward_blockfused_w4a8c(p, x, cfg, tight=True),
                         packed, device=dev, name="deit_tiny_block_w4a8", **kw)
        else:
            packed = pack_vit_blocks_w8(qd, sd, ex, cfg, tight=True)
            lpk = 6 if cfg.depth % 6 == 0 else 1
            packed["_chunks"] = stack_vit_blocks_w8(packed, lpk)
            packed.pop("blocks")  # the forward reads only the chunks
            eng = Engine(lambda p, x: vit_forward_multiblock_w8(p, x, cfg, tight=True), packed,
                         device=dev, name="deit_tiny_block", **kw)
    elif ctx == "deploy":
        attn = "xla" if dev.type == "cpu" else "fused"
        qf = make_qforward(ex, cfg.depth, cfg.heads, cfg.patch, cfg.dim, attn_impl=attn)
        c = DeployCtx(to_device(qflat, dev), to_device(act_scales, dev), qcfg)
        eng = Engine(lambda cc, x: qf(cc, x, cfg), c, device=dev, name="deit_tiny_deploy", **kw)
    else:
        raise ValueError("deit_tiny supports ctx='deploy' or 'block' (the fused "
                         "int8-interchange contexts are conv-model paths)")
    eng.qcfg = qcfg
    eng.model_cfg = cfg
    return eng
