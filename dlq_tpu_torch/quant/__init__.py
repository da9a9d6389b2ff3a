"""Post-training quantization: configs, primitives, store, deploy contexts,
and the PTQ toolbox (the counterpart of ``dlq_tpu.quant``):

  calibrate.py    minmax / percentile / MSE activation-scale calibration
  quantize.py     QTensor, symmetric int8/int4/int2, per-tensor/-OC/-group
  qconfig.py      dataclass recipes + per-site mixed-precision overrides
  model_quant.py  observe/deploy(+dynamic)/fused/fully-fused/simulate ctxs
  gptq.py         Hessian-aware rounding + analytic bias correction
  smooth.py       SmoothQuant outlier migration (+ global alpha search)
  sensitivity.py  per-site damage scores -> automatic mixed precision
  recipe.py       ptq_auto: the composed one-call pipeline
  qat.py          clipped-STE quantization-aware training (bits 8/4/2)
  store.py        deployable quantized manifest (cold-start artifact)
  error_report.py per-layer quant-error / top-1 delta harness
"""

from dlq_tpu_torch.quant.qconfig import QConfig, QScheme  # noqa: F401
from dlq_tpu_torch.quant.quantize import (  # noqa: F401
    QTensor,
    dequantize,
    pack_int4,
    quantize_tensor,
    unpack_int4,
)
