"""dlq_tpu_torch — the PyTorch/CUDA port of dlq_tpu for one NVIDIA H100.

The JAX package ``dlq_tpu`` is the reference: the same store and the same
input give the same int8 tensors here. Plain tensor code is PyTorch; every
TPU kernel on the ported path is a CUDA C++ kernel for ``sm_90a`` under
``dlq_tpu_torch/csrc``, built with ``nvcc`` at first use into
``build/dlq_tpu_torch/`` (``dlq_tpu_torch._build``).

Layouts match the reference so tests compare like with like: NHWC
activations, HWIO conv weights, IO dense weights, flat
``{site: {"qw" | "w", "b"}}`` params. Entry points default to
``device="cuda"`` and raise without a card unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
