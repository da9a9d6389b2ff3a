"""Model topologies (NHWC activations, HWIO weights, as in dlq_tpu.models)."""

from dlq_tpu_torch.models.registry import available, get_model, register  # noqa: F401
