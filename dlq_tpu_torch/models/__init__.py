"""Model topologies (NHWC activations, HWIO weights, as in dlq_tpu.models)."""
