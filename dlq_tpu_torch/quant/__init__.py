"""Post-training quantization: configs, primitives, store, deploy contexts."""
