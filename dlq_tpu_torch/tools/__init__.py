"""The port's diagnostic entry points.

``probe_mosaic_patterns`` (K19), ``probe_batched_dot`` (K20),
``probe_block_patterns`` (K21) and ``probe_stem_patterns`` (K22) are the
counterparts of the reference's ``tools/probe_*.py`` lowering probes: each
runs one small hand-written kernel per memory or compute pattern a fused
kernel needs, at the reference's shapes and on its numpy-seeded inputs, and
holds the result against the reference's own numpy expectation. They serve
no model. Run one with

    python -m dlq_tpu_torch.tools.probe_<name>               # on the card
    python -m dlq_tpu_torch.tools.probe_<name> --device cpu  # plain versions
"""
