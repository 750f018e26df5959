"""Layer primitives and linear layers (port of ``lmdeploy_tpu/nn``)."""
