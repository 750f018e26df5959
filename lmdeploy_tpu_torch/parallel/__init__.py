"""Parallelism over several devices (port of ``lmdeploy_tpu/parallel/``): the device
mesh and the context-parallel KV stripes."""
