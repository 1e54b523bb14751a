"""Device-side graph layouts and compute kernels (JAX/XLA)."""

from pecanpy_tpu.ops.layout import DeviceCSR, build_device_csr  # noqa: F401
