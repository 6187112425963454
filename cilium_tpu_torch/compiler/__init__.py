"""Host (numpy) table builders, copies of ``cilium_tpu/compiler``."""
