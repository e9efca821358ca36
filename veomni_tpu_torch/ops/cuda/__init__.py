"""Hand-written Hopper (sm_90a) kernels, counterpart of ``veomni_tpu/ops/pallas``."""
