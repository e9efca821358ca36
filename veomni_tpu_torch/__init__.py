"""PyTorch/CUDA port of ``veomni_tpu`` for NVIDIA Hopper (H100).

The JAX package ``veomni_tpu`` stays the reference; this package mirrors its
module paths (``veomni_tpu_torch/ops/rms_norm.py`` <-> ``veomni_tpu/ops/
rms_norm.py``) and imports neither JAX nor anything of ``veomni_tpu``.
Every Pallas kernel on a ported path becomes a hand-written CUDA C++ kernel
under ``csrc/`` (built with ``nvcc`` at first use). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
