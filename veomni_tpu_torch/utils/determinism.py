"""Determinism utilities.

Port of ``veomni_tpu/utils/determinism.py``. There, both functions are
no-ops past seeding, because XLA:TPU compiles fixed reduction orders for
fixed shapes. On a CUDA card that is not so: cuBLAS may pick split-K
reductions that depend on its workspace, and some torch ops accumulate with
atomics. ``enable_full_determinism`` therefore does what the reference's
upstream does on GPUs (``utils/helper.py:425-463`` of the original
framework): it sets ``CUBLAS_WORKSPACE_CONFIG`` and calls
``torch.use_deterministic_algorithms(True)``, under which an op with no
deterministic CUDA implementation raises instead of running. The port's own
kernels are deterministic by construction (fixed summation orders, no
atomics). ``set_batch_invariant_mode`` stays a documented no-op: the port
has no batch-invariant kernels, and a fixed-shape packed pipeline runs the
same shapes every step.
"""

from __future__ import annotations

import contextlib
import os

import torch

from veomni_tpu_torch.utils.helper import set_seed

# the workspace setting cuBLAS documents for reproducible results
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def set_batch_invariant_mode(enabled: bool = True):
    """No-op (see the module docstring)."""
    yield


def enable_full_determinism(seed: int, device="cpu") -> torch.Generator:
    """Seed every stream, pin cuBLAS's workspace and make torch raise on
    any op that has no deterministic implementation. Returns the seeded
    generator of :func:`set_seed`. ``CUBLAS_WORKSPACE_CONFIG`` takes effect
    for cuBLAS handles created after it is set, so call this before the
    first matrix product on the card; a value the caller already set is
    kept."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)
    return set_seed(seed, device)
