"""Hopper probe: CUDA kernel K7 (``y = 2 * x``) and its plain version.

Port of the probe kernel of ``scripts/pallas_probe.py::stage_trivial_copy``
(``:62-78``), which asks whether a kernel runs on the device at all. The
kernel lives in ``veomni_tpu_torch/csrc/probe.cu`` (``vt_probe_double``).
``probe_double`` launches it for a CUDA tensor and takes the plain version
for a CPU tensor; ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "probe.cu"
LAUNCHES = {"probe_double": 0}


def reset_counts() -> None:
    LAUNCHES["probe_double"] = 0


def probe_double_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def _lib() -> ctypes.CDLL:
    from veomni_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_vt_typed", False):
        lib.vt_probe_double.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.vt_probe_double.restype = ctypes.c_int
        lib._vt_typed = True
    return lib


def probe_double_cuda(x: torch.Tensor) -> torch.Tensor:
    """K7 on a contiguous float32 CUDA tensor."""
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"probe kernel takes a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    y = torch.empty_like(x)
    err = _lib().vt_probe_double(x.data_ptr(), y.data_ptr(), x.numel(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_double launch failed: CUDA error {err}")
    LAUNCHES["probe_double"] += 1
    return y


def probe_double(x: torch.Tensor) -> torch.Tensor:
    """K7 on CUDA tensors, its plain version on CPU tensors."""
    return probe_double_cuda(x) if x.is_cuda else probe_double_plain(x)
