"""Device abstraction layer (port of ``veomni_tpu/utils/device.py``).

The reference abstracts over TPU generations and a CPU test backend; here the
device is ``cuda`` (Hopper) or ``cpu``, and it is always explicit: entry
points take a ``device`` argument, default to ``cuda``, and raise when no card
is present instead of dropping to the CPU. The TPU/relay logic of the
reference (``device.py:13-123``) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]

# NVIDIA H100 SXM data sheet, dense (no sparsity) tensor-core peaks at the
# 700 W power limit; H200 SXM shares the compute die.
_PEAK_FLOPS_BF16 = {"h100": 989e12, "h200": 989e12}
# NVIDIA data sheets: HBM3 3.35 TB/s (H100 SXM), HBM3e 4.8 TB/s (H200 SXM).
_PEAK_BANDWIDTH = {"h100": 3.35e12, "h200": 4.8e12}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    something else. Never falls back to the CPU silently.

    Selecting a CUDA device also turns TF32 off for float32 matmuls and
    convolutions (``allow_tf32 = False``): TF32 keeps ~3 decimal digits, and
    the f32 reference math of this port (master weights, f32 logits in the
    fused CE) must stay full float32 like the JAX package's.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: this entry point runs on an NVIDIA GPU "
                "by default; pass device='cpu' to run it on the CPU explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: expected 'cuda' or 'cpu'")
    return dev


def get_sm_capability(device: DeviceLike) -> Optional[Tuple[int, int]]:
    """(major, minor) compute capability of a CUDA device; None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_capability(dev)


def _card_family(device: DeviceLike) -> str:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no published peak for device {dev!s}: peaks are for CUDA cards")
    name = torch.cuda.get_device_name(dev).lower()
    for fam in _PEAK_FLOPS_BF16:
        if fam in name:
            return fam
    raise ValueError(f"no published peak for card {name!r}")


def get_device_peak_flops(device: DeviceLike) -> float:
    """Dense bf16 tensor-core peak FLOP/s of the card (MFU denominator)."""
    return _PEAK_FLOPS_BF16[_card_family(device)]


def get_device_peak_bandwidth(device: DeviceLike) -> float:
    """Peak device-memory bandwidth of the card in bytes/s."""
    return _PEAK_BANDWIDTH[_card_family(device)]


def synchronize(device: DeviceLike) -> None:
    """Block until all queued work on ``device`` is done (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
