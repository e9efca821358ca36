"""Centralized env-flag system (copy of ``veomni_tpu/utils/env.py``).

All VEOMNI_* environment flags the port reads are declared here with
defaults so they can be printed and discovered in one place. The table holds
only the flags this package reads; the JAX package's own table stays there.
"""

from __future__ import annotations

import os
from typing import Any, Dict

ENV_DEFAULTS: Dict[str, Any] = {
    # Log level for the framework logger.
    "VEOMNI_LOG_LEVEL": "INFO",
    # Force all kernel-registry ops to the eager "xla"-named plain torch impl
    # (skip the CUDA kernels). An explicit request, never a failure fallback.
    "VEOMNI_FORCE_EAGER_OPS": "0",
    # Seq length above which the plain attention switches to its blockwise
    # online-softmax form (``ops/attention.py::_attention_xla_chunked``)
    # instead of materializing the [B, H, S, S] score tensor.
    "VEOMNI_ATTN_CHUNK_THRESHOLD": "2048",
}


def get_env(name: str) -> str:
    if name not in ENV_DEFAULTS:
        raise KeyError(f"Unknown env flag {name}; declare it in ENV_DEFAULTS")
    return os.environ.get(name, str(ENV_DEFAULTS[name]))


def env_bool(name: str) -> bool:
    return get_env(name).lower() in ("1", "true", "yes", "on")

