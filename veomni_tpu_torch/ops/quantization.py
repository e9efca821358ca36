"""Serving storage of the KV block pool and the decode-path matmul.

Port of the dense tier of ``veomni_tpu/ops/quantization.py``:
``make_kv_pool`` (``:158``) with ``kv_quant="none"``, ``kv_pool_nbytes``
(``:183``), ``kv_block_nbytes`` (``:189``), the ``decode_matmul``/``xla``
impl (``:283``) and ``decode_dot`` (``:300``). The int8/fp8 KV tier and the
int8 decode weights (``QuantizedKV``, ``QuantizedWeight``,
``quantize_decode_params``, the ``xla_q8`` impls) are not ported yet: asking
for them raises ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

#: the ROADMAP item the quantized serving tiers wait on
QUANT_ITEM = ("the quantized serving tier (ROADMAP.md, slice D: int8/fp8 KV blocks, "
              "int8 decode weights, serving/quality.py)")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {QUANT_ITEM}")


def make_kv_pool(shape, kv_quant: str, dtype, device=None) -> torch.Tensor:
    """Allocate one KV block pool ``[L, NB, BS, hkv, d]`` of zeros on
    ``device``. Only the dense ``"none"`` mode is ported."""
    if kv_quant == "none":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kv_quant in ("int8", "fp8"):
        raise _not_ported(f"kv_quant={kv_quant!r}")
    raise ValueError(f"unknown kv_quant {kv_quant!r}; expected 'none', 'int8' or 'fp8'")


def kv_pool_nbytes(pool) -> float:
    """Device bytes of one pool."""
    return float(pool.numel() * pool.element_size())


def kv_block_nbytes(num_layers: int, block_size: int, num_kv_heads: int,
                    head_dim: int, *, kv_quant: str = "none",
                    dtype_bytes: int = 4) -> int:
    """Bytes ONE pool block (k + v, all layers) occupies."""
    if kv_quant == "int8":
        raise _not_ported("kv_quant='int8'")
    if kv_quant != "none":
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return 2 * num_layers * block_size * num_kv_heads * head_dim * dtype_bytes


def quantize_decode_params(params):
    """int8 decode weights (``weight_quant="int8"``): not ported yet."""
    raise _not_ported("weight_quant='int8'")


@KERNEL_REGISTRY.register("decode_matmul", "xla")
def _decode_matmul_xla(x, w):
    return x @ w


def decode_dot(x, w):
    """Registry-dispatched decode-path matmul (dense weights only)."""
    return resolve_op("decode_matmul", x.device)(x, w)
