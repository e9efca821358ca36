"""Serving storage: the KV block pool and the decode-path matmul, dense or
int8.

Port of ``veomni_tpu/ops/quantization.py``: ``quantize_rows`` and
``dequantize_rows`` (``:46-64``), ``QuantizedKV`` (``:106``),
``make_kv_pool`` (``:158``), ``kv_pool_nbytes`` (``:183``),
``kv_block_nbytes`` (``:189``), ``QuantizedWeight`` (``:210``),
``quantize_weight`` (``:243``), ``DECODE_QUANT_KEYS`` and
``quantize_decode_params`` (``:257-280``), the ``decode_matmul`` impls
``xla`` and ``xla_q8`` (``:283-297``) and ``decode_dot`` (``:300``).

Two tiers, each a change of storage and not of math:

* **int8 KV blocks.** A ``QuantizedKV`` pool is an int8 payload
  ``[L, NB, BS, hkv, d]`` with one f32 absmax scale per (layer, block, row,
  kv-head), ``[L, NB, BS, hkv]``: every decode tick appends a row, so a
  per-row scale never rescales the rows already written. The reference
  writes its pools functionally (``.at[idx].set``); the port's pools are
  written in place (``models/decode.py``), so the pool takes the writes as
  ``pool[idx] = value``: a float value is quantized over its last axis on
  the way in, a ``QuantizedKV`` value (copy-on-write) is copied bit-exactly.
  ``pool[idx]`` indexes payload and scale alike (views for basic indexing).
* **int8 decode weights.** A ``QuantizedWeight`` holds one projection
  ``[in, out]`` of the engine's compute dict as int8 with one f32 scale per
  output channel, ``[1, out]`` (the reference stacks layers on a leading
  axis, ``[L, in, out]`` and ``[L, 1, out]``; the port's compute dict holds
  one dict a layer, so the per-layer, per-channel scales are the same
  numbers). ``xla_q8`` contracts against the int8 payload in f32 and folds
  the scale into the product.

Zero-safe as the reference: an all-zero row gets scale 0 and payload 0, so
the freshly allocated pool dequantizes to exact zeros. ``torch.round``
rounds half to even like ``jnp.round``, so on the same f32 inputs payload
and scale are the reference's bit for bit.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY

#: int8 symmetric range: +-127 (-128 unused, so negation never overflows)
_Q8_MAX = 127.0


def quantize_rows(x, *, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``axis`` -> (payload int8,
    scale f32 shaped like ``x`` without ``axis``). A zero row gets scale 0
    (divided by 1, so its payload is exact zeros)."""
    xf = x.float()
    scale = xf.abs().amax(dim=axis) / _Q8_MAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / safe.unsqueeze(axis))
    return torch.clamp(q, -_Q8_MAX, _Q8_MAX).to(torch.int8), scale


def dequantize_rows(payload, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows` (scale broadcast over the last dim)."""
    return (payload.float() * scale[..., None]).to(dtype)


class QuantizedKV:
    """int8 KV block pool + per-(..., row, head) f32 scale sidecar, written
    in place. ``shape`` is the payload's (the logical pool shape)."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data    # int8 [..., d]
        self.scale = scale  # f32 [...] == data.shape[:-1]

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def nbytes(self) -> int:
        """Device bytes: int8 payload + f32 scale sidecar."""
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, idx) -> "QuantizedKV":
        return QuantizedKV(self.data[idx], self.scale[idx])

    def __setitem__(self, idx, value) -> None:
        """Write rows at ``idx``: a ``QuantizedKV`` value is copied payload
        and scale bit-exactly (copy-on-write), a float value is quantized
        over its last (head_dim) axis first (quantize on write)."""
        if isinstance(value, QuantizedKV):
            q, s = value.data, value.scale
        else:
            q, s = quantize_rows(value)
        self.data[idx] = q
        self.scale[idx] = s

    def dequantize(self, dtype=torch.float32):
        return dequantize_rows(self.data, self.scale, dtype)


def make_kv_pool(shape, kv_quant: str, dtype, device=None):
    """Allocate one KV block pool ``[L, NB, BS, hkv, d]`` of zeros on
    ``device``: dense in ``dtype`` (``"none"``) or a ``QuantizedKV``
    (``"int8"``). ``"fp8"`` raises as the reference's does."""
    if kv_quant == "none":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kv_quant == "int8":
        return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(tuple(shape[:-1]), dtype=torch.float32, device=device))
    if kv_quant == "fp8":
        raise NotImplementedError(
            "kv_quant='fp8' is scaffolded behind the QuantizedKV interface "
            "(fp8 payload + f32 scale sidecar) but only 'int8' ships; use "
            "kv_quant='int8' or 'none'"
        )
    raise ValueError(f"unknown kv_quant {kv_quant!r}; expected 'none', 'int8' or 'fp8'")


def kv_pool_nbytes(pool) -> float:
    """Device bytes of one pool (a ``QuantizedKV`` counts its sidecar)."""
    if isinstance(pool, QuantizedKV):
        return float(pool.nbytes)
    return float(pool.numel() * pool.element_size())


def kv_block_nbytes(num_layers: int, block_size: int, num_kv_heads: int,
                    head_dim: int, *, kv_quant: str = "none",
                    dtype_bytes: int = 4) -> int:
    """Bytes ONE pool block (k + v, all layers) occupies in the given
    storage mode."""
    rows = num_layers * block_size * num_kv_heads
    if kv_quant == "int8":
        per_pool = rows * (head_dim + 4)  # int8 payload + f32 scale a row
    elif kv_quant == "none":
        per_pool = rows * head_dim * dtype_bytes
    else:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return 2 * per_pool


class QuantizedWeight:
    """int8 projection weight ``data [..., in, out]`` + per-output-channel
    f32 scale ``[..., 1, out]``."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __getitem__(self, idx) -> "QuantizedWeight":
        return QuantizedWeight(self.data[idx], self.scale[idx])


def quantize_weight(w) -> QuantizedWeight:
    """Symmetric per-output-channel int8 quantization of a ``[..., in,
    out]`` projection weight (absmax over the input dim)."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / _Q8_MAX  # [..., 1, out]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wf / safe), -_Q8_MAX, _Q8_MAX).to(torch.int8)
    return QuantizedWeight(q, scale)


#: decode-path projection weights eligible for int8 storage: the 2-D
#: matmuls of the dense attention/MLP blocks. Embeddings, norms, biases,
#: sinks, the lm head, routers and the MoE experts (the ``experts`` and
#: ``shared_experts`` namespaces, grouped-GEMM consumed) stay full width.
DECODE_QUANT_KEYS = frozenset({
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
})


def quantize_decode_params(params):
    """The engine's parameter set (``models/decode.py::_compute_cast``:
    ``params["layers"][i]`` one dict a layer) with each layer's direct 2-D
    ``DECODE_QUANT_KEYS`` entries as ``QuantizedWeight``. The experts'
    namespaces and every other tensor pass through untouched."""
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        new = dict(lp)
        for name, w in lp.items():
            if (name in DECODE_QUANT_KEYS and isinstance(w, torch.Tensor) and w.ndim == 2):
                new[name] = quantize_weight(w)
        layers.append(new)
    out["layers"] = layers
    return out


def param_leaves(tree, prefix=""):
    """[(path, leaf)] of a parameter set (dicts, lists, namespaces), in
    order; a ``QuantizedWeight`` is two leaves, its payload and its scale."""
    if isinstance(tree, QuantizedWeight):
        return [(f"{prefix}.data", tree.data), (f"{prefix}.scale", tree.scale)]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif isinstance(tree, SimpleNamespace):
        items = vars(tree).items()
    else:
        raise TypeError(f"unexpected parameter-set node {type(tree).__name__} at {prefix}")
    return [leaf for k, v in items for leaf in param_leaves(v, f"{prefix}/{k}")]


@KERNEL_REGISTRY.register("decode_matmul", "xla")
def _decode_matmul_xla(x, w):
    return x @ w


@KERNEL_REGISTRY.register("decode_matmul", "xla_q8")
def _decode_matmul_q8(x, w: QuantizedWeight):
    """The int8-weight matmul: contract against the int8 payload in f32,
    then fold the per-output-channel scale into the product (exact: the
    scale is constant along the contraction)."""
    acc = x.float() @ w.data.float()
    return (acc * w.scale.reshape(w.scale.shape[:-2] + (-1,))).to(x.dtype)


def decode_dot(x, w):
    """The decode-path matmul: an ops-config pin wins; otherwise the
    storage picks the impl, ``xla_q8`` for a ``QuantizedWeight`` and
    ``xla`` for a dense tensor (``:300-311``)."""
    pin = KERNEL_REGISTRY.pinned("decode_matmul")
    if pin is not None:
        return KERNEL_REGISTRY.impls("decode_matmul")[pin].fn(x, w)
    impl = "xla_q8" if isinstance(w, QuantizedWeight) else "xla"
    return KERNEL_REGISTRY.impls("decode_matmul")[impl].fn(x, w)
