"""Ops layer: kernel registry + dispatch + plain torch / CUDA implementations.

Port of ``veomni_tpu/ops/__init__.py`` for the dense and MoE text train
steps and the serving engine's decode path. The plain impls keep the
reference's ``xla`` names; the Hopper kernels register under their own names
(``attention``/``cuda_flash``, ``group_gemm``/``cuda_gmm``).
"""

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, KernelSpec, resolve_op
from veomni_tpu_torch.ops import rms_norm as _rms_norm
from veomni_tpu_torch.ops import rotary as _rotary
from veomni_tpu_torch.ops import swiglu as _swiglu
from veomni_tpu_torch.ops import attention as _attention
from veomni_tpu_torch.ops import cross_entropy as _cross_entropy
from veomni_tpu_torch.ops import load_balancing as _load_balancing
from veomni_tpu_torch.ops import group_gemm as _group_gemm
from veomni_tpu_torch.ops import paged_attention as _paged_attention
from veomni_tpu_torch.ops import quantization as _quantization
from veomni_tpu_torch.ops.cuda import flash_attention as _flash  # noqa: F401  (registers cuda_flash)
from veomni_tpu_torch.ops.cuda import grouped_gemm as _gmm  # noqa: F401  (registers cuda_gmm)

rms_norm = _rms_norm.rms_norm
apply_rotary = _rotary.apply_rotary
rotary_tables = _rotary.rotary_tables
yarn_attention_factor = _rotary.yarn_attention_factor
swiglu = _swiglu.swiglu
gated_act = _swiglu.gated_act
GATED_ACTS = _swiglu.GATED_ACTS
attention = _attention.attention
fused_linear_cross_entropy = _cross_entropy.fused_linear_cross_entropy
fused_linear_cross_entropy_per_token = _cross_entropy.fused_linear_cross_entropy_per_token
fused_linear_topk_distill = _cross_entropy.fused_linear_topk_distill
load_balancing_loss = _load_balancing.load_balancing_loss
group_gemm = _group_gemm.group_gemm
cache_attend = _paged_attention.cache_attend
gather_block_kv = _paged_attention.gather_block_kv
gather_block_kv_q8 = _paged_attention.gather_block_kv_q8
paged_attend = _paged_attention.paged_attend
paged_prefill_attend = _paged_attention.paged_prefill_attend
quantize_decode_params = _quantization.quantize_decode_params
make_kv_pool = _quantization.make_kv_pool
kv_block_nbytes = _quantization.kv_block_nbytes
decode_dot = _quantization.decode_dot
QuantizedKV = _quantization.QuantizedKV
QuantizedWeight = _quantization.QuantizedWeight
quantize_rows = _quantization.quantize_rows
dequantize_rows = _quantization.dequantize_rows
quantize_weight = _quantization.quantize_weight
DECODE_QUANT_KEYS = _quantization.DECODE_QUANT_KEYS

__all__ = [
    "KERNEL_REGISTRY",
    "KernelSpec",
    "resolve_op",
    "rms_norm",
    "apply_rotary",
    "rotary_tables",
    "yarn_attention_factor",
    "swiglu",
    "gated_act",
    "GATED_ACTS",
    "attention",
    "fused_linear_cross_entropy",
    "fused_linear_cross_entropy_per_token",
    "fused_linear_topk_distill",
    "load_balancing_loss",
    "group_gemm",
    "cache_attend",
    "gather_block_kv",
    "gather_block_kv_q8",
    "paged_attend",
    "paged_prefill_attend",
    "quantize_decode_params",
    "make_kv_pool",
    "kv_block_nbytes",
    "decode_dot",
    "QuantizedKV",
    "QuantizedWeight",
    "quantize_rows",
    "dequantize_rows",
    "quantize_weight",
    "DECODE_QUANT_KEYS",
]
