"""Model configuration (port of ``veomni_tpu/models/config.py``).

The same dataclass fields as the reference, so a configuration carries over
field for field, with torch dtypes in place of jnp ones. The dense path of
``models/transformer.py`` implements the llama/qwen3 dialect (qk-norm, GQA,
tied or untied head); it raises ``NotImplementedError`` for every field
whose feature is not ported yet instead of ignoring it. The HF config
round-trip (``from_hf_config``/``to_hf_config``) belongs with ``hf_io`` in a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch


@dataclass
class TransformerConfig:
    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 0  # 0 -> hidden // heads
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    o_bias: bool = False
    partial_rotary_factor: float = 1.0
    mlp_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    layer_types: Optional[List[str]] = None
    rope_local_base_freq: float = 0.0
    hidden_act: str = "silu"
    norm_zero_centered: bool = False
    sandwich_norms: bool = False
    embed_scale: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0
    attention_sinks: bool = False
    router_bias: bool = False
    rope_interleave: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    index_n_heads: int = 0
    index_head_dim: int = 0
    index_topk: int = 0
    indexer_types: Any = ()
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    router_aux_loss_coef: float = 0.001
    scoring_func: str = "softmax"
    routed_scaling_factor: float = 1.0
    n_group: int = 0
    topk_group: int = 0
    n_shared_experts: int = 0
    shared_expert_intermediate_size: int = 0
    shared_expert_gated: bool = False
    first_k_dense_replace: int = 0
    linear_num_value_heads: int = 0
    linear_num_key_heads: int = 0
    linear_key_head_dim: int = 0
    linear_value_head_dim: int = 0
    linear_conv_kernel_dim: int = 4
    full_attention_interval: int = 4
    attn_output_gate: bool = False
    moe_capacity_factor: float = 0.0
    expert_layout: str = ""
    # numerics
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master param dtype
    remat: bool = True                # torch.utils.checkpoint each decoder layer
    # "nothing" (full recompute) | "ctx" (keep the attention context, see
    # models/transformer.py); the reference's "dots"/"offload" variants raise
    remat_policy: str = "nothing"
    chunk_mbs: int = 0
    ulysses_async_chunks: int = 0
    initializer_range: float = 0.02

    def __post_init__(self):
        if not self.head_dim:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if isinstance(self.dtype, str):
            self.dtype = getattr(torch, self.dtype)
        if isinstance(self.param_dtype, str):
            self.param_dtype = getattr(torch, self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def use_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def use_dsa(self) -> bool:
        return self.index_topk > 0

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim
