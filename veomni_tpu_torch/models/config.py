"""Model configuration (port of ``veomni_tpu/models/config.py``).

The same dataclass fields as the reference, so a configuration carries over
field for field, with torch dtypes in place of jnp ones. The dense path of
``models/transformer.py`` implements the llama (with rope scaling), qwen2,
qwen3, gemma3, qwen3_moe, deepseek_v2/v3 and gpt_oss dialects; it raises
``NotImplementedError`` for every field whose feature is not ported yet
instead of ignoring it. The HF config round-trip (``from_hf_config``,
``from_pretrained``, ``to_hf_config``; reference ``:185-360``) is the
reference's mapping, key for key: a dialect whose features the port does not
build (DSA) maps as there, and ``models/transformer.py::check_supported``
raises for it. gpt_oss's ``swiglu_limit`` is not read: the clamp is 7, as
in the reference (``ops/swiglu.py``).
"""

from __future__ import annotations

import json
import os
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
    # "nothing" (full recompute) | "ctx" (keep the attention context) |
    # "dots" | "ctx_offload" | "offload" (see models/transformer.py)
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

    @property
    def qk_head_dim(self) -> int:
        """MLA query/key head dim (nope + rope parts)."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def window_for_layer(self, i: int) -> int:
        """Per-layer sliding window (0 = full attention), read from
        ``layer_types`` alone as the reference does (``:162-168``): a config
        with ``sliding_window`` but no ``layer_types`` windows every layer."""
        if self.layer_types is not None:
            sliding = self.layer_types[i] == "sliding_attention"
        else:
            sliding = self.sliding_window is not None
        return int(self.sliding_window or 0) if sliding else 0

    # ------------------------------------------------------------------ HF io
    _HF_FIELDS = (
        "vocab_size hidden_size intermediate_size num_hidden_layers "
        "num_attention_heads num_key_value_heads rms_norm_eps rope_theta "
        "max_position_embeddings tie_word_embeddings sliding_window "
        "num_experts_per_tok moe_intermediate_size norm_topk_prob "
        "router_aux_loss_coef initializer_range layer_types hidden_act "
        "rope_local_base_freq q_lora_rank kv_lora_rank qk_nope_head_dim "
        "qk_rope_head_dim v_head_dim routed_scaling_factor n_group "
        "topk_group n_shared_experts first_k_dense_replace scoring_func "
        "mlp_bias attention_bias partial_rotary_factor"
    ).split()

    @classmethod
    def from_hf_config(cls, hf: Dict[str, Any], **overrides) -> "TransformerConfig":
        mt = hf.get("model_type", "llama")
        if isinstance(hf.get("text_config"), dict):
            # multimodal wrappers (gemma3, *-vl) nest the LM dialect
            hf = {**hf, **hf["text_config"]}
            mt = hf.get("model_type", mt)
        kw: Dict[str, Any] = {"model_type": mt}
        for name in cls._HF_FIELDS:
            if name in hf and hf[name] is not None:
                kw[name] = hf[name]
        if hf.get("head_dim"):
            kw["head_dim"] = hf["head_dim"]
        if hf.get("rope_scaling"):
            kw["rope_scaling"] = dict(hf["rope_scaling"])
        if hf.get("hidden_activation"):  # gemma naming
            kw["hidden_act"] = hf["hidden_activation"]
        if mt in ("qwen2",):
            kw["attention_bias"] = True
        if mt in ("qwen3", "qwen3_moe"):
            kw["qk_norm"] = True
        if "attention_bias" in hf:
            kw["attention_bias"] = hf["attention_bias"]
        # expert count: our exports use "num_experts"; HF dialects vary
        for key in ("num_experts", "n_routed_experts", "num_local_experts"):
            if hf.get(key):
                kw["num_experts"] = hf[key]
                break
        if mt in ("gemma3", "gemma3_text"):
            kw.update(
                model_type="gemma3",
                qk_norm=True,
                norm_zero_centered=True,
                sandwich_norms=True,
                embed_scale=hf["hidden_size"] ** 0.5,
                query_pre_attn_scalar=hf.get("query_pre_attn_scalar", 256),
                tie_word_embeddings=hf.get("tie_word_embeddings", True),
            )
            if hf.get("final_logit_softcapping"):
                kw["final_logit_softcap"] = hf["final_logit_softcapping"]
        if mt == "gpt_oss":
            kw.update(attention_sinks=True, attention_bias=True, o_bias=True,
                      mlp_bias=True, hidden_act="gpt_oss_glu", router_bias=True,
                      num_experts=hf.get("num_local_experts", 0))
        if mt in ("deepseek_v3", "deepseek_v2"):
            # v3 routes on sigmoid scores + correction bias (noaux-tc); v2
            # uses plain softmax scores with greedy / max-per-group topk
            kw["scoring_func"] = hf.get(
                "scoring_func", "softmax" if mt == "deepseek_v2" else "sigmoid"
            )
            kw["norm_topk_prob"] = hf.get("norm_topk_prob", True)
            # deepseek trains bias-update (noaux-tc), not an aux loss term
            kw["router_aux_loss_coef"] = hf.get("aux_loss_alpha", 0.0)
            kw["rope_interleave"] = hf.get("rope_interleave", True)
        if mt == "seed_oss":
            kw["attention_bias"] = hf.get("attention_bias", True)
            kw["o_bias"] = hf.get("attention_out_bias", False)
        if mt in ("glm4_moe", "glm_moe"):
            kw.update(
                model_type="glm4_moe",
                qk_norm=hf.get("use_qk_norm", False),
                scoring_func="sigmoid",       # Glm4MoeTopkRouter: sigmoid + bias
                router_aux_loss_coef=0.0,     # bias-update balancing, no aux term
                norm_topk_prob=hf.get("norm_topk_prob", True),
            )
        if mt == "glm_moe_dsa":
            # MLA (deepseek-v3.2 lineage) + DSA indexer + glm4_moe routing
            kw.update(
                expert_layout="fused_chunked",
                scoring_func="sigmoid",
                router_aux_loss_coef=hf.get(
                    "router_aux_loss_coef", hf.get("aux_loss_alpha", 0.0)
                ),
                norm_topk_prob=hf.get("norm_topk_prob", True),
                rope_interleave=hf.get("rope_interleave", True),
                index_n_heads=hf.get("index_n_heads", 0),
                index_head_dim=hf.get("index_head_dim", 0),
                index_topk=hf.get("index_topk", 0),
                indexer_types=tuple(hf.get("indexer_types") or ()),
            )
            mlt = hf.get("mlp_layer_types")
            if mlt and "first_k_dense_replace" not in hf:
                k_dense = 0
                while k_dense < len(mlt) and mlt[k_dense] == "dense":
                    k_dense += 1
                if any(t == "dense" for t in mlt[k_dense:]):
                    raise ValueError(
                        "glm_moe_dsa mlp_layer_types with non-prefix dense "
                        "layers is unsupported (first_k_dense layout only)"
                    )
                kw["first_k_dense_replace"] = k_dense
        if mt in ("qwen3_next", "qwen3_5", "qwen3_5_moe"):
            # hybrid GatedDeltaNet (models/qwen3_next.py); layer pattern comes
            # from full_attention_interval, not HF layer_types
            kw.pop("layer_types", None)
            kw.update(
                model_type="qwen3_next",
                # Qwen3NextRMSNorm is zero-centered ((1 + w), zeros init);
                # the GATED delta-net norm is standard and handled separately
                norm_zero_centered=True,
                linear_num_value_heads=hf.get("linear_num_value_heads", 0),
                linear_num_key_heads=hf.get("linear_num_key_heads", 0),
                linear_key_head_dim=hf.get("linear_key_head_dim", 0),
                linear_value_head_dim=hf.get("linear_value_head_dim", 0),
                linear_conv_kernel_dim=hf.get("linear_conv_kernel_dim", 4),
                full_attention_interval=hf.get("full_attention_interval", 4) or 4,
                attn_output_gate=True,
                partial_rotary_factor=hf.get("partial_rotary_factor", 0.25),
                shared_expert_intermediate_size=hf.get(
                    "shared_expert_intermediate_size", 0
                ),
                shared_expert_gated=bool(
                    hf.get("shared_expert_intermediate_size", 0)
                ),
                router_aux_loss_coef=hf.get("router_aux_loss_coef", 0.0)
                if hf.get("output_router_logits") else 0.0,
            )
        if not hf.get("use_sliding_window", True) and mt.startswith("qwen"):
            kw["sliding_window"] = None
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_pretrained(cls, path: str, **overrides) -> "TransformerConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f), **overrides)

    # inverse of the expert-count probing in from_hf_config: the key HF
    # transformers expects for each MoE dialect (extra keys are tolerated by
    # HF, but the canonical one must be present for the count to round-trip)
    _HF_EXPERT_KEY = {
        "deepseek_v2": "n_routed_experts",
        "deepseek_v3": "n_routed_experts",
        "gpt_oss": "num_local_experts",
        "mixtral": "num_local_experts",
    }
    # internal dialect activation names -> HF spellings
    _HF_ACT_SPELLING = {"gpt_oss_glu": "silu"}

    def to_hf_config(self) -> Dict[str, Any]:
        hf = {"model_type": self.model_type, "head_dim": self.head_dim,
              "attention_bias": self.attention_bias}
        if self.rope_scaling:
            hf["rope_scaling"] = self.rope_scaling
        for name in self._HF_FIELDS:
            hf[name] = getattr(self, name)
        hf["hidden_act"] = self._HF_ACT_SPELLING.get(self.hidden_act, self.hidden_act)
        if self.is_moe:
            hf[self._HF_EXPERT_KEY.get(self.model_type, "num_experts")] = self.num_experts
        if self.model_type in ("gemma3", "gemma3_text"):
            hf["hidden_activation"] = hf.pop("hidden_act")
            hf["query_pre_attn_scalar"] = self.query_pre_attn_scalar
            if self.final_logit_softcap:
                hf["final_logit_softcapping"] = self.final_logit_softcap
        if self.model_type in ("deepseek_v2", "deepseek_v3"):
            hf["aux_loss_alpha"] = hf.pop("router_aux_loss_coef")
        if self.use_dsa:
            hf.update(
                index_n_heads=self.index_n_heads,
                index_head_dim=self.index_head_dim,
                index_topk=self.index_topk,
                indexer_types=list(self.indexer_types),
                rope_interleave=self.rope_interleave,
            )
        if self.model_type == "qwen3_next":
            hf.update(
                linear_num_value_heads=self.linear_num_value_heads,
                linear_num_key_heads=self.linear_num_key_heads,
                linear_key_head_dim=self.linear_key_head_dim,
                linear_value_head_dim=self.linear_value_head_dim,
                linear_conv_kernel_dim=self.linear_conv_kernel_dim,
                full_attention_interval=self.full_attention_interval,
                shared_expert_intermediate_size=self.shared_expert_intermediate_size,
                partial_rotary_factor=self.partial_rotary_factor,
            )
        return hf
