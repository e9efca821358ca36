"""Promised FLOPs per token for MFU (the dense, MoE and MLA parts of
``veomni_tpu/utils/count_flops.py::FlopsCounter``, same formula): the q/k/v/o
projections (MLA: the q and kv low-rank projections, ``:62-80``), causal
attention scores and context (half the window), the SwiGLU MLP (for MoE:
the top-k routed experts, the shared experts and the router, ``:89-101``)
and the LM head, forward; backward counts twice the forward. ``vit_flops_fwd``
(``:179``) is the qwen-vl towers' term. As there,
every layer of a MoE config counts as a MoE layer, ``first_k_dense_replace``
leading dense layers included."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class FlopsCounter:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    # MoE (0 => dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    shared_expert_intermediate_size: int = 0
    # MLA (deepseek); kv_lora_rank > 0 switches the attention terms
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    def _attn_proj_flops(self) -> float:
        """q/k/v/o projections per token (``:62-80``)."""
        h = self.hidden_size
        if self.kv_lora_rank:
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            nh, vd = self.num_heads, self.v_head_dim
            q = (2 * h * self.q_lora_rank + 2 * self.q_lora_rank * nh * qk if self.q_lora_rank
                 else 2 * h * nh * qk)
            kv_a = 2 * h * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv_b = 2 * self.kv_lora_rank * nh * (self.qk_nope_head_dim + vd)
            return q + kv_a + kv_b + 2 * nh * vd * h
        q_dim = self.num_heads * self.head_dim
        kv_dim = self.num_kv_heads * self.head_dim
        return 2 * h * (q_dim + 2 * kv_dim + q_dim)

    def _attn_score_flops(self, seq_len: int) -> float:
        """Scores + context per token (``:82-87``); causal halves the window."""
        if self.kv_lora_rank:
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            return self.num_heads * 2 * (qk + self.v_head_dim) * (seq_len / 2)
        return 2 * 2 * self.num_heads * self.head_dim * (seq_len / 2)

    def _mlp_flops(self) -> float:
        """Reference ``:89-101``."""
        h = self.hidden_size
        if self.num_experts and self.num_experts_per_tok:
            inter = self.moe_intermediate_size or self.intermediate_size
            mlp = 2 * 3 * h * inter * self.num_experts_per_tok
            shared = self.shared_expert_intermediate_size or inter * self.num_shared_experts
            if shared:
                mlp += 2 * 3 * h * shared + (2 * h if self.shared_expert_intermediate_size else 0)
            return mlp + 2 * h * self.num_experts  # + the router
        return 2 * 3 * h * self.intermediate_size

    def flops_per_token_fwd(self, seq_len: int) -> float:
        layer = self._attn_proj_flops() + self._attn_score_flops(seq_len) + self._mlp_flops()
        return self.num_layers * layer + 2 * self.hidden_size * self.vocab_size

    def batch_flops(self, total_tokens: int, seq_len: int) -> float:
        return 3.0 * total_tokens * self.flops_per_token_fwd(seq_len)

    @classmethod
    def from_config(cls, cfg) -> "FlopsCounter":
        """A composite config (a VLM or an omni thinker) counts its text
        model (``cfg.text``), as the reference does (``:142``); the towers'
        FLOPs are fed separately (``vit_flops_fwd``)."""
        if hasattr(cfg, "text") and hasattr(cfg.text, "hidden_size"):
            cfg = cfg.text
        return cls(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim,
            vocab_size=cfg.vocab_size,
            num_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok,
            moe_intermediate_size=cfg.moe_intermediate_size,
            num_shared_experts=cfg.n_shared_experts,
            shared_expert_intermediate_size=cfg.shared_expert_intermediate_size,
            q_lora_rank=cfg.q_lora_rank,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim,
        )


def vit_flops_fwd(vision_cfg, n_patches: int, window_seq: Optional[int] = None) -> float:
    """Forward FLOPs of a ViT tower on ``n_patches`` patches (the
    reference's qwen-vl term, ``:179-201``, as it counts): per patch and
    layer the q/k/v/o projections, scores and context over ``window_seq``
    patches (default: all ``n_patches``, an upper bound when several images
    are packed) and a gated MLP of ``intermediate_size``, at width
    ``hidden_size`` (which in Qwen2-VL's vision config is the LM width), plus
    the patch embed and the merger."""
    g = lambda n, d=0: getattr(vision_cfg, n, d)  # noqa: E731
    h = g("hidden_size")
    inter = g("intermediate_size") or 4 * h
    layers = g("depth", 0) or g("num_hidden_layers", 0)
    span = window_seq if window_seq else n_patches
    per_patch = 2 * h * 4 * h                 # qkv + o projections
    per_patch += 2 * 2 * h * span             # scores + context
    per_patch += 2 * 3 * h * inter if g("gated_mlp", True) else 2 * 2 * h * inter
    body = layers * per_patch * n_patches
    in_dim = g("in_channels", 3) * g("temporal_patch_size", 1) * g("patch_size", 14) ** 2
    embed = 2 * in_dim * h * n_patches
    merge = g("merge_unit", 4)
    merger = 2 * (h * merge) * g("out_hidden_size", h) * (n_patches // max(merge, 1))
    return body + embed + merger
