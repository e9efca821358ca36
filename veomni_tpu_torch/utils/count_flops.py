"""Promised FLOPs per token for MFU (the dense and MoE parts of
``veomni_tpu/utils/count_flops.py::FlopsCounter``, same formula): q/k/v/o
projections, causal attention scores and context (half the window), the
SwiGLU MLP (for MoE: the top-k routed experts and the router; the port
has no shared experts yet) and the LM head, forward; backward counts twice the forward."""

from __future__ import annotations

from dataclasses import dataclass


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

    def _mlp_flops(self) -> float:
        """Reference ``:89-101``, without its shared-expert term."""
        h = self.hidden_size
        if self.num_experts and self.num_experts_per_tok:
            inter = self.moe_intermediate_size or self.intermediate_size
            return 2 * 3 * h * inter * self.num_experts_per_tok + 2 * h * self.num_experts
        return 2 * 3 * h * self.intermediate_size

    def flops_per_token_fwd(self, seq_len: int) -> float:
        h = self.hidden_size
        q_dim = self.num_heads * self.head_dim
        kv_dim = self.num_kv_heads * self.head_dim
        proj = 2 * h * (q_dim + 2 * kv_dim + q_dim)
        scores = 2 * 2 * self.num_heads * self.head_dim * (seq_len / 2)
        return self.num_layers * (proj + scores + self._mlp_flops()) + 2 * h * self.vocab_size

    def batch_flops(self, total_tokens: int, seq_len: int) -> float:
        return 3.0 * total_tokens * self.flops_per_token_fwd(seq_len)

    @classmethod
    def from_config(cls, cfg) -> "FlopsCounter":
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
        )
