"""Decoder-only transformer, dense llama/qwen3 path.

Port of ``veomni_tpu/models/transformer.py``: ``init_params`` (``:183``),
``_standard_attention`` (``:374``), the dense branch of ``_decoder_layer``
(``:518``), ``forward_hidden`` (``:605``), ``lm_head_kernel`` (``:748``),
``head_loss`` (``:783``) and ``loss_fn`` (``:805``). PyTorch idiom: one
``DecoderLayer`` module per layer in an ``nn.ModuleList`` (the reference
stacks layers on a leading axis and scans them). Parameters keep the
reference's names and its ``[in, out]`` matrix layout, so ``x @ w`` here is
``jnp.dot(x, w)`` there.

Mixed precision as in the reference: master parameters in
``cfg.param_dtype`` (f32), cast to ``cfg.dtype`` (bf16) on every forward
(the reference casts the whole tree at step start, ``:625``).

Remat (``_remat_policy``, ``:39-70``) maps to ``torch.utils.checkpoint``:

* ``nothing``: the whole layer is checkpointed, backward reruns all of it,
  the attention forward included;
* ``ctx``: the pre-attention block (norm, q/k/v projections, qk-norm,
  rotary) and the post-attention block (o-projection, MLP) are
  checkpointed; the attention op between them keeps what its backward needs
  (for ``cuda_flash``: q, k, v, the context and its LSE), so backward
  reruns the cheap projections but never the O(S^2) attention forward.
  The reference's ``ctx`` saves only the context and, with its flash
  kernel, recomputes the forward to rebuild the LSE.

Features outside the dense path raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch import ops
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every configured feature the dense port does not implement."""
    missing = [name for name, on in (
        ("MoE (num_experts)", cfg.is_moe),
        ("MLA (kv_lora_rank)", cfg.use_mla),
        ("DSA indexer (index_topk)", cfg.use_dsa),
        ("sliding windows (sliding_window/layer_types)",
         cfg.sliding_window is not None or cfg.layer_types is not None),
        ("attention sinks", cfg.attention_sinks),
        ("rope_scaling (incl. mrope/yarn)", cfg.rope_scaling is not None),
        ("partial rotary", cfg.partial_rotary_factor != 1.0),
        ("dual rope (rope_local_base_freq)", bool(cfg.rope_local_base_freq)),
        ("attention/o/mlp biases", cfg.attention_bias or cfg.o_bias or cfg.mlp_bias),
        (f"hidden_act {cfg.hidden_act!r}", cfg.hidden_act != "silu"),
        ("gemma dialect (zero-centered/sandwich norms, embed scale, softcap, "
         "query_pre_attn_scalar)",
         cfg.norm_zero_centered or cfg.sandwich_norms or bool(cfg.embed_scale)
         or bool(cfg.final_logit_softcap) or bool(cfg.query_pre_attn_scalar)),
        ("linear attention / output gate (qwen3_next)",
         bool(cfg.linear_num_value_heads) or cfg.attn_output_gate),
        ("chunk_mbs", bool(cfg.chunk_mbs)),
        ("ulysses_async_chunks", bool(cfg.ulysses_async_chunks)),
        (f"remat_policy {cfg.remat_policy!r}",
         cfg.remat and cfg.remat_policy not in ("nothing", "ctx")),
    ) if on]
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


class DecoderLayer(nn.Module):
    """One dense decoder layer: RMSNorm -> GQA attention with rotary and
    optional qk-norm -> residual -> RMSNorm -> SwiGLU MLP -> residual."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        h, inter = cfg.hidden_size, cfg.intermediate_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        self.input_layernorm = p(h)
        self.q_proj = p(h, cfg.q_dim)
        self.k_proj = p(h, cfg.kv_dim)
        self.v_proj = p(h, cfg.kv_dim)
        self.o_proj = p(cfg.q_dim, h)
        if cfg.qk_norm:
            self.q_norm = p(cfg.head_dim)
            self.k_norm = p(cfg.head_dim)
        self.post_attention_layernorm = p(h)
        self.gate_proj = p(h, inter)
        self.up_proj = p(h, inter)
        self.down_proj = p(inter, h)

    def _qkv(self, hidden, cos, sin):
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = hidden.shape
        x = ops.rms_norm(hidden, self.input_layernorm.to(dt), cfg.rms_norm_eps)
        q = (x @ self.q_proj.to(dt)).view(b, s, cfg.num_attention_heads, cfg.head_dim)
        k = (x @ self.k_proj.to(dt)).view(b, s, cfg.num_key_value_heads, cfg.head_dim)
        v = (x @ self.v_proj.to(dt)).view(b, s, cfg.num_key_value_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = ops.rms_norm(q, self.q_norm.to(dt), cfg.rms_norm_eps)
            k = ops.rms_norm(k, self.k_norm.to(dt), cfg.rms_norm_eps)
        q, k = ops.apply_rotary(q, k, cos, sin)
        return q, k, v

    def _attend(self, q, k, v, segment_ids):
        return ops.attention(q, k, v, segment_ids=segment_ids, causal=True,
                             softmax_scale=self.cfg.head_dim ** -0.5)

    def _tail(self, hidden, attn):
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = hidden.shape
        hidden = hidden + attn.reshape(b, s, cfg.q_dim) @ self.o_proj.to(dt)
        x = ops.rms_norm(hidden, self.post_attention_layernorm.to(dt), cfg.rms_norm_eps)
        act = ops.swiglu(x @ self.gate_proj.to(dt), x @ self.up_proj.to(dt))
        return hidden + act @ self.down_proj.to(dt)

    def _full(self, hidden, cos, sin, segment_ids):
        q, k, v = self._qkv(hidden, cos, sin)
        return self._tail(hidden, self._attend(q, k, v, segment_ids))

    def forward(self, hidden, cos, sin, segment_ids=None):
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._full(hidden, cos, sin, segment_ids)
        if cfg.remat_policy == "ctx":
            q, k, v = checkpoint(self._qkv, hidden, cos, sin, use_reentrant=False)
            attn = self._attend(q, k, v, segment_ids)
            return checkpoint(self._tail, hidden, attn, use_reentrant=False)
        return checkpoint(self._full, hidden, cos, sin, segment_ids, use_reentrant=False)


class Transformer(nn.Module):
    """Dense causal LM with the reference's parameter names and layout."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 *, device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=dev))

        self.embed_tokens = p(cfg.vocab_size, h)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev) for _ in range(cfg.num_hidden_layers))
        self.norm = p(h)
        if not cfg.tie_word_embeddings:
            self.lm_head = p(h, cfg.vocab_size)
        init_params(self, generator)

    def forward_hidden(self, input_ids, position_ids, segment_ids=None):
        """[B,S] ids/positions/segments -> final hidden [B,S,H] in cfg.dtype."""
        cfg, dt = self.cfg, self.cfg.dtype
        hidden = F.embedding(input_ids, self.embed_tokens.to(dt))
        cos, sin = ops.rotary_tables(position_ids, cfg.head_dim, cfg.rope_theta,
                                     rope_scaling=cfg.rope_scaling)
        cos, sin = cos.to(dt), sin.to(dt)
        for layer in self.layers:
            hidden = layer(hidden, cos, sin, segment_ids)
        return ops.rms_norm(hidden, self.norm.to(dt), cfg.rms_norm_eps)

    def lm_head_kernel(self) -> torch.Tensor:
        """[H, V] head matrix (tied: the embedding transposed)."""
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.t()
        return self.lm_head

    def head_loss(self, hidden, labels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """lm-head + chunked CE in token-sum space."""
        b, s, h = hidden.shape
        kernel = self.lm_head_kernel().to(self.cfg.dtype)
        loss_sum, ntokens = ops.fused_linear_cross_entropy(
            hidden.reshape(b * s, h), kernel, labels.reshape(b * s)
        )
        return loss_sum, {"loss_sum": loss_sum, "ntokens": ntokens}

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sum-NLL + valid-token count; the caller normalizes. ``batch`` holds
        input_ids/position_ids/segment_ids/labels [B,S], labels pre-shifted
        with -100 padding (the collator contract)."""
        hidden = self.forward_hidden(
            batch["input_ids"], batch["position_ids"], batch.get("segment_ids")
        )
        return self.head_loss(hidden, batch["labels"])


@torch.no_grad()
def init_params(model: Transformer, generator: torch.Generator) -> None:
    """Random init with the reference's scheme (``init_params``, ``:183``):
    norms at 1, matrices ~ N(0, initializer_range). The numbers differ from
    JAX's for the same seed; parity tests carry weights across instead
    (``models/jax_weights.py``)."""
    std = model.cfg.initializer_range
    for name, param in model.named_parameters():
        if name.endswith("norm"):
            param.fill_(1.0)
        else:
            noise = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                                device=param.device)
            param.copy_(noise * std)
