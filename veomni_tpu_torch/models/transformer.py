"""Decoder-only transformer: the dense llama/qwen3 path and the qwen3_moe path.

Port of ``veomni_tpu/models/transformer.py``: ``init_params`` (``:183``)
with ``_moe_params`` (``:150``), ``_standard_attention`` (``:374``), the
dense and MoE branches of ``_decoder_layer`` (``:518``), the softmax branch
of ``route_tokens`` (``:240``), ``experts_apply_sorted`` (``:307``),
``_moe_mlp`` (``:333``), ``forward_hidden`` (``:605``), ``lm_head_kernel``
(``:748``), ``head_loss`` (``:783``) and ``loss_fn`` (``:805``). PyTorch
idiom: one ``DecoderLayer`` module per layer in an ``nn.ModuleList`` (the
reference stacks layers on a leading axis and scans them). Parameters keep
the reference's names and its ``[in, out]`` matrix layout, so ``x @ w`` here
is ``jnp.dot(x, w)`` there; a MoE layer holds ``router`` [H,E] and an
``experts`` submodule with ``gate_proj``/``up_proj`` [E,H,I] and
``down_proj`` [E,I,H].

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
  kernel, recomputes the forward to rebuild the LSE. A MoE layer's routing
  and grouped GEMMs sit in the post-attention block, so backward reruns
  them once (three forward grouped-GEMM launches per layer).

The MoE path is the single-device, dropless one (no expert parallelism).
Its combine is deterministic: each sorted expert output goes back to its
(token, slot) place by a permutation and the top-k slots are summed, where
the reference scatter-adds (``.at[token_idx].add``, ``:351``); the token
dispatch likewise gathers from a k-fold copy of the tokens, so neither
direction needs atomics. Features outside these paths raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch import ops
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every configured feature the port does not implement."""
    moe = cfg.is_moe
    missing = [name for name, on in (
        (f"MoE scoring_func {cfg.scoring_func!r}", moe and cfg.scoring_func != "softmax"),
        ("group-limited routing (n_group/topk_group)",
         moe and bool(cfg.n_group and cfg.topk_group and cfg.n_group > 1)),
        ("shared experts", moe and bool(cfg.n_shared_experts
                                        or cfg.shared_expert_intermediate_size)),
        ("first_k_dense_replace", moe and cfg.first_k_dense_replace > 0),
        ("router_bias", moe and cfg.router_bias),
        ("gpt_oss routing", moe and cfg.model_type == "gpt_oss"),
        ("moe_capacity_factor (expert parallelism)", moe and cfg.moe_capacity_factor > 0),
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


def route_tokens(x, router, cfg: TransformerConfig):
    """Softmax router (the qwen-moe lineage, reference ``:240-298``) ->
    (topk_idx [T,K], topk_weights [T,K] f32, aux_loss). ``x`` [T,H] and
    ``router`` [H,E] in the compute dtype; the logits are f32 products of
    them, as ``preferred_element_type=f32`` gives."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    # the first k of a stable descending sort: among equal probabilities the
    # lower expert index wins, as with the reference's lax.top_k (torch.topk
    # makes no promise about ties)
    sorted_w, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = sorted_w[..., :k], sorted_idx[..., :k]
    if cfg.norm_topk_prob:
        topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp(min=1e-9)
    if cfg.routed_scaling_factor != 1.0:
        topk_w = topk_w * cfg.routed_scaling_factor
    return topk_idx, topk_w, ops.load_balancing_loss(probs, topk_idx, e)


def expert_counts(flat_expert, num_experts: int):
    """Rows per expert, [E] int64, on the device. ``torch.bincount`` would
    read the largest index on the host first (a stream sync per layer)."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat_expert.device)
    return counts.scatter_add_(0, flat_expert, torch.ones_like(flat_expert))


def experts_apply_sorted(xs, experts: "Experts", group_sizes, cfg: TransformerConfig):
    """Grouped-GEMM expert SwiGLU MLP on expert-sorted tokens (``:307``)."""
    dt = cfg.dtype
    gate = ops.group_gemm(xs, experts.gate_proj.to(dt), group_sizes)
    up = ops.group_gemm(xs, experts.up_proj.to(dt), group_sizes)
    act = ops.swiglu(gate, up).to(xs.dtype)
    return ops.group_gemm(act, experts.down_proj.to(dt), group_sizes)


def moe_mlp(x, router, experts: "Experts", cfg: TransformerConfig):
    """Single-device MoE (``_moe_mlp``, ``:333``): route -> stable sort by
    expert -> grouped GEMM -> weighted combine. x [T,H] -> ([T,H], aux)."""
    t, h = x.shape
    k = cfg.num_experts_per_tok
    topk_idx, topk_w, aux = route_tokens(x, router, cfg)
    flat_expert = topk_idx.reshape(-1)  # [T*K], slot j of token i at i*K + j
    sort_idx = torch.argsort(flat_expert, stable=True)
    # dispatch: sorted row r is token sort_idx[r] // K, gathered from a K-fold copy
    xs = x[:, None, :].expand(t, k, h).reshape(t * k, h)[sort_idx]
    out = experts_apply_sorted(xs, experts, expert_counts(flat_expert, cfg.num_experts), cfg)
    weighted = out * topk_w.to(x.dtype).reshape(-1)[sort_idx][:, None]
    # combine: back to (token, slot) order by the inverse permutation, sum the slots
    inverse = torch.empty_like(sort_idx)
    inverse[sort_idx] = torch.arange(t * k, device=x.device)
    return weighted[inverse].view(t, k, h).sum(1), aux


class Experts(nn.Module):
    """A MoE layer's expert weights, stacked on a leading expert axis."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        e, h = cfg.num_experts, cfg.hidden_size
        im = cfg.moe_intermediate_size or cfg.intermediate_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        self.gate_proj = p(e, h, im)
        self.up_proj = p(e, h, im)
        self.down_proj = p(e, im, h)


class DecoderLayer(nn.Module):
    """One decoder layer: RMSNorm -> GQA attention with rotary and optional
    qk-norm -> residual -> RMSNorm -> SwiGLU MLP (dense, or routed experts)
    -> residual. ``forward`` returns (hidden, router aux loss), the aux loss
    0 for a dense layer."""

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
        if cfg.is_moe:
            self.router = p(h, cfg.num_experts)
            self.experts = Experts(cfg, device)
        else:
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

    def mlp_input(self, hidden, attn):
        """(residual stream after attention, its post-attention RMSNorm)."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = hidden.shape
        hidden = hidden + attn.reshape(b, s, cfg.q_dim) @ self.o_proj.to(dt)
        return hidden, ops.rms_norm(hidden, self.post_attention_layernorm.to(dt), cfg.rms_norm_eps)

    def _tail(self, hidden, attn):
        cfg, dt = self.cfg, self.cfg.dtype
        hidden, x = self.mlp_input(hidden, attn)
        if cfg.is_moe:
            b, s, h = x.shape
            out, aux = moe_mlp(x.reshape(b * s, h), self.router.to(dt), self.experts, cfg)
            return hidden + out.view(b, s, h), aux
        act = ops.swiglu(x @ self.gate_proj.to(dt), x @ self.up_proj.to(dt))
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        return hidden + act @ self.down_proj.to(dt), aux

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
    """Causal LM (dense or MoE) with the reference's parameter names and layout."""

    def __init__(self, cfg: TransformerConfig, generator: Optional[torch.Generator],
                 *, device: DeviceLike = None):
        """``generator`` None leaves the parameters uninitialized, for a
        checkpoint to fill (``models/hf_io.py::hf_to_params``)."""
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
        if generator is not None:
            init_params(self, generator)

    def embed_and_rotary(self, input_ids, position_ids):
        """(token embeddings [B,S,H], rotary cos, sin) in cfg.dtype."""
        cfg, dt = self.cfg, self.cfg.dtype
        hidden = F.embedding(input_ids, self.embed_tokens.to(dt))
        cos, sin = ops.rotary_tables(position_ids, cfg.head_dim, cfg.rope_theta,
                                     rope_scaling=cfg.rope_scaling)
        return hidden, cos.to(dt), sin.to(dt)

    def forward_hidden(self, input_ids, position_ids, segment_ids=None):
        """[B,S] ids/positions/segments -> (final hidden [B,S,H] in cfg.dtype,
        router aux loss summed over the layers)."""
        cfg, dt = self.cfg, self.cfg.dtype
        hidden, cos, sin = self.embed_and_rotary(input_ids, position_ids)
        aux_total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for layer in self.layers:
            hidden, aux = layer(hidden, cos, sin, segment_ids)
            aux_total = aux_total + aux
        return ops.rms_norm(hidden, self.norm.to(dt), cfg.rms_norm_eps), aux_total

    def lm_head_kernel(self) -> torch.Tensor:
        """[H, V] head matrix (tied: the embedding transposed)."""
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.t()
        return self.lm_head

    def head_loss(self, hidden, labels, moe_aux) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """lm-head + chunked CE in token-sum space, plus the router aux loss
        scaled by the token count so both terms normalize alike (``:783-802``).
        ``moe_dropped_frac`` is 0: the single-device MoE is dropless (the
        reference drops assignments only under expert parallelism)."""
        cfg = self.cfg
        b, s, h = hidden.shape
        kernel = self.lm_head_kernel().to(cfg.dtype)
        loss_sum, ntokens = ops.fused_linear_cross_entropy(
            hidden.reshape(b * s, h), kernel, labels.reshape(b * s)
        )
        metrics = {"loss_sum": loss_sum, "ntokens": ntokens, "moe_aux_loss": moe_aux,
                   "moe_dropped_frac": torch.zeros_like(moe_aux)}
        total = loss_sum
        if cfg.is_moe and cfg.router_aux_loss_coef:
            total = total + cfg.router_aux_loss_coef * moe_aux * ntokens
        return total, metrics

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sum-NLL (+ the scaled router aux loss) and metrics with the
        valid-token count; the caller normalizes. ``batch`` holds
        input_ids/position_ids/segment_ids/labels [B,S], labels pre-shifted
        with -100 padding (the collator contract)."""
        hidden, moe_aux = self.forward_hidden(
            batch["input_ids"], batch["position_ids"], batch.get("segment_ids")
        )
        return self.head_loss(hidden, batch["labels"], moe_aux)


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
