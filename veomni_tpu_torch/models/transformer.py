"""Decoder-only transformer: the dense llama/qwen2/qwen3/gemma3 paths, the
qwen3_moe MoE, the deepseek_v2/v3 MoE dialect and the gpt_oss dialect.

Port of ``veomni_tpu/models/transformer.py``: ``init_params`` (``:183``)
with ``_attn_params``/``_dense_mlp_params`` (``:80-147``) and
``_moe_params`` (``:150``), ``_standard_attention`` (``:374``),
``_mla_attention`` without its DSA branch (``:457``), the dense and MoE
branches of ``_decoder_layer`` (``:518``), ``route_tokens`` (``:240``),
``experts_apply_sorted`` (``:307``) with ``_expert_bias`` (``:301``),
``_shared_experts_out`` (``:319``), ``_moe_mlp`` (``:333``),
``forward_hidden`` (``:605``), ``lm_head_kernel`` (``:748``),
``forward_logits`` (``:754``), ``sequence_logprob_sums`` (``:763``),
``head_loss`` (``:783``) and ``loss_fn`` (``:805``), and the
``ROUTER_CAPTURE`` hook of ``_moe_mlp`` (``:328-340``) that
``utils/moe_monitor.py`` sets. The dense dialects: HF rope scaling (linear, llama3, yarn),
partial rotary, q/k/v/o and MLP biases (qwen2), and gemma3's sliding
windows on a per-layer pattern, dual rope, zero-centered and sandwich
norms, embedding scale, ``query_pre_attn_scalar``, GELU and logit softcap.
The deepseek dialect: MLA (q from ``q_proj`` or a ``q_a``/``q_b`` low-rank
pair, k and v from a ``kv_lora_rank`` latent, a rope part shared across
heads in the interleaved layout, the yarn mscale on the softmax scale),
sigmoid noaux-tc routing with ``e_score_correction_bias``, group-limited
routing in both the sigmoid (top-2 sum per group) and the softmax (max per
group) forms, shared experts (optionally sigmoid-gated) added after the
routed combine, and ``first_k_dense_replace`` leading dense layers.
The gpt_oss dialect: per-head attention sinks (``:126-127``), a router
bias (``:249-250``), top-k on the router logits then a softmax over the k
(``:274-276``), per-expert gate/up/down biases added by gather outside the
grouped GEMMs (``:301-316``), the clamped GLU (``:226-234``) and o_proj
and q/k/v biases. A windowed layer, an MLA layer (v head dim 128 against
q/k's 192) and a layer with sinks reach the plain attention through the
reference's own feature dispatch (``ops/cuda/flash_attention.py``); a
full-attention layer without sinks keeps the flash kernels. PyTorch idiom:
one ``DecoderLayer`` module per layer in an ``nn.ModuleList`` (the
reference stacks layers on a leading axis and scans
them, with the leading dense layers in a second stacked subtree,
``dense_layers``; here they are simply the first layers of the list).
Parameters keep the reference's names and its ``[in, out]`` matrix layout,
so ``x @ w`` here is ``jnp.dot(x, w)`` there; a MoE layer holds ``router``
[H,E], an ``experts`` submodule with ``gate_proj``/``up_proj`` [E,H,I] and
``down_proj`` [E,I,H] (gpt_oss: and ``gate_bias``/``up_bias`` [E,I],
``down_bias`` [E,H]) and, where the dialect has them, a
``shared_experts`` submodule, ``e_score_correction_bias`` [E] and
``router_bias`` [E].

The MLA rope rotates each adjacent channel pair by that pair's frequency
(``rotary_tables(..., interleaved=True)``), as HF's deepseek does; the
reference pairs the interleaved rotation with the concatenated-halves
tables, which turns a pair's two channels by two different angles (no
rotation, and q.k no longer depends on the position difference alone;
ROADMAP.md queue 3, diverges on purpose).

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
  them once (three forward grouped-GEMM launches per layer);
* ``dots`` (``dots_with_no_batch_dims_saveable``): ``ctx``'s split, each
  checkpointed block under a selective-checkpoint policy that must-save the
  output of every ``aten.mm``/``aten.addmm`` (the no-batch-dim products) and
  recomputes the rest. The hand kernels launch through ctypes, below the
  dispatcher, so no policy can cache them: a K4 inside a MoE tail is rerun,
  as the reference's Pallas call is rerun under ``dots``;
* ``ctx_offload`` and ``offload``: the saves of ``ctx`` and of ``dots``
  parked in pinned host memory. The attention op's saves go through
  ``save_on_cpu``; a selective-checkpoint cache keeps its tensors in its own
  storage, out of reach of saved-tensor hooks, so ``offload`` caches the
  products with a dispatch-mode pair of its own (``_host_matmul_contexts``)
  that copies each to the host in the forward and back in the recompute;
* an unknown name falls to ``nothing``, as in the reference (``:70``).

``chunk_mbs`` (``:583-596``) splits a dense MLP over sequence chunks of
``c`` (rounded down to the largest divisor of the length, at least 2; no
chunking when there is none), each chunk checkpointed so the backward
recompute stays chunked; MoE layers are not chunked. No policy changes a
value (each runs the forward's kernels in the same order, and a saved
product is the product a recompute gives); ``chunk_mbs`` changes the MLP's
GEMM shapes, so its sums round in another order.

The MoE path is the single-device, dropless one; under an ambient mesh
with ep > 1 the routed experts are ``parallel/moe.py``'s expert-parallel
ones, and the router's load-balancing loss is over the mesh's tokens
whenever the mesh splits them. Its combine is deterministic: each sorted expert output goes back to its
(token, slot) place by a permutation and the top-k slots are summed, where
the reference scatter-adds (``.at[token_idx].add``, ``:351``); the token
dispatch likewise gathers from a k-fold copy of the tokens, so neither
direction needs atomics. The correction bias reaches the loss only through
the expert choice, so it has no gradient; the optimizer gives it a zero one
(``optim/optimizer.py``), as ``jax.grad`` does, so weight decay still
shrinks it. Features outside these paths raise ``NotImplementedError``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from veomni_tpu_torch import ops
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every configured feature the port does not implement, each
    naming its item in ROADMAP.md queue 1. ``moe_capacity_factor`` is read
    only under expert parallelism (``:563-568``, ``parallel/moe.py``); at
    expert-parallel size 1 the MoE is the dropless ``_moe_mlp``, as there."""
    missing = [name for name, on in (
        ("DSA indexer, index_topk (slice F)", cfg.use_dsa),
        (f"hidden_act {cfg.hidden_act!r} (no gated activation of the reference; it takes "
         f"{', '.join(ops.GATED_ACTS)})", cfg.hidden_act not in ops.GATED_ACTS),
        ("linear attention / output gate, qwen3_next (slice F)",
         bool(cfg.linear_num_value_heads) or cfg.attn_output_gate),
    ) if on]
    if missing:
        raise NotImplementedError("not ported yet (ROADMAP.md queue 1): " + "; ".join(missing))


#: the no-batch-dim products the ``dots`` policies keep (``x @ w`` of a
#: [B,S,H] activation reaches the dispatcher as ``aten.mm``)
_MATMUL_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
#: the policies that split the layer around the attention op
_SPLIT_POLICIES = ("ctx", "dots", "ctx_offload", "offload")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMUL_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


class _HostMatmuls(TorchDispatchMode):
    """In the forward (``saved`` empty, ``replay`` False): copy every
    product's output to pinned host memory, in order. In the recompute
    (``replay`` True): hand the saved products back, copied to the device,
    in the same order, instead of running them."""

    def __init__(self, saved, replay: bool):
        super().__init__()
        self.saved, self.replay, self.next = saved, replay, 0

    def __enter__(self):
        self.next = 0  # a second backward over a retained graph replays again
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _MATMUL_OPS:
            return func(*args, **(kwargs or {}))
        if self.replay:
            host = self.saved[self.next]
            self.next += 1
            return host.to(args[-1].device, non_blocking=True)
        out = func(*args, **(kwargs or {}))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
        self.saved.append(host.copy_(out, non_blocking=True))
        return out


def _host_matmul_contexts():
    saved = []
    return _HostMatmuls(saved, replay=False), _HostMatmuls(saved, replay=True)


def chunk_len(chunk: int, s: int) -> int:
    """The sequence chunk ``chunk_mbs`` runs a dense MLP at for length
    ``s`` (``:583-590``): ``chunk`` itself where it divides ``s``, else the
    largest divisor of ``s`` below it (at least 2); 0 for no chunking."""
    if chunk and s > chunk and s % chunk:
        chunk = next((d for d in range(chunk, 1, -1) if s % d == 0), 0)
    return chunk if chunk and 1 < chunk < s else 0


def _top_k(values, k: int):
    """(values, indices) of the first k of a stable descending sort: among
    equal values the lower index wins, as with the reference's
    ``lax.top_k`` (``torch.topk`` makes no promise about ties)."""
    sorted_v, sorted_i = torch.sort(values, dim=-1, descending=True, stable=True)
    return sorted_v[..., :k], sorted_i[..., :k]


def _group_mask(choice, cfg: TransformerConfig, group_score):
    """[T,E] bool: the experts of each token's ``topk_group`` best groups,
    a group scored by ``group_score`` over its [T, n_group, E/n_group]
    slice (``:254-264``, ``:280-291``)."""
    t, e = choice.shape
    _, top_groups = _top_k(group_score(choice.view(t, cfg.n_group, e // cfg.n_group)),
                           cfg.topk_group)
    keep = torch.zeros((t, cfg.n_group), dtype=torch.bool, device=choice.device)
    keep.scatter_(1, top_groups, True)
    return keep.repeat_interleave(e // cfg.n_group, dim=1)


def route_tokens(x, router, cfg: TransformerConfig, correction_bias=None, router_bias=None):
    """Router dialects (``:240-298``) -> (topk_idx [T,K], topk_weights
    [T,K] f32, aux_loss). ``x`` [T,H], ``router`` [H,E], the sigmoid
    dialect's ``correction_bias`` [E] and gpt_oss's ``router_bias`` [E] in
    the compute dtype; the logits are f32 products (plus the router bias in
    f32), as ``preferred_element_type=f32`` gives.

    softmax (qwen-moe, deepseek_v2): softmax -> (max-per-group greedy
    mask) -> top-k (-> renorm) (-> scaling). sigmoid (deepseek_v3
    noaux-tc): sigmoid scores + correction bias pick the experts
    (top-2-sum-per-group mask first), the weights are the raw scores
    (-> renorm) x scaling. gpt_oss: top-k of the logits, the weights a
    softmax over those k; the aux loss still takes the softmax over all E
    (``:297``)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.float() @ router.float()
    if router_bias is not None:
        logits = logits + router_bias.float()
    grouped = bool(cfg.n_group and cfg.topk_group and cfg.n_group > 1)
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores + correction_bias.float()
        if grouped:
            keep = _group_mask(choice, cfg, lambda g: _top_k(g, 2)[0].sum(-1))
            choice = choice.masked_fill(~keep, float("-inf"))
        _, topk_idx = _top_k(choice, k)
        topk_w = scores.gather(-1, topk_idx)
        if cfg.norm_topk_prob:
            topk_w = topk_w / (topk_w.sum(-1, keepdim=True) + 1e-20)
        topk_w = topk_w * cfg.routed_scaling_factor
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-20)
        return topk_idx, topk_w, _balance_loss(probs, topk_idx, e)
    probs = torch.softmax(logits, dim=-1)
    if cfg.model_type == "gpt_oss":
        topk_logits, topk_idx = _top_k(logits, k)
        return (topk_idx, torch.softmax(topk_logits, dim=-1),
                _balance_loss(probs, topk_idx, e))
    choice = probs
    if grouped:
        choice = choice.masked_fill(~_group_mask(choice, cfg, lambda g: g.amax(-1)), 0.0)
    topk_w, topk_idx = _top_k(choice, k)
    if cfg.norm_topk_prob:
        topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp(min=1e-9)
    if cfg.routed_scaling_factor != 1.0:
        topk_w = topk_w * cfg.routed_scaling_factor
    return topk_idx, topk_w, _balance_loss(probs, topk_idx, e)


def _balance_loss(probs, topk_idx, num_experts: int):
    """The router's load-balancing loss: over the mesh's every token when
    the ambient mesh splits the tokens (``parallel/moe.py``), as the
    reference computes it on its global arrays; else the rank's own."""
    from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none

    ps = get_parallel_state_or_none()
    if ps is not None and ps.group(ps.dp_sp_axes) is not None:
        from veomni_tpu_torch.parallel.moe import load_balancing_loss

        return load_balancing_loss(probs, topk_idx, num_experts, ps)
    return ops.load_balancing_loss(probs, topk_idx, num_experts)


def expert_counts(flat_expert, num_experts: int):
    """Rows per expert, [E] int64, on the device. ``torch.bincount`` would
    read the largest index on the host first (a stream sync per layer)."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat_expert.device)
    return counts.scatter_add_(0, flat_expert, torch.ones_like(flat_expert))


def _add_expert_bias(t, experts, name: str, expert_of_row, dt):
    """``t`` [M, N] plus the bias of the expert each sorted row went to,
    where the experts have such a bias (``_expert_bias``, ``:301-304``)."""
    bias = getattr(experts, name, None)
    return t if bias is None else t + bias.to(dt)[expert_of_row]


def experts_apply_sorted(xs, experts: "Experts", group_sizes, cfg: TransformerConfig,
                         expert_of_row=None):
    """Grouped-GEMM expert gated MLP on expert-sorted tokens (``:307-316``):
    the dialect's gated activation, and gpt_oss's per-expert biases added
    by gather (``expert_of_row`` [M], the expert of each sorted row) around
    the grouped GEMMs, in the compute dtype."""
    dt = cfg.dtype
    gate = ops.group_gemm(xs, experts.gate_proj.to(dt), group_sizes)
    up = ops.group_gemm(xs, experts.up_proj.to(dt), group_sizes)
    gate = _add_expert_bias(gate, experts, "gate_bias", expert_of_row, dt)
    up = _add_expert_bias(up, experts, "up_bias", expert_of_row, dt)
    act = ops.gated_act(gate, up, cfg.hidden_act).to(xs.dtype)
    out = ops.group_gemm(act, experts.down_proj.to(dt), group_sizes)
    return _add_expert_bias(out, experts, "down_bias", expert_of_row, dt)


def shared_experts_out(x, shared, cfg: TransformerConfig, gate=None):
    """The shared experts' dense gated MLP on every token (``:319-325``),
    times sigmoid(x @ ``gate``) when the dialect gates it; plain products
    in the compute dtype."""
    dt = cfg.dtype
    act = ops.gated_act(x @ shared.gate_proj.to(dt), x @ shared.up_proj.to(dt), cfg.hidden_act)
    out = act @ shared.down_proj.to(dt)
    if gate is not None:
        out = out * torch.sigmoid(x @ gate.to(dt))
    return out


# set by utils/moe_monitor.py::capture_routing to a list that moe_mlp
# appends each MoE layer's expert choices [T, K] to (``:328-340``)
ROUTER_CAPTURE: Optional[list] = None


def moe_mlp(x, router, experts: "Experts", cfg: TransformerConfig, correction_bias=None,
            shared=None, shared_gate=None, router_bias=None, stats: Optional[dict] = None):
    """Single-device MoE (``_moe_mlp``, ``:333``): route -> stable sort by
    expert -> grouped GEMM -> weighted combine (-> + the shared experts).
    x [T,H] -> ([T,H], aux). Under an ambient mesh with ep > 1 the routed
    experts are the expert-parallel ones (``parallel/moe.py``, ``:560-567``),
    ``experts`` holding the rank's E/ep; ``stats["dropped"]`` then receives
    the mesh-mean fraction of assignments the capacity dropped."""
    t, h = x.shape
    k = cfg.num_experts_per_tok
    topk_idx, topk_w, aux = route_tokens(x, router, cfg, correction_bias, router_bias)
    if ROUTER_CAPTURE is not None:
        ROUTER_CAPTURE.append(topk_idx.detach())
    from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none

    ps = get_parallel_state_or_none()
    if ps is not None and ps.ep_enabled:
        from veomni_tpu_torch.parallel.moe import ep_moe_mlp

        combined, dropped = ep_moe_mlp(x, topk_idx, topk_w, experts, cfg, ps)
        if stats is not None:
            stats["dropped"] = dropped.detach()
        if shared is not None:
            combined = combined + shared_experts_out(x, shared, cfg, shared_gate)
        return combined, aux
    flat_expert = topk_idx.reshape(-1)  # [T*K], slot j of token i at i*K + j
    sort_idx = torch.argsort(flat_expert, stable=True)
    # dispatch: sorted row r is token sort_idx[r] // K, gathered from a K-fold copy
    xs = x[:, None, :].expand(t, k, h).reshape(t * k, h)[sort_idx]
    out = experts_apply_sorted(xs, experts, expert_counts(flat_expert, cfg.num_experts), cfg,
                               flat_expert[sort_idx])
    weighted = out * topk_w.to(x.dtype).reshape(-1)[sort_idx][:, None]
    # combine: back to (token, slot) order by the inverse permutation, sum the slots
    inverse = torch.empty_like(sort_idx)
    inverse[sort_idx] = torch.arange(t * k, device=x.device)
    combined = weighted[inverse].view(t, k, h).sum(1)
    if shared is not None:
        combined = combined + shared_experts_out(x, shared, cfg, shared_gate)
    return combined, aux


class Experts(nn.Module):
    """A MoE layer's expert weights, stacked on a leading expert axis, and
    with ``mlp_bias`` (gpt_oss) their gate/up [E,I] and down [E,H] biases."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        e, h = cfg.num_experts, cfg.hidden_size
        im = cfg.moe_intermediate_size or cfg.intermediate_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        self.gate_proj = p(e, h, im)
        self.up_proj = p(e, h, im)
        self.down_proj = p(e, im, h)
        if cfg.mlp_bias:
            self.gate_bias = p(e, im)
            self.up_bias = p(e, im)
            self.down_bias = p(e, h)


class SharedExperts(nn.Module):
    """A MoE layer's shared experts: one dense gated MLP of width
    ``shared_expert_intermediate_size`` or n_shared x the expert width."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        h = cfg.hidden_size
        si = (cfg.shared_expert_intermediate_size
              or (cfg.moe_intermediate_size or cfg.intermediate_size) * cfg.n_shared_experts)

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        self.gate_proj = p(h, si)
        self.up_proj = p(h, si)
        self.down_proj = p(si, h)


class DecoderLayer(nn.Module):
    """One decoder layer: RMSNorm -> attention (GQA with rotary, optional
    qk-norm, q/k/v/o biases and this layer's sliding window; or MLA) ->
    (gemma: its post-attention norm) -> residual -> RMSNorm -> gated MLP
    (dense, or routed experts with optional shared experts) -> (gemma: its
    post-feedforward norm) -> residual. ``forward`` returns (hidden, router
    aux loss), the aux loss 0 for a dense layer. A MoE config's first
    ``first_k_dense_replace`` layers are dense (the reference's
    ``dense_layers`` segment).

    With sandwich norms (gemma3, reference ``:548-556``)
    ``post_attention_layernorm`` normalises the attention output and
    ``pre_feedforward_layernorm`` is the MLP's input norm; in llama/qwen
    ``post_attention_layernorm`` is the MLP's input norm."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.is_moe = cfg.is_moe and layer_idx >= cfg.first_k_dense_replace
        # 0 = full attention; a windowed layer of a dual-rope model (gemma3)
        # rotates with the local tables
        self.window = cfg.window_for_layer(layer_idx)
        self.local_rope = bool(cfg.rope_local_base_freq) and self.window > 0
        h, inter = cfg.hidden_size, cfg.intermediate_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))

        # {parameter name: fn(parameter) -> merged weight}, filled by
        # lora/lora.py::LoraAdapters.merged while it is held; empty otherwise
        self.merges: Dict[str, Callable] = {}
        # {parameter name: fn(shard) -> full weight}: the expert feature
        # shards' gathers (parallel/parallel_plan.py); empty at world size 1
        self.gathers: Dict[str, Callable] = {}
        # the routed layer's last capacity-drop fraction (expert parallelism)
        self.moe_stats: Dict[str, torch.Tensor] = {}
        self.input_layernorm = p(h)
        if cfg.use_mla:
            nh, dr = cfg.num_attention_heads, cfg.qk_rope_head_dim
            self.attn_dim = nh * cfg.v_head_dim
            self.scale = cfg.qk_head_dim ** -0.5 * ops.yarn_attention_factor(cfg.rope_scaling, dr)
            if cfg.q_lora_rank:
                self.q_a_proj = p(h, cfg.q_lora_rank)
                self.q_a_layernorm = p(cfg.q_lora_rank)
                self.q_b_proj = p(cfg.q_lora_rank, nh * cfg.qk_head_dim)
            else:
                self.q_proj = p(h, nh * cfg.qk_head_dim)
            self.kv_a_proj_with_mqa = p(h, cfg.kv_lora_rank + dr)
            self.kv_a_layernorm = p(cfg.kv_lora_rank)
            self.kv_b_proj = p(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim))
            self.o_proj = p(self.attn_dim, h)
        else:
            self.attn_dim = cfg.q_dim
            self.scale = (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar
                          else cfg.head_dim ** -0.5)
            self.q_proj = p(h, cfg.q_dim)
            self.k_proj = p(h, cfg.kv_dim)
            self.v_proj = p(h, cfg.kv_dim)
            self.o_proj = p(cfg.q_dim, h)
            if cfg.attention_bias:
                self.q_bias = p(cfg.q_dim)
                self.k_bias = p(cfg.kv_dim)
                self.v_bias = p(cfg.kv_dim)
            if cfg.o_bias:
                self.o_bias = p(h)
            if cfg.qk_norm:
                self.q_norm = p(cfg.head_dim)
                self.k_norm = p(cfg.head_dim)
            if cfg.attention_sinks:
                self.sinks = p(cfg.num_attention_heads)
        self.post_attention_layernorm = p(h)
        if cfg.sandwich_norms:
            self.pre_feedforward_layernorm = p(h)
            self.post_feedforward_layernorm = p(h)
        if self.is_moe:
            self.router = p(h, cfg.num_experts)
            if cfg.router_bias:
                self.router_bias = p(cfg.num_experts)
            self.experts = Experts(cfg, device)
            if cfg.scoring_func == "sigmoid":
                self.e_score_correction_bias = p(cfg.num_experts)
            if cfg.n_shared_experts or cfg.shared_expert_intermediate_size:
                self.shared_experts = SharedExperts(cfg, device)
                if cfg.shared_expert_gated:
                    self.shared_expert_gate = p(h, 1)
        else:
            self.gate_proj = p(h, inter)
            self.up_proj = p(h, inter)
            self.down_proj = p(inter, h)
            if cfg.mlp_bias:
                self.gate_bias = p(inter)
                self.up_bias = p(inter)
                self.down_bias = p(h)

    def w(self, name: str) -> torch.Tensor:
        """Parameter ``name`` (``experts.gate_proj`` for a nested one), merged
        with its LoRA adapter where ``lora/lora.py`` attached one. Every
        forward read goes through here, inside the remat regions, so the
        merged copy lives one layer at a time and backward re-merges it."""
        merge = self.merges.get(name)
        gather = self.gathers.get(name)
        p = self.get_parameter(name)
        if gather is not None:
            p = gather(p)
        return p if merge is None else merge(p)

    def _norm(self, x, name: str):
        cfg = self.cfg
        return ops.rms_norm(x, self.w(name).to(cfg.dtype), cfg.rms_norm_eps,
                            zero_centered=cfg.norm_zero_centered)

    def _linear(self, x, weight: str, bias: str = ""):
        """x @ weight (+ bias when the layer has it), in the compute dtype."""
        dt = self.cfg.dtype
        out = x @ self.w(weight).to(dt)
        return out if getattr(self, bias, None) is None else out + self.w(bias).to(dt)

    def _qkv(self, hidden, cos, sin):
        cfg = self.cfg
        if cfg.use_mla:
            return self._mla_qkv(hidden, cos, sin)
        b, s, _ = hidden.shape
        x = self._norm(hidden, "input_layernorm")
        q = self._linear(x, "q_proj", "q_bias").view(b, s, cfg.num_attention_heads, cfg.head_dim)
        k = self._linear(x, "k_proj", "k_bias").view(b, s, cfg.num_key_value_heads, cfg.head_dim)
        v = self._linear(x, "v_proj", "v_bias").view(b, s, cfg.num_key_value_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = self._norm(q, "q_norm")
            k = self._norm(k, "k_norm")
        q, k = ops.apply_rotary(q, k, cos, sin)
        return q, k, v

    def _mla_qkv(self, hidden, cos, sin):
        """MLA's per-head q, k [B,S,nh,dn+dr] and v [B,S,nh,dv] (training
        form, ``:457-486``): q from ``q_proj`` or the ``q_a``/``q_b`` pair,
        k's nope part and v from the normed kv latent, and one rope part of
        k shared by every head."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        nh, dn, dr = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        x = self._norm(hidden, "input_layernorm")
        if cfg.q_lora_rank:
            q = self._linear(self._norm(self._linear(x, "q_a_proj"), "q_a_layernorm"), "q_b_proj")
        else:
            q = self._linear(x, "q_proj")
        q = q.view(b, s, nh, dn + dr)
        kv_a = self._linear(x, "kv_a_proj_with_mqa")
        kv = self._linear(self._norm(kv_a[..., :cfg.kv_lora_rank], "kv_a_layernorm"), "kv_b_proj")
        kv = kv.view(b, s, nh, dn + cfg.v_head_dim)
        k_rope = kv_a[..., cfg.kv_lora_rank:].view(b, s, 1, dr)
        q_rope, k_rope = ops.apply_rotary(q[..., dn:], k_rope, cos, sin,
                                          interleaved=cfg.rope_interleave)
        q = torch.cat([q[..., :dn], q_rope], dim=-1)
        k = torch.cat([kv[..., :dn], k_rope.expand(b, s, nh, dr)], dim=-1)
        return q, k, kv[..., dn:]

    def _attend(self, q, k, v, segment_ids):
        sinks = self.w("sinks").to(self.cfg.dtype) if hasattr(self, "sinks") else None
        return ops.attention(q, k, v, segment_ids=segment_ids, causal=True,
                             softmax_scale=self.scale, sliding_window=self.window or None,
                             sinks=sinks,
                             ulysses_async_chunks=self.cfg.ulysses_async_chunks or None)

    def mlp_input(self, hidden, attn):
        """(residual stream after attention, the MLP's input norm of it)."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        out = self._linear(attn.reshape(b, s, self.attn_dim), "o_proj", "o_bias")
        if cfg.sandwich_norms:
            out = self._norm(out, "post_attention_layernorm")
        hidden = hidden + out
        pre = "pre_feedforward_layernorm" if cfg.sandwich_norms else "post_attention_layernorm"
        return hidden, self._norm(hidden, pre)

    def moe(self, x):
        """The MoE MLP of x [T,H] -> ([T,H], aux) with this layer's router
        (and its bias), correction bias, experts (and their biases) and
        shared experts."""
        dt = self.cfg.dtype

        def optional(name):
            return self.w(name).to(dt) if hasattr(self, name) else None

        def weights(sub):  # the experts' (merged) weights, as moe_mlp reads them
            if not hasattr(self, sub):
                return None
            return SimpleNamespace(**{n: self.w(f"{sub}.{n}")
                                      for n, _ in self.get_submodule(sub).named_parameters()})

        return moe_mlp(x, self.w("router").to(dt), weights("experts"), self.cfg,
                       correction_bias=optional("e_score_correction_bias"),
                       shared=weights("shared_experts"),
                       shared_gate=optional("shared_expert_gate"),
                       router_bias=optional("router_bias"), stats=self.moe_stats)

    def _dense_mlp(self, x):
        act = ops.gated_act(self._linear(x, "gate_proj", "gate_bias"),
                            self._linear(x, "up_proj", "up_bias"), self.cfg.hidden_act)
        return self._linear(act, "down_proj", "down_bias")

    def _tail(self, hidden, attn):
        cfg = self.cfg
        hidden, x = self.mlp_input(hidden, attn)
        if self.is_moe:
            b, s, h = x.shape
            out, aux = self.moe(x.reshape(b * s, h))
            out = out.view(b, s, h)
        else:
            c = chunk_len(cfg.chunk_mbs, x.shape[1])
            if not c:
                out = self._dense_mlp(x)
            elif torch.is_grad_enabled():
                out = torch.cat([checkpoint(self._dense_mlp, xc, use_reentrant=False)
                                 for xc in x.split(c, dim=1)], dim=1)
            else:
                out = torch.cat([self._dense_mlp(xc) for xc in x.split(c, dim=1)], dim=1)
            aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if cfg.sandwich_norms:
            out = self._norm(out, "post_feedforward_layernorm")
        return hidden + out, aux

    def _full(self, hidden, cos, sin, segment_ids):
        q, k, v = self._qkv(hidden, cos, sin)
        return self._tail(hidden, self._attend(q, k, v, segment_ids))

    def forward(self, hidden, cos, sin, segment_ids=None):
        cfg = self.cfg
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._full(hidden, cos, sin, segment_ids)
        policy = cfg.remat_policy
        if policy not in _SPLIT_POLICIES:
            return checkpoint(self._full, hidden, cos, sin, segment_ids, use_reentrant=False)
        kw = {"use_reentrant": False}
        if policy == "dots":
            kw["context_fn"] = _dots_contexts
        elif policy == "offload":
            kw["context_fn"] = _host_matmul_contexts
        q, k, v = checkpoint(self._qkv, hidden, cos, sin, **kw)
        if policy.endswith("offload"):
            with torch.autograd.graph.save_on_cpu(pin_memory=True):
                attn = self._attend(q, k, v, segment_ids)
        else:
            attn = self._attend(q, k, v, segment_ids)
        return checkpoint(self._tail, hidden, attn, **kw)


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

        self.merges: Dict[str, Callable] = {}  # see DecoderLayer.w
        self.gathers: Dict[str, Callable] = {}
        self.embed_tokens = p(cfg.vocab_size, h)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dev, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = p(h)
        if not cfg.tie_word_embeddings:
            self.lm_head = p(h, cfg.vocab_size)
        if generator is not None:
            init_params(self, generator)

    w = DecoderLayer.w

    def embed(self, input_ids):
        """Token embeddings [B,S,H] in cfg.dtype; gemma's ``embed_scale`` is
        multiplied in the compute dtype, as the reference does (``:630-631``:
        sqrt(1152) is 34.0 in bf16)."""
        cfg, dt = self.cfg, self.cfg.dtype
        hidden = F.embedding(input_ids, self.w("embed_tokens").to(dt))
        if cfg.embed_scale:
            hidden = hidden * torch.tensor(cfg.embed_scale, dtype=dt, device=hidden.device)
        return hidden

    def rotary(self, position_ids):
        """{False: the global (cos, sin), True: the local ones} in cfg.dtype,
        [B,S,rope_dim]; the local tables (gemma3's windowed layers,
        ``rope_local_base_freq``) are the global ones without a dual rope."""
        cfg, dt = self.cfg, self.cfg.dtype
        # MLA's shared rope part, else the head's (partial) rotary width (:633-636)
        rope_dim = (cfg.qk_rope_head_dim if cfg.use_mla
                    else int(cfg.head_dim * cfg.partial_rotary_factor))
        cos, sin = ops.rotary_tables(position_ids, rope_dim, cfg.rope_theta,
                                     rope_scaling=cfg.rope_scaling,
                                     interleaved=cfg.use_mla and cfg.rope_interleave)
        tables = {False: (cos.to(dt), sin.to(dt))}
        tables[True] = tables[False]
        if cfg.rope_local_base_freq:
            cos, sin = ops.rotary_tables(position_ids, rope_dim, cfg.rope_local_base_freq)
            tables[True] = (cos.to(dt), sin.to(dt))
        return tables

    def embed_and_rotary(self, input_ids, position_ids):
        """(token embeddings [B,S,H], the global rotary cos, sin) in cfg.dtype."""
        return (self.embed(input_ids), *self.rotary(position_ids)[False])

    def forward_hidden(self, input_ids, position_ids, segment_ids=None, inputs_embeds=None):
        """[B,S] ids/segments and [B,S] positions (mrope: [B,3,S]) -> (final
        hidden [B,S,H] in cfg.dtype, router aux loss summed over the layers).
        ``inputs_embeds`` [B,S,H], where given, replace the token embeddings
        (the VLM composites' merged vision features, ``:605-627``; no
        embedding scale is applied to them, as there). Each layer attends
        with its own window and rope (``:641-668``): a full-attention layer
        keeps the ``cuda_flash`` kernels, a windowed one takes the plain
        attention."""
        cfg, dt = self.cfg, self.cfg.dtype
        hidden = self.embed(input_ids) if inputs_embeds is None else inputs_embeds.to(dt)
        tables = self.rotary(position_ids)
        aux_total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for layer in self.layers:
            layer.moe_stats.clear()
            hidden, aux = layer(hidden, *tables[layer.local_rope], segment_ids)
            aux_total = aux_total + aux
        drops = [layer.moe_stats["dropped"] for layer in self.layers if layer.moe_stats]
        # mean capacity-drop fraction over the MoE layers (``:743-745``) and,
        # under expert parallelism, over the mesh (outside the remat regions)
        self.moe_dropped_frac = None
        if drops:
            from veomni_tpu_torch.parallel.moe import mesh_mean
            from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none

            self.moe_dropped_frac = mesh_mean(sum(drops) / len(drops),
                                              get_parallel_state_or_none())
        return ops.rms_norm(hidden, self.w("norm").to(dt), cfg.rms_norm_eps,
                            zero_centered=cfg.norm_zero_centered), aux_total

    def lm_head_kernel(self) -> torch.Tensor:
        """[H, V] head matrix (tied: the embedding transposed)."""
        if self.cfg.tie_word_embeddings:
            return self.w("embed_tokens").t()
        return self.w("lm_head")

    def forward_logits(self, input_ids, position_ids, segment_ids=None):
        """f32 logits [B,S,V] from compute-dtype operands, with the final
        softcap (``:754-760``)."""
        cfg = self.cfg
        hidden, _ = self.forward_hidden(input_ids, position_ids, segment_ids)
        logits = hidden.float() @ self.lm_head_kernel().to(cfg.dtype).float()
        if cfg.final_logit_softcap:
            logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
        return logits

    def head_loss(self, hidden, labels, moe_aux) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """lm-head + chunked CE in token-sum space (softcapped logits where
        the config caps them), plus the router aux loss scaled by the token
        count so both terms normalize alike (``:783-802``).
        ``moe_dropped_frac`` is the last forward's mean capacity-drop
        fraction over the MoE layers: 0 but under expert parallelism with a
        capacity factor (the single-device MoE is dropless)."""
        cfg = self.cfg
        b, s, h = hidden.shape
        kernel = self.lm_head_kernel().to(cfg.dtype)
        loss_sum, ntokens = ops.fused_linear_cross_entropy(
            hidden.reshape(b * s, h), kernel, labels.reshape(b * s),
            logit_softcap=cfg.final_logit_softcap or None,
        )
        dropped = getattr(self, "moe_dropped_frac", None)
        metrics = {"loss_sum": loss_sum, "ntokens": ntokens, "moe_aux_loss": moe_aux,
                   "moe_dropped_frac": torch.zeros_like(moe_aux) if dropped is None
                   else dropped.to(moe_aux.dtype)}
        total = loss_sum
        if cfg.is_moe and cfg.router_aux_loss_coef:
            total = total + cfg.router_aux_loss_coef * moe_aux * ntokens
        return total, metrics

    def sequence_logprob_sums(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-row sums of the label log-probs [B] f32 (``:763-778``, the
        DPO trainer's policy and reference scores); under sequence
        parallelism summed over the row's chunks. The reference runs the
        fused CE over each row (a vmap); here one chunked per-token pass
        over the flattened rows is summed by row, the same sums. The logits
        take the final softcap as ``head_loss``'s do, where the reference
        leaves it out (ROADMAP.md queue 3, diverges on purpose 7)."""
        cfg = self.cfg
        hidden, _ = self.forward_hidden(batch["input_ids"], batch["position_ids"],
                                        batch.get("segment_ids"))
        b, s, h = hidden.shape
        nll = ops.fused_linear_cross_entropy_per_token(
            hidden.reshape(b * s, h), self.lm_head_kernel().to(cfg.dtype),
            batch["labels"].reshape(b * s), logit_softcap=cfg.final_logit_softcap or None)
        sums = -nll.view(b, s).sum(-1)
        from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none

        ps = get_parallel_state_or_none()
        if ps is not None and ps.sp_enabled:
            # each sp rank holds a chunk of the row: the row's sum is theirs
            from veomni_tpu_torch.parallel.functional import all_reduce_sum

            sums = all_reduce_sum(sums, ps.group(ps.sp_axes))
        return sums

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
    norms at 1 (zero-centered ones too, as there), biases at 0, matrices ~
    N(0, initializer_range). The numbers differ from JAX's for the same
    seed; parity tests carry weights across instead
    (``models/jax_weights.py``)."""
    std = model.cfg.initializer_range
    for name, param in model.named_parameters():
        if name.endswith("norm"):
            param.fill_(1.0)
        elif name.endswith("_bias"):
            param.zero_()
        else:
            noise = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                                device=param.device)
            param.copy_(noise * std)
