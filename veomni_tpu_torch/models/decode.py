"""KV-cache decoding for the dense/MoE transformer: contiguous and paged.

Port of ``veomni_tpu/models/decode.py``: the contiguous prefill and decode
loop behind ``greedy_generate`` (``:606``, ``:710``, ``:810``), and the
paged steps the serving engine drives: ``paged_prefill_step`` (``:441``),
``copy_block`` (``:469``), ``paged_decode_step`` (``:481``),
``paged_verify_step`` (``:502``) with ``verify_accept`` (``:532``),
``scatter_prompt_cache`` (``:575``), and the sampling of ``_select_token``
(``:655``, its nucleus ``_nucleus_mask:641`` folded into the one threshold
of ``keep_threshold``) and ``sample_tokens`` (``:675``).

PyTorch idiom in place of the reference's jitted programs:

* The steps take the compute-dtype parameter set that ``_compute_cast``
  builds from a ``Transformer`` once (the reference casts inside every jit;
  here that would re-cast every weight every tick).
* KV pools and caches are written in place (``index_put_`` into the one
  pool tensor, or into an int8 pool's payload and scale through
  ``QuantizedKV.__setitem__``, which quantizes a float value on write): the
  reference returns new pools from donated buffers, and a functional update
  here would copy the whole pool every tick. The steps return only their
  logits or tokens.
* The layer scan is a Python loop over the layers (``_layer_meta`` gives
  each its window and rope, as the reference's scanned per-layer arrays
  do), with one mask built per distinct window.
* ``TRACE_COUNTS`` counts the distinct bucket shapes each program has seen:
  the number of traces the reference's jits would make on the same stream
  (one per new shape, per engine for the engine's steps and per model
  config for the contiguous prefill and decode).

Sampling draws with the threefry port (``ops/threefry.py``), so a sampled
token is a function of (seed, token index, logits) exactly as in the
reference, whatever else shares the batch.

Scope: the dialects ``models/transformer.py::check_supported`` admits (GQA
with qk-norm, HF rope scaling and partial or dual rotary, sliding windows
per layer, q/k/v/o and MLP biases, gemma3's zero-centered and sandwich
norms, embedding scale, ``query_pre_attn_scalar``, GELU and final logit
softcap, dense or MoE with every routing dialect, shared experts and
leading dense layers, ``decode.py:271-277``; gpt_oss's sinks, router and
expert biases and clamped GLU, ``:121-239``). MLA/DSA and hybrid linear
attention raise: the reference has no cached decode for MLA
(``supports_cached_decode``), so neither has the port.
"""

from __future__ import annotations

import threading
from collections.abc import Mapping
from types import SimpleNamespace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from veomni_tpu_torch import ops
from veomni_tpu_torch.models.config import TransformerConfig
from veomni_tpu_torch.models.transformer import check_supported, moe_mlp
from veomni_tpu_torch.ops import threefry


def supports_cached_decode(cfg) -> bool:
    """True only for plain TransformerConfig dialects outside MLA/DSA, hybrid
    linear attention and mrope (the reference's gate, ``:34``). The port's
    ``check_decode_supported`` adds the features it has not ported."""
    if type(cfg) is not TransformerConfig:
        return False
    if cfg.use_mla or cfg.use_dsa or cfg.model_type in ("qwen3_next",) or getattr(
            cfg, "linear_attn_layers", None):
        return False
    rs = cfg.rope_scaling or {}
    if "mrope" in str(rs.get("type", rs.get("rope_type", ""))) or rs.get("mrope_section"):
        return False
    return True


def check_decode_supported(cfg) -> None:
    """ValueError for a config with no cached-decode path at all,
    NotImplementedError for a feature of one the port has not ported."""
    if not supports_cached_decode(cfg):
        raise ValueError(
            f"config {getattr(cfg, 'model_type', cfg)!r} has no cached-decode path; the "
            "serving engine requires supports_cached_decode(cfg)"
        )
    check_supported(cfg)


def _compute_cast(model, cfg: TransformerConfig, *, weight_quant: str = "none",
                  device=None) -> Dict:
    """The parameters in the compute dtype as plain tensors on ``device``
    (default: where they lie; one already there in that dtype is shared, not
    copied): ``embed_tokens``, ``norm``, ``lm_head`` (untied), and
    ``layers``, one dict per layer whose MoE ``experts`` and
    ``shared_experts`` are namespaces of ``gate_proj``/``up_proj``/
    ``down_proj``. ``model`` is a ``Transformer`` or a flat ``{name:
    tensor}`` mapping with its parameter names (``layers.3.q_proj``), on any
    device (the router's host payloads). ``weight_quant="int8"`` stores each
    layer's dense projections as ``QuantizedWeight``, quantized from the
    parameters' own dtype as the reference quantizes its params
    (``ops/quantization.py::quantize_decode_params``)."""
    state = model if isinstance(model, Mapping) else dict(model.named_parameters())
    dev = torch.device(device) if device is not None else next(iter(state.values())).device
    raw: Dict = {"layers": [{} for _ in range(cfg.num_hidden_layers)]}
    for name, p in state.items():
        parts = name.split(".")
        if parts[0] != "layers":
            raw[name] = p.detach()
        elif len(parts) == 3:
            raw["layers"][int(parts[1])][parts[2]] = p.detach()
        else:  # layers.<i>.experts.gate_proj
            raw["layers"][int(parts[1])].setdefault(parts[2], {})[parts[3]] = p.detach()
    if weight_quant == "int8":
        raw = ops.quantize_decode_params(
            {**raw, "layers": [{k: v.to(dev) if k in ops.DECODE_QUANT_KEYS else v
                                for k, v in lp.items()} for lp in raw["layers"]]})

    def cast(p):
        return p if isinstance(p, ops.QuantizedWeight) else p.to(device=dev, dtype=cfg.dtype)

    compute = {k: cast(v) for k, v in raw.items() if k != "layers"}
    compute["layers"] = [
        {k: SimpleNamespace(**{n: cast(t) for n, t in v.items()}) if isinstance(v, dict)
         else cast(v) for k, v in lp.items()}
        for lp in raw["layers"]]
    return compute


def _rope_tables(cfg: TransformerConfig, positions):
    """{False: the global (cos, sin), True: the local ones} [..., rope_dim]
    in the compute dtype (``:72-83``); without a dual rope both are global."""
    rope_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
    cos, sin = ops.rotary_tables(positions, rope_dim, cfg.rope_theta,
                                 rope_scaling=cfg.rope_scaling)
    tables = {False: (cos.to(cfg.dtype), sin.to(cfg.dtype))}
    tables[True] = tables[False]
    if cfg.rope_local_base_freq:
        cos, sin = ops.rotary_tables(positions, rope_dim, cfg.rope_local_base_freq)
        tables[True] = (cos.to(cfg.dtype), sin.to(cfg.dtype))
    return tables


def _layer_meta(cfg: TransformerConfig):
    """Per layer (window, local rope): the window 0 for full attention
    (``:225-236``)."""
    return [(cfg.window_for_layer(i),
             bool(cfg.rope_local_base_freq) and cfg.window_for_layer(i) > 0)
            for i in range(cfg.num_hidden_layers)]


def _window_masks(cfg: TransformerConfig, valid, qpos, kpos):
    """{window: the causal+length mask ``valid`` AND the window} for each
    distinct window of the config."""
    return {w: valid if w == 0 else valid & (qpos - kpos < w)
            for w in {w for w, _ in _layer_meta(cfg)}}


def _norm(x, w, cfg: TransformerConfig):
    return ops.rms_norm(x, w, cfg.rms_norm_eps, zero_centered=cfg.norm_zero_centered)


def _embed(compute, cfg: TransformerConfig, tokens):
    """Token embeddings, gemma's ``embed_scale`` multiplied in the compute
    dtype (``:589-590``)."""
    hidden = F.embedding(tokens, compute["embed_tokens"])
    if cfg.embed_scale:
        hidden = hidden * torch.tensor(cfg.embed_scale, dtype=cfg.dtype, device=hidden.device)
    return hidden


def _proj(x, lp, weight: str, bias: str):
    out = ops.decode_dot(x, lp[weight])
    return out + lp[bias] if bias in lp else out


def _qkv(x, lp, cfg: TransformerConfig, cos, sin):
    """x [B,T,H] -> q [B,T,hq,d], k/v [B,T,hkv,d] with biases, norms and
    rope (partial where the tables are narrower than the head) applied."""
    b, t, _ = x.shape
    q = _proj(x, lp, "q_proj", "q_bias").view(b, t, cfg.num_attention_heads, cfg.head_dim)
    k = _proj(x, lp, "k_proj", "k_bias").view(b, t, cfg.num_key_value_heads, cfg.head_dim)
    v = _proj(x, lp, "v_proj", "v_bias").view(b, t, cfg.num_key_value_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _norm(q, lp["q_norm"], cfg)
        k = _norm(k, lp["k_norm"], cfg)
    q, k = ops.apply_rotary(q, k, cos, sin)
    return q, k, v


def _attn_params(cfg: TransformerConfig) -> Tuple[int, float]:
    """(GQA repeat factor, softmax scale) of the cache-attention paths."""
    scale = (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar
             else cfg.head_dim ** -0.5)
    return cfg.num_attention_heads // cfg.num_key_value_heads, scale


def _mlp(x, lp, cfg: TransformerConfig):
    """The layer's MLP: routed experts (+ shared ones) on a MoE layer, the
    dense gated MLP on the others (a MoE config's leading dense layers)."""
    if "router" in lp:
        b, t, h = x.shape
        out, _ = moe_mlp(x.reshape(b * t, h), lp["router"], lp["experts"], cfg,
                         correction_bias=lp.get("e_score_correction_bias"),
                         shared=lp.get("shared_experts"), shared_gate=lp.get("shared_expert_gate"),
                         router_bias=lp.get("router_bias"))
        return out.view(b, t, h)
    act = ops.gated_act(_proj(x, lp, "gate_proj", "gate_bias"),
                        _proj(x, lp, "up_proj", "up_bias"), cfg.hidden_act)
    return _proj(act, lp, "down_proj", "down_bias")


def _layer_tail(hidden, attn, lp, cfg: TransformerConfig):
    """o_proj + residual + FFN, shared by every layer variant; with sandwich
    norms the attention and MLP outputs are normalised before their
    residual adds and ``pre_feedforward_layernorm`` is the MLP's input norm
    (``:148-163``)."""
    b, t = attn.shape[:2]
    out = _proj(attn.reshape(b, t, cfg.q_dim), lp, "o_proj", "o_bias")
    if cfg.sandwich_norms:
        out = _norm(out, lp["post_attention_layernorm"], cfg)
    hidden = hidden + out
    pre = lp["pre_feedforward_layernorm"] if cfg.sandwich_norms else lp["post_attention_layernorm"]
    out = _mlp(_norm(hidden, pre, cfg), lp, cfg)
    if cfg.sandwich_norms:
        out = _norm(out, lp["post_feedforward_layernorm"], cfg)
    return hidden + out


def _layer(hidden, lp, cfg: TransformerConfig, cos, sin, k_cache, v_cache, valid_mask,
           write_idx: int):
    """One layer against the contiguous cache [B,M,hkv,d]: this layer's new
    k/v rows are written at ``write_idx`` before attending."""
    q, k_new, v_new = _qkv(_norm(hidden, lp["input_layernorm"], cfg), lp, cfg, cos, sin)
    t = k_new.shape[1]
    k_cache[:, write_idx:write_idx + t] = k_new
    v_cache[:, write_idx:write_idx + t] = v_new
    nrep, scale = _attn_params(cfg)
    attn = ops.cache_attend(q, k_cache, v_cache, valid_mask, num_rep=nrep, scale=scale,
                            sinks=lp.get("sinks"))
    return _layer_tail(hidden, attn, lp, cfg)


def _paged_layer(hidden, lp, cfg: TransformerConfig, cos, sin, k_pool, v_pool, block_tables,
                 write_blocks, write_offs, valid_mask, attend):
    """One layer against one layer's block pool [NB,BS,hkv,d]. Every query
    row's k/v is written to its (block, offset) BEFORE attending, so a row
    sees the rows before it in its own step as well as the cached prefix.
    Rows that are not real (inactive slots, padding) go to the null block 0,
    which no live query can see."""
    q, k_new, v_new = _qkv(_norm(hidden, lp["input_layernorm"], cfg), lp, cfg, cos, sin)
    hkv, d = k_new.shape[-2:]
    k_pool[write_blocks, write_offs] = k_new.reshape(write_blocks.shape + (hkv, d))
    v_pool[write_blocks, write_offs] = v_new.reshape(write_blocks.shape + (hkv, d))
    nrep, scale = _attn_params(cfg)
    attn = attend(q, k_pool, v_pool, block_tables, valid_mask, num_rep=nrep, scale=scale,
                  sinks=lp.get("sinks"))
    return _layer_tail(hidden, attn, lp, cfg)


def _walk(compute, cfg: TransformerConfig, hidden, caches, write_idx: int, tables, valid):
    """All layers against the contiguous caches (k, v [L,B,M,hkv,d]); valid
    [B,T,M] is the causal+length mask, each layer's window AND-ed on
    (``:297-316``)."""
    k_all, v_all = caches
    kpos = torch.arange(k_all.shape[2], device=hidden.device)[None, None]
    qpos = write_idx + torch.arange(hidden.shape[1], device=hidden.device)[None, :, None]
    masks = _window_masks(cfg, valid, qpos, kpos)
    for layer, (lp, (window, local)) in enumerate(zip(compute["layers"], _layer_meta(cfg))):
        hidden = _layer(hidden, lp, cfg, *tables[local], k_all[layer], v_all[layer],
                        masks[window], write_idx)
    return hidden


def _paged_walk(compute, cfg: TransformerConfig, hidden, pools, block_tables, positions,
                real, tables, attend):
    """All layers against the block pools (k, v [L,NB,BS,hkv,d]).
    block_tables [S,nb] (null-padded); positions [S,T] are each query row's
    absolute write/query position; ``real`` [S,T] marks the rows that write
    their k/v to the table (the others write to the null block). Block-table
    order is sequence order, so gathered index j sits at position j and the
    causal and window masks are the contiguous path's."""
    k_all, v_all = pools
    bs = k_all.shape[2]
    nb = block_tables.shape[1]
    kpos = torch.arange(nb * bs, device=positions.device)
    qpos = positions[:, :, None]
    masks = _window_masks(cfg, kpos <= qpos, qpos, kpos)  # each [S,T,ctx]
    # the clip keeps the table gather in bounds for padded rows whose
    # position overruns the table; they are rerouted to block 0 anyway
    blk_idx = torch.clamp(torch.div(positions, bs, rounding_mode="floor"), 0, nb - 1)
    write_blocks = torch.where(real, block_tables.gather(1, blk_idx), 0)
    write_offs = positions % bs
    for layer, (lp, (window, local)) in enumerate(zip(compute["layers"], _layer_meta(cfg))):
        hidden = _paged_layer(hidden, lp, cfg, *tables[local], k_all[layer], v_all[layer],
                              block_tables, write_blocks, write_offs, masks[window], attend)
    return hidden


def _logits(compute, cfg: TransformerConfig, hidden):
    """Final norm + LM head: compute-dtype operands, f32 products (the
    reference's ``preferred_element_type=f32``), then the final softcap."""
    hidden = _norm(hidden, compute["norm"], cfg)
    kernel = compute["embed_tokens"].t() if cfg.tie_word_embeddings else compute["lm_head"]
    logits = hidden.float() @ kernel.float()
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


# --------------------------------------------------------------------------
# Paged steps (the serving engine's programs)
# --------------------------------------------------------------------------
@torch.inference_mode()
def paged_prefill_step(compute, cfg: TransformerConfig, pools, block_table, start_pos: int,
                       tokens, chunk_len: int, chunk_bucket: int):
    """Prefill one chunk of ONE sequence against the paged pool.

    tokens [CB] (zero-padded past ``chunk_len``); block_table [nb] covering
    the sequence's whole allocation (null-padded). Writes the chunk's KV rows
    at positions [start_pos, start_pos + chunk_len) in place and attends each
    row over the whole prefix through the table. Returns the f32 logits of
    the last real chunk row [1,V]."""
    dev = tokens.device
    positions = start_pos + torch.arange(chunk_bucket, device=dev)
    tables = _rope_tables(cfg, positions[None])
    real = (torch.arange(chunk_bucket, device=dev) < chunk_len)[None]
    hidden = _paged_walk(compute, cfg, _embed(compute, cfg, tokens[None]), pools,
                         block_table[None], positions[None], real, tables,
                         ops.paged_prefill_attend)
    return _logits(compute, cfg, hidden[:, chunk_len - 1])


@torch.inference_mode()
def copy_block(pools, src: int, dst: int) -> None:
    """Copy-on-write: duplicate one block's rows (all layers) from ``src``
    to ``dst``, in place."""
    for pool in pools:
        pool[:, dst] = pool[:, src]


@torch.inference_mode()
def paged_decode_step(compute, cfg: TransformerConfig, pools, block_tables, positions, tokens):
    """One batched decode step over the slot batch: tokens [S] (each slot's
    latest token), positions [S] (where it is written and attends from),
    block_tables [S,nb] padded with the null block 0. Writes the pools in
    place; returns the f32 logits [S,V]."""
    positions = positions[:, None]
    tables = _rope_tables(cfg, positions)
    hidden = _paged_walk(compute, cfg, _embed(compute, cfg, tokens[:, None]), pools,
                         block_tables, positions, torch.ones_like(positions, dtype=torch.bool),
                         tables, ops.paged_attend)
    return _logits(compute, cfg, hidden)[:, 0]


@torch.inference_mode()
def paged_verify_step(compute, cfg: TransformerConfig, pools, block_tables, positions, tokens,
                      n_input):
    """One batched speculative verify step: tokens [S,KB] (column 0 the
    committed last token, then the drafts, zero-padded past ``n_input``),
    positions [S] (column 0's write position), n_input [S] in [1, KB].
    Returns the f32 logits [S,KB,V]: column j is the next-token distribution
    after candidate row j, with the draft rows 0..j written."""
    kb = tokens.shape[1]
    rows = torch.arange(kb, device=tokens.device)
    pos_rows = positions[:, None] + rows[None]
    tables = _rope_tables(cfg, pos_rows)
    real = rows[None] < n_input[:, None]
    hidden = _paged_walk(compute, cfg, _embed(compute, cfg, tokens), pools, block_tables,
                         pos_rows, real, tables, ops.paged_attend)
    return _logits(compute, cfg, hidden)


@torch.inference_mode()
def scatter_prompt_cache(pools, prompt_caches, block_ids) -> None:
    """Write a contiguous prefill cache (k, v [L,1,PB,hkv,d]) into the pool
    blocks ``block_ids`` [PB/BS] (padded with the null block 0 past the
    sequence's allocation), in place."""
    for pool, cache in zip(pools, prompt_caches):
        L, _, pb, hkv, d = cache.shape
        bs = pool.shape[2]
        pool[:, block_ids] = cache[:, 0].reshape(L, pb // bs, bs, hkv, d)


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------
def _select_token(logits, key, temperature: float, top_k: int, top_p: float = 1.0):
    """[B,V] f32 -> [B]: greedy when temperature <= 0, else temperature,
    top-k (clamped to the vocab), top-p (``keep_threshold``; top_p >= 1
    keeps everything), then one categorical draw per row from the single
    key ``key`` [2] over the whole [B,V] (as
    ``jax.random.categorical(key, logits)``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = logits / temperature
    rows = l.shape[0]
    thresh = keep_threshold(
        l, torch.full((rows,), top_k, device=l.device),
        torch.full((rows,), top_p if top_p < 1.0 else float("inf"), device=l.device))
    return threefry.categorical(key, l.masked_fill(l < thresh, float("-inf")))


def sample_tokens(logits, keys, temperature, top_k, top_p):
    """Per-slot sampling for the serving engine: logits [S,V] f32; keys
    [S,2] (one key per slot, so a draw does not depend on the batch);
    temperature/top_p [S] f32, top_k [S] int. Per slot: temperature <= 0 is
    greedy, top_k <= 0 keeps everything (clamped to the vocab), top_p >= 1
    keeps everything. One full-vocab sort serves both filters: top-k keeps a
    prefix of the sorted order and the nucleus a prefix of that, so both
    reduce to one threshold."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temperature > 0).any()):
        return greedy  # what the where() below selects for every row
    l = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    thresh = keep_threshold(l, top_k, top_p)
    sampled = threefry.categorical(keys, l.masked_fill(l < thresh, float("-inf")))
    return torch.where(temperature <= 0.0, greedy, sampled)


def keep_threshold(l, top_k, top_p):
    """Per row of temperature-scaled logits l [S,V], the least logit of the
    top-k/top-p keep-set [S,1] (``sample_tokens`` keeps l >= it)."""
    v = l.shape[-1]
    sl = torch.sort(l, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v) - 1
    in_k = torch.arange(v, device=l.device)[None] <= k_idx[:, None]
    p = torch.softmax(sl.masked_fill(~in_k, float("-inf")), dim=-1)
    keep = in_k & ((torch.cumsum(p, dim=-1) - p) < top_p[:, None])
    nkeep = torch.clamp_min(keep.sum(-1), 1)
    return sl.gather(-1, (nkeep - 1)[:, None])


def verify_accept(logits, tokens, n_input, keys, temperature, top_k, top_p):
    """Accept-prefix selection of a verify step: logits [S,KB,V] from
    :func:`paged_verify_step`, tokens [S,KB] its inputs, n_input [S], keys
    [S,2] the per-slot carries. Returns ``(targets [S,KB], n_emit [S],
    new_keys [S,2])``: column j is what the one-token engine would emit as
    this tick's (j+1)-th token, sampled with its key schedule (split the
    carry once per emitted token); draft j+1 is accepted iff it equals
    target j and every earlier draft was accepted; ``n_emit`` is the
    accepted prefix plus the bonus token, and ``new_keys`` the carry
    advanced by exactly ``n_emit`` splits."""
    s, kb, _ = logits.shape
    carry = threefry.as_keys(keys, logits.device)
    target_cols, carry_cols = [], [carry]
    for j in range(kb):
        pair = threefry.split(carry)
        target_cols.append(sample_tokens(logits[:, j], pair[:, 1], temperature, top_k, top_p))
        carry = pair[:, 0]
        carry_cols.append(carry)
    targets = torch.stack(target_cols, dim=1)
    carries = torch.stack(carry_cols, dim=1)  # [S,KB+1,2]
    if kb > 1:
        in_draft = torch.arange(1, kb, device=logits.device)[None] < n_input[:, None]
        match = (tokens[:, 1:] == targets[:, :-1]) & in_draft
        accepted = torch.cumprod(match.long(), dim=1).sum(1)
    else:
        accepted = torch.zeros(s, dtype=torch.long, device=logits.device)
    n_emit = accepted + 1
    return targets, n_emit, carries[torch.arange(s, device=logits.device), n_emit]


# --------------------------------------------------------------------------
# Contiguous prefill + decode (greedy_generate, and the engine's monolithic
# prefill)
# --------------------------------------------------------------------------
@torch.inference_mode()
def _prefill_impl(compute, cfg: TransformerConfig, tokens, prompt_len: int, prompt_bucket: int,
                  max_len: int):
    """tokens [B,>=prompt_bucket] (prompt in [:prompt_len], zero-padded) ->
    (last-prompt-token logits [B,V] f32, caches (k, v [L,B,max_len,hkv,d])).
    The padded rows write garbage k/v at [prompt_len, prompt_bucket): the
    causal mask hides a row from every earlier query, and decode overwrites
    row ``pos`` before attending to it."""
    b, dev = tokens.shape[0], tokens.device
    shape = (cfg.num_hidden_layers, b, max_len, cfg.num_key_value_heads, cfg.head_dim)
    caches = (torch.zeros(shape, dtype=cfg.dtype, device=dev),
              torch.zeros(shape, dtype=cfg.dtype, device=dev))
    positions = torch.arange(prompt_bucket, device=dev).expand(b, prompt_bucket)
    valid = (torch.arange(max_len, device=dev)[None, None]
             <= torch.arange(prompt_bucket, device=dev)[None, :, None])
    hidden = _walk(compute, cfg, _embed(compute, cfg, tokens[:, :prompt_bucket]), caches, 0,
                   _rope_tables(cfg, positions), valid)
    return _logits(compute, cfg, hidden[:, prompt_len - 1]), caches


@torch.inference_mode()
def _decode_impl(compute, cfg: TransformerConfig, caches, first_token, start_pos: int, key,
                 n_steps: int, temperature: float, top_k: int, top_p: float):
    """Emit n_steps tokens from first_token at start_pos; the key [2] is
    split once per step. Returns [B, n_steps]."""
    max_len, dev = caches[0].shape[2], first_token.device
    kpos = torch.arange(max_len, device=dev)[None, None]
    token, out = first_token, []
    for pos in range(start_pos, start_pos + n_steps):
        positions = torch.full((token.shape[0], 1), pos, device=dev)
        hidden = _walk(compute, cfg, _embed(compute, cfg, token[:, None]), caches, pos,
                       _rope_tables(cfg, positions), kpos <= pos)
        key, sub = threefry.split(key)
        token = _select_token(_logits(compute, cfg, hidden)[:, 0], sub, temperature, top_k,
                              top_p)
        out.append(token)
    return torch.stack(out, dim=1)


# Distinct bucket shapes seen per program: the reference's trace counts
# (every new shape of a jitted program is one trace; tests assert the bucket
# scheme keeps these flat across distinct prompt lengths).
TRACE_COUNTS = {"prefill": 0, "decode": 0, "paged_decode": 0, "paged_prefill": 0,
                "paged_verify": 0}


# the router's replicas tick on threads of their own and share TRACE_COUNTS
_TRACE_LOCK = threading.Lock()


class Program:
    """The bucket shapes one program has run at; a new one counts a trace."""

    def __init__(self, name: str):
        self.name = name
        self._seen = set()

    def see(self, bucket) -> None:
        if bucket not in self._seen:
            self._seen.add(bucket)
            with _TRACE_LOCK:
                TRACE_COUNTS[self.name] += 1


# the contiguous prefill/decode programs per model config CONTENT (a config
# mutated in place counts as a new one)
_PROGRAMS: Dict[Tuple, Tuple] = {}


def _programs(cfg: TransformerConfig) -> Tuple[Program, Program]:
    key = (id(cfg), hash(repr(cfg)))
    if key not in _PROGRAMS:
        # the config is held so its id cannot be reused while the entry lives
        _PROGRAMS[key] = (cfg, Program("prefill"), Program("decode"))
    return _PROGRAMS[key][1:]


def _bucket_pow2(n: int, floor: int = 16) -> int:
    """Smallest power of two >= n (>= floor): the bucket for prompt/cache
    lengths, so nearby lengths share one program shape."""
    b = floor
    while b < n:
        b *= 2
    return b


def prefill(compute, cfg: TransformerConfig, tokens, prompt_len: int, prompt_bucket: int,
            max_len: int):
    """``_prefill_impl`` through the config's shared prefill program (the
    engine's monolithic prefill and ``greedy_generate`` count together)."""
    _programs(cfg)[0].see((tuple(tokens.shape), prompt_bucket, max_len))
    return _prefill_impl(compute, cfg, tokens, prompt_len, prompt_bucket, max_len)


@torch.inference_mode()
def greedy_generate(model, cfg: TransformerConfig, prompt_ids, max_new_tokens: int = 64,
                    eos_id: int = -1, temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, seed: int = 0):
    """Prompt token list -> full id list (prompt + generated, trimmed at
    eos), on the device of ``model``'s parameters. One prefill + a decode
    loop over power-of-two prompt and cache buckets. temperature <= 0
    (default) is greedy; otherwise temperature/top-k/top-p sampling."""
    ids = [int(x) for x in prompt_ids]
    if max_new_tokens <= 0:
        return ids
    check_decode_supported(cfg)
    compute = _compute_cast(model, cfg)
    dev = compute["embed_tokens"].device
    prompt_len = len(ids)
    prompt_bucket = _bucket_pow2(prompt_len)
    max_len = _bucket_pow2(prompt_len + max_new_tokens)
    tokens = torch.zeros((1, max_len), dtype=torch.long, device=dev)
    tokens[0, :prompt_len] = torch.tensor(ids, device=dev)
    logits, caches = prefill(compute, cfg, tokens, prompt_len, prompt_bucket, max_len)
    key, sub = threefry.split(threefry.as_keys(threefry.prng_key(seed), dev))
    first = _select_token(logits, sub, float(temperature), int(top_k), float(top_p))
    out = [int(first[0])]
    if max_new_tokens > 1:
        n = max_new_tokens - 1
        _programs(cfg)[1].see((1, max_len, n, float(temperature), int(top_k), float(top_p)))
        rest = _decode_impl(compute, cfg, caches, first, prompt_len, key, n,
                            float(temperature), int(top_k), float(top_p))
        out += [int(x) for x in rest[0].tolist()]
    if eos_id >= 0 and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    return ids + out
