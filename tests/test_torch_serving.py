"""Port serving engine (``veomni_tpu_torch.serving``) vs the JAX reference.

f32 on the CPU, on the reference's serving toys ``QWEN3`` and ``QWEN3_MOE``
(``tests/test_serving.py``) and a ``GEMMA3`` toy whose sliding windows (8)
are shorter than its prompts, with the JAX weights carried into the port
(``load_jax_params``); prompts from numpy seeds.

* Engine parity: the port's ``InferenceEngine`` and the JAX one run the same
  request stream (staggered arrivals, a small pool that forces preemption,
  LRU eviction, shared prefixes with chunked prefill, copy-on-write
  replays, chunked prefill interleaved with decode, the cache off, mixed
  greedy and seeded sampling, the MoE toy, a deepseek toy without MLA with
  a dense first layer, sigmoid group-limited routing with a correction
  bias and a shared expert, a gpt_oss toy with sinks, alternating 8-token
  windows, router and expert biases and the clamped GLU): the token events
  in order, each
  request's token ids, finish reason, ``cached_tokens`` and preemptions, the
  preemption/copy-on-write/eviction counts and the ``TRACE_COUNTS`` deltas
  must be equal, and every greedy request must equal the port's
  ``greedy_generate`` (which ``test_torch_decode.py`` holds to the JAX one).
  After each drain the pool leaks no block.
* The block manager, prefix cache and scheduler (QoS classes, tenant
  fairness, the bounded intake, LIFO and class-aware preemption) assertions
  of ``tests/test_serving.py`` and ``tests/test_serve_qos.py``, replayed on
  the port's copies.
* The engine's own surface: the pools keep their storage across
  ``step()``, cancellation and load-shedding release every block,
  ``swap_weights`` flushes the cache, the int8 tiers serve and ``fp8``
  raises the reference's message, and an MLA config is refused as the
  reference's engine refuses it.
* ``python -m veomni_tpu_torch.tasks.serve --device cpu`` prints the lines
  ``scripts/serve.py`` prints, with the same JSON keys; the router, int8 and
  publish flags serve, and the exporter's knob raises.
"""

import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import build_foundation_model
from veomni_tpu.models import decode as jdec
from veomni_tpu import serving as jserving
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models import decode as tdec
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    KVBlockManager,
    PrefixCache,
    Request,
    SamplingParams,
    Scheduler,
    SequenceState,
    parse_classes,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN3 = dict(
    model_type="qwen3", vocab_size=128, hidden_size=64,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, qk_norm=True,
)
QWEN3_MOE = dict(
    model_type="qwen3_moe", vocab_size=128, hidden_size=64,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, qk_norm=True, num_experts=4,
    num_experts_per_tok=2, moe_intermediate_size=32,
)
# gemma3 at the same width, its sliding windows (16) shorter than the prompts
GEMMA3 = dict(
    model_type="gemma3", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    qk_norm=True, norm_zero_centered=True, sandwich_norms=True, embed_scale=8.0,
    query_pre_attn_scalar=16, sliding_window=16, rope_local_base_freq=1e4, rope_theta=1e6,
    layer_types=["sliding_attention", "sliding_attention", "full_attention"],
    hidden_act="gelu_pytorch_tanh", final_logit_softcap=30.0, tie_word_embeddings=True,
)
# the deepseek MoE pieces the engine serves (the reference's engine refuses
# MLA): a dense first layer, sigmoid noaux-tc routing in 2 groups with a
# correction bias (drawn at random by _perturb), a shared expert
DEEPSEEK_MOE = dict(
    model_type="deepseek_v3", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
    scoring_func="sigmoid", n_group=2, topk_group=1, routed_scaling_factor=1.5,
    first_k_dense_replace=1,
)
# tests/test_serving.py's GPT_OSS_ISH (sinks, alternating windows of 8,
# q/k/v/o biases, the clamped GLU) with 4 experts at top-2 and router and
# expert biases (sinks and biases drawn at random by _perturb)
GPT_OSS = dict(
    model_type="gpt_oss", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    attention_sinks=True, attention_bias=True, o_bias=True, sliding_window=8,
    layer_types=["sliding_attention", "full_attention"] * 2, hidden_act="gpt_oss_glu",
    num_experts=4, num_experts_per_tok=2, router_bias=True, mlp_bias=True,
)
CONFIGS = {"qwen3": QWEN3, "qwen3_moe": QWEN3_MOE, "gemma3": GEMMA3,
           # a window of 8, below the engine's least prefill bucket (16)
           "gemma3_w8": {**GEMMA3, "sliding_window": 8}, "deepseek_moe": DEEPSEEK_MOE,
           "gpt_oss": GPT_OSS}


def _perturb(params, seed=0):
    """gemma3's norm weights (1 at init), deepseek's correction biases and
    gpt_oss's sinks and biases (0) drawn at random, so that a norm read at
    the wrong place, or a bias or sink left out, shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith(("norm']", "sinks']")) or "bias" in name:
            x = np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def models(name):
    """(jax params, jax cfg, port model, port cfg) with the same weights."""
    jcfg = JaxConfig(dtype=jnp.float32, **CONFIGS[name])
    params = build_foundation_model(config=jcfg).family.init_params(jax.random.PRNGKey(0), jcfg)
    if name.startswith(("gemma3", "deepseek", "gpt_oss")):
        params = _perturb(params)
    cfg = TransformerConfig(dtype=torch.float32, **CONFIGS[name])
    model = Transformer(cfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, jcfg, model, cfg


@pytest.fixture(autouse=True, scope="module")
def _release_models():
    """The cached JAX parameters live only while this module runs: a later
    module in the same worker may take a census of the live arrays."""
    yield
    models.cache_clear()
    gc.collect()


def _prompts(lengths, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


def _loopy_prompts(lengths, seed=0, vocab=128, period=8):
    """Prompts whose tail n-grams recur, so the ngram drafter proposes."""
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(1, vocab, period)]
    out = []
    for n in lengths:
        reps = base * (n // period + 2)
        uniq = [int(t) for t in rng.integers(1, vocab, 2)]
        out.append((reps[: max(0, n - 2)] + uniq)[:n])
    return out


def drive(package, name, engine_kw, script):
    """Run one request stream through one package's engine. ``script`` is a
    list of ("submit", prompt, sampling kwargs), ("step", n) and ("drain",).
    Returns (events, outputs, trace-count deltas, pool stats)."""
    params, jcfg, model, cfg = models(name)
    # a config object of its own: the contiguous prefill program is kept per
    # config in each package (with its own eviction), so a fresh one makes
    # the trace-count deltas independent of what ran before in the process
    jcfg, cfg = dataclasses.replace(jcfg), dataclasses.replace(cfg)
    if package == "jax":
        eng = jserving.InferenceEngine(params, jcfg, jserving.EngineConfig(**engine_kw))
        req, sp, dec = jserving.Request, jserving.SamplingParams, jdec
    else:
        eng = InferenceEngine(model, cfg, EngineConfig(**engine_kw), device="cpu")
        req, sp, dec = Request, SamplingParams, tdec
    base = dict(dec.TRACE_COUNTS)
    events, outs = [], {}

    def record(evs):
        events.extend((e.request_id, e.token, e.index, e.finished, e.finish_reason) for e in evs)

    for op, *args in script:
        if op == "submit":
            eng.submit(req(prompt_ids=args[0], sampling=sp(**args[1])))
        elif op == "step":
            for _ in range(args[0]):
                record(eng.step())
        else:
            record(eng.generate())
            for rid, o in eng.run().items():
                outs[rid] = (o.token_ids, o.finish_reason, o.cached_tokens,
                             o.spec_accepted_tokens, o.preemptions)
            bm = eng.blocks
            assert bm.num_used == 0
            assert bm.num_free_uncached + bm.num_cached == bm.num_blocks - 1
    traces = {k: dec.TRACE_COUNTS[k] - base[k] for k in base}
    stats = dict(preemptions=eng.scheduler.preemption_count, cow=eng.blocks.cow_count,
                 evictions=eng.blocks.evictions, metrics={
                     k: v for k, v in eng.metrics().items()
                     if k in ("cached_tokens", "prompt_tokens", "prefill_chunks",
                              "spec_proposed", "spec_accepted", "generated_tokens")})
    return events, outs, traces, stats


def assert_parity(name, engine_kw, script):
    """The port's engine against the JAX one on ``script``; every greedy
    request against the port's ``greedy_generate``. Returns the port's run."""
    want = drive("jax", name, engine_kw, script)
    got = drive("torch", name, engine_kw, script)
    for what, g, w in zip(("events", "outputs", "trace counts", "pool stats"), got, want):
        assert g == w, (what, g, w)
    _, _, model, cfg = models(name)
    prompts = [(args[0], args[1]) for op, *args in script if op == "submit"]
    for rid, (p, kw) in zip(sorted(got[1], key=lambda r: int(r.split("-")[1])), prompts):
        if kw.get("temperature", 0.0) <= 0.0:
            full = tdec.greedy_generate(model, cfg, p, max_new_tokens=kw["max_new_tokens"],
                                        eos_id=kw.get("eos_id", -1))
            assert got[1][rid][0] == full[len(p):], (rid, got[1][rid][0], full[len(p):])
    return got


def _greedy(n):
    return dict(max_new_tokens=n)


def _system_prompts(seed, n_system, suffixes):
    rng = np.random.default_rng(seed)
    system = [int(t) for t in rng.integers(1, 128, n_system)]
    return [system + [int(t) for t in rng.integers(1, 128, n)] for n in suffixes]


def _cow_script(seed=12):
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(1, 128, 16)]  # 2 blocks of 8
    diverged = base[:12] + [int(t) for t in rng.integers(1, 128, 4)]
    return [("submit", base, _greedy(5)), ("drain",), ("submit", base, _greedy(5)),
            ("submit", diverged, _greedy(5)), ("drain",), ("submit", base, _greedy(5)),
            ("drain",)]


def _staggered(prompts, first, ticks, sampling):
    return ([("submit", p, sampling(i)) for i, p in enumerate(prompts[:first])]
            + [("step", ticks)]
            + [("submit", p, sampling(first + i)) for i, p in enumerate(prompts[first:])]
            + [("drain",)])


SCENARIOS = {
    "staggered": ("qwen3", dict(num_slots=2, block_size=8, max_model_len=64),
                  lambda: _staggered(_prompts((5, 9, 17, 12)), 2, 2, lambda i: _greedy(6))),
    "preemption": ("qwen3", dict(num_slots=3, block_size=8, max_model_len=40, num_blocks=8),
                   lambda: [("submit", p, _greedy(10)) for p in _prompts((9, 11, 7), seed=1)]
                   + [("drain",)]),
    "eviction": ("qwen3", dict(num_slots=1, block_size=8, max_model_len=40, num_blocks=6),
                 lambda: [x for p in _prompts((17, 19, 18), seed=14)
                          for x in (("submit", p, _greedy(8)), ("drain",))]),
    "shared_prefix_chunked": (
        "qwen3", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
        lambda: _staggered(_system_prompts(11, 19, (5, 9, 2, 13)), 2, 3, lambda i: _greedy(6))),
    "cow_replay": ("qwen3", dict(num_slots=2, block_size=8, max_model_len=64), _cow_script),
    "chunked_interleave": (
        "qwen3", dict(num_slots=2, block_size=8, max_model_len=128, prefill_chunk=16),
        lambda: [("submit", _prompts((5,), seed=16)[0], _greedy(20)), ("step", 1),
                 ("submit", _prompts((5, 60), seed=16)[1], _greedy(4)), ("drain",)]),
    "cache_off": ("qwen3", dict(num_slots=2, block_size=8, max_model_len=64, prefix_cache=False),
                  lambda: [("submit", p, _greedy(6)) for p in _prompts((9, 9), seed=15)]
                  + [("drain",)]),
    "sampled_mix": (
        "qwen3", dict(num_slots=3, block_size=8, max_model_len=64),
        lambda: _staggered(_prompts((9, 11, 6, 14), seed=2), 2, 2, lambda i: (
            _greedy(8) if i % 2 == 0 else dict(max_new_tokens=8, temperature=0.8, top_k=10,
                                               top_p=0.9, seed=7 + i)))),
    "eos": ("qwen3", dict(num_slots=2, block_size=8, max_model_len=64),
            lambda: [("submit", p, dict(max_new_tokens=8, eos_id=e))
                     for p, e in zip(_prompts((9, 12), seed=5), (55, 17))] + [("drain",)]),
    "moe_staggered_chunked": (
        "qwen3_moe", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
        lambda: _staggered(_system_prompts(21, 17, (5, 9, 3)), 2, 2, lambda i: (
            _greedy(6) if i != 1 else dict(max_new_tokens=6, temperature=0.9, top_k=20,
                                           seed=3)))),
    # gemma3, prompts of 21-43 tokens past its window of 16: staggered
    # arrivals, a shared 30-token prefix, 8-token prefill chunks, a sampled
    # request, 12 new tokens each
    "gemma3_staggered_chunked": (
        "gemma3", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
        lambda: _staggered(_system_prompts(23, 30, (5, 9, 2, 13)), 2, 3, lambda i: (
            _greedy(12) if i != 2 else dict(max_new_tokens=12, temperature=0.8, top_k=20,
                                            seed=4)))),
    "gemma3_cow_replay": ("gemma3", dict(num_slots=2, block_size=8, max_model_len=64),
                          lambda: _cow_script(seed=13)),
    # the deepseek toy: staggered arrivals behind a shared 17-token prefix,
    # 8-token prefill chunks, a sampled request
    "deepseek_staggered_chunked": (
        "deepseek_moe", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
        lambda: _staggered(_system_prompts(25, 17, (5, 9, 3)), 2, 2, lambda i: (
            _greedy(8) if i != 1 else dict(max_new_tokens=8, temperature=0.9, top_k=20,
                                           seed=5)))),
    # the gpt_oss toy: staggered arrivals behind a shared 17-token prefix
    # (its windows of 8 shorter than every prompt), 8-token prefill chunks,
    # a sampled request
    "gpt_oss_staggered_chunked": (
        "gpt_oss", dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
        lambda: _staggered(_system_prompts(27, 17, (5, 9, 3)), 2, 2, lambda i: (
            _greedy(8) if i != 1 else dict(max_new_tokens=8, temperature=0.9, top_k=20,
                                           seed=6)))),
    "moe_preemption": ("qwen3_moe", dict(num_slots=3, block_size=8, max_model_len=40,
                                         num_blocks=8, prefix_cache=False),
                       lambda: [("submit", p, _greedy(10)) for p in _prompts((9, 11, 7), seed=1)]
                       + [("drain",)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_jax_engine(scenario):
    name, engine_kw, script = SCENARIOS[scenario]
    events, outs, traces, stats = assert_parity(name, engine_kw, script())
    if "preemption" in scenario:
        assert stats["preemptions"] > 0
    if scenario == "eviction":
        assert stats["evictions"] > 0 and stats["preemptions"] == 0
    if scenario in ("cow_replay", "gemma3_cow_replay"):
        # both exact replays copy their divergence block; the cached blocks
        # are never written (the last replay still matches 15 tokens)
        assert stats["cow"] == 2
        assert sorted(o[2] for o in outs.values()) == [0, 8, 15, 15]
    if scenario in ("shared_prefix_chunked", "gemma3_staggered_chunked"):
        assert all(outs[f"req-{i}"][2] >= 16 for i in (2, 3))
    if scenario == "chunked_interleave":
        # the short request kept emitting while the long one prefilled
        first_long = next(i for i, e in enumerate(events) if e[0] == "req-1")
        assert sum(1 for e in events[:first_long] if e[0] == "req-0") >= 4
    assert sum(traces.values()) > 0


def test_window_below_the_prefill_bucket_stays_finite():
    """A window (8) below the engine's least prefill bucket (16): a padded
    chunk row's window can end before the gathered context begins. The
    port's rows with no valid key emit 0 (``ops.cache_attend``), so every
    request equals ``greedy_generate``; the reference's emit NaN into the
    null block, and its engine's replay of a cached prompt returns token 0
    from NaN logits (ROADMAP.md queue 3)."""
    script = _cow_script(seed=13)
    _, outs, _, stats = drive("torch", "gemma3_w8", dict(num_slots=2, block_size=8,
                                                         max_model_len=64), script)
    _, _, model, cfg = models("gemma3_w8")
    prompts = [args[0] for op, *args in script if op == "submit"]
    for rid, p in zip(sorted(outs, key=lambda r: int(r.split("-")[1])), prompts):
        assert outs[rid][0] == tdec.greedy_generate(model, cfg, p, max_new_tokens=5)[len(p):]
    assert stats["cow"] == 2


def test_engine_pools_keep_their_storage():
    _, _, model, cfg = models("qwen3")
    eng = InferenceEngine(model, cfg, EngineConfig(num_slots=2, block_size=8, max_model_len=64,
                                                   prefill_chunk=8, spec_k=2), device="cpu")
    ptrs = (eng.k_pool.data_ptr(), eng.v_pool.data_ptr())
    for p in _loopy_prompts((13, 21), seed=3):
        eng.submit(Request(prompt_ids=p, sampling=SamplingParams(max_new_tokens=8)))
    ticks = 0
    while eng.has_work:
        eng.step()
        ticks += 1
        assert (eng.k_pool.data_ptr(), eng.v_pool.data_ptr()) == ptrs
    assert ticks > 3 and eng.k_pool.abs().sum() > 0


def test_engine_cancel_and_queue_bound_release_blocks():
    _, _, model, cfg = models("qwen3")
    eng = InferenceEngine(model, cfg, EngineConfig(num_slots=1, block_size=8, max_model_len=96,
                                                   prefill_chunk=8, queue_bound=2),
                          device="cpu")
    long, short, extra = _prompts((40, 7, 9), seed=8)
    a = eng.submit(Request(prompt_ids=long, sampling=SamplingParams(max_new_tokens=4)))
    b = eng.submit(Request(prompt_ids=short, sampling=SamplingParams(max_new_tokens=4)))
    c = eng.submit(Request(prompt_ids=extra, sampling=SamplingParams(max_new_tokens=4)))
    assert eng.get_output(c).finish_reason == "rejected"  # two waiting already
    eng.step()  # a is mid chunked prefill
    assert eng.blocks.num_used > 0 and eng.cancel(a)
    assert eng.get_output(a).finish_reason == "cancelled" and not eng.cancel(a)
    outs = eng.run()
    assert outs[b].finish_reason == "length" and len(outs[b].token_ids) == 4
    assert eng.blocks.num_used == 0
    m = eng.metrics()
    assert m["rejected"] == 1 and m["shed_tokens"] > 0


def test_engine_swap_weights_flushes_cache():
    _, _, model, cfg = models("qwen3")
    eng = InferenceEngine(model, cfg, EngineConfig(num_slots=2, block_size=8, max_model_len=64),
                          device="cpu")
    prompt = _prompts((17,), seed=4)[0]
    first = eng.run([Request(prompt_ids=prompt, sampling=SamplingParams(max_new_tokens=4))])
    assert eng.blocks.num_cached > 0
    other = Transformer(cfg, torch.Generator().manual_seed(5), device="cpu")
    info = eng.swap_weights(other)
    assert info["cache_epoch"] == 1 and info["flushed_blocks"] > 0
    assert eng.blocks.num_cached == 0
    (out,) = eng.run([Request(prompt_ids=prompt,
                              sampling=SamplingParams(max_new_tokens=4))]).values()
    assert out.cached_tokens == 0
    assert out.token_ids == tdec.greedy_generate(other, cfg, prompt, max_new_tokens=4)[17:]
    assert list(first.values())[0].token_ids != out.token_ids
    wider = TransformerConfig(dtype=torch.float32, **{**QWEN3, "intermediate_size": 256})
    with pytest.raises(ValueError, match="swap_weights payload"):
        eng.swap_weights(Transformer(wider, torch.Generator().manual_seed(0), device="cpu"))
    eng.submit(Request(prompt_ids=prompt, sampling=SamplingParams(max_new_tokens=2)))
    with pytest.raises(RuntimeError, match="busy engine"):
        eng.swap_weights(other)


@pytest.mark.parametrize("knob", [dict(kv_quant="int8"), dict(kv_quant="fp8"),
                                  dict(weight_quant="int8")],
                         ids=["kv-int8", "kv-fp8", "weight-int8"])
def test_engine_quantized_tiers_not_ported(knob):
    """The int8 tiers are ported (tests/test_torch_kv_quant.py holds them to
    the JAX engine): they build and serve. ``fp8`` is the one tier the
    reference itself does not ship: both engines raise its message."""
    params, jcfg, model, cfg = models("qwen3")
    ec = dict(num_slots=1, max_model_len=32, **knob)
    if knob.get("kv_quant") == "fp8":
        with pytest.raises(NotImplementedError) as ref:
            jserving.InferenceEngine(params, jcfg, jserving.EngineConfig(**ec))
        with pytest.raises(NotImplementedError) as got:
            InferenceEngine(model, cfg, EngineConfig(**ec), device="cpu")
        assert str(got.value) == str(ref.value)
        return
    eng = InferenceEngine(model, cfg, EngineConfig(**ec), device="cpu")
    (out,) = eng.run([Request(prompt_ids=[3, 5, 7], sampling=SamplingParams(
        max_new_tokens=4))]).values()
    assert out.finish_reason == "length" and len(out.token_ids) == 4


def test_engine_refuses_mla_as_the_reference_does():
    """The reference has no cached decode for MLA; neither engine takes a
    deepseek MLA config."""
    cfg = dict(DEEPSEEK_MOE, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
               v_head_dim=8)
    jcfg = JaxConfig(dtype=jnp.float32, **cfg)
    params = build_foundation_model(config=jcfg).family.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="cached-decode"):
        jserving.InferenceEngine(params, jcfg, jserving.EngineConfig())
    tcfg = TransformerConfig(dtype=torch.float32, **cfg)
    with pytest.raises(ValueError, match="cached-decode"):
        InferenceEngine(Transformer(tcfg, torch.Generator(), device="cpu"), tcfg, EngineConfig(),
                        device="cpu")


def test_engine_config_validation_matches_reference():
    for bad in (dict(block_size=6), dict(prefill_chunk=-1), dict(spec_k=-1),
                dict(queue_bound=-1), dict(tenant_max_inflight=-1), dict(kv_quant="int4"),
                dict(weight_quant="fp8"), dict(metrics_label="a b"), dict(classes="a:0")):
        with pytest.raises(ValueError):
            jserving.EngineConfig(**bad)
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    for kw in (dict(), dict(num_slots=3, max_model_len=100, block_size=8)):
        assert EngineConfig(**kw).num_blocks == jserving.EngineConfig(**kw).num_blocks
    assert ({f.name for f in dataclasses.fields(EngineConfig)}
            == {f.name for f in dataclasses.fields(jserving.EngineConfig)})


def _last_lines(stdout: str, n_requests: int):
    lines = [json.loads(x) for x in stdout.strip().splitlines() if x.startswith("{")]
    return lines[0], lines[-(n_requests + 2)], lines[-(n_requests + 1)], lines[-n_requests:]


def test_serve_cli_prints_the_reference_lines(capsys):
    from veomni_tpu_torch.tasks import serve

    outs = serve.main(["--device", "cpu", "--synthetic", "4", "--max-new", "8"])
    assert len(outs) == 4 and all(len(o.token_ids) == 8 for o in outs.values())
    got = _last_lines(capsys.readouterr().out, 4)
    env = dict(os.environ, JAX_PLATFORMS="cpu", VEOMNI_XLA_PERF_FLAGS="0")
    ref = subprocess.run([sys.executable, "scripts/serve.py", "--synthetic", "4", "--max-new", "8"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = _last_lines(ref.stdout, 4)
    assert set(got[0]) == set(want[0])  # the startup capacity line
    assert set(got[1]["metrics"]) == set(want[1]["metrics"])
    assert got[2] == want[2]  # the census: 4 completed
    for g, w in zip(got[3], want[3]):
        assert set(g) == set(w) and g["request_id"] == w["request_id"]


@pytest.mark.parametrize("flags,env", [
    (["--replicas", "2"], {}), (["--publish-from", "ckpt/global_step_1"], {}),
    (["--kv-quant", "int8"], {}), (["--weight-quant", "int8"], {}),
    ([], {"VEOMNI_METRICS_PORT": "-1"}),
], ids=["replicas", "publish-from", "kv-quant", "weight-quant", "metrics-port"])
def test_serve_cli_unported_flags_raise(flags, env, monkeypatch, capsys):
    """No serving flag is gated any more: the router, the int8 tiers,
    --publish-from and the metrics exporter (slice E; ``VEOMNI_METRICS_PORT``
    -1 binds an ephemeral port, stopped when serving ends) serve, and a
    --publish-from that names no committed generation is refused by the
    integrity gate before a token is served."""
    import threading

    from veomni_tpu_torch.tasks import serve

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["--device", "cpu", "--synthetic", "2", "--max-new", "3", *flags]
    if "--publish-from" in flags:
        with pytest.raises(SystemExit, match="refused by integrity gate"):
            serve.main(argv)
        return
    outs = serve.main(argv)
    assert len(outs) == 2 and all(len(o.token_ids) == 3 for o in outs.values())
    assert not any(t.name == "veomni-metrics-http" for t in threading.enumerate())
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    flag = dict(zip(flags[::2], flags[1::2]))
    assert (first["replicas"], first["kv_quant"], first["weight_quant"]) == (
        int(flag.get("--replicas", 1)), flag.get("--kv-quant", "none"),
        flag.get("--weight-quant", "none"))


def test_serve_cli_publishes_a_checkpoint_into_the_router(tmp_path, capsys):
    """--publish-from a generation the port's Checkpointer wrote, under
    --replicas 2: the rolling publish fires after the first token and every
    request completes; on the bare engine it is swapped in before serving."""
    from veomni_tpu_torch.checkpoint.checkpointer import Checkpointer
    from veomni_tpu_torch.optim.optimizer import build_optimizer
    from veomni_tpu_torch.tasks import serve
    from veomni_tpu_torch.train.train_step import build_train_state

    args = serve.build_parser().parse_args(["--device", "cpu", "--seed", "3"])
    model, _ = serve.build_model(args, torch.device("cpu"))
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(5, build_train_state(model, build_optimizer(model, lr=1e-4)))
    ckpt.close()
    step_dir = str(tmp_path / "global_step_5")
    for replicas, mode in (("2", "rolling"), ("1", "pre-serve")):
        outs = serve.main(["--device", "cpu", "--synthetic", "3", "--max-new", "4",
                           "--replicas", replicas, "--publish-from", step_dir,
                           "--publish-version", "v5"])
        assert all(o.finish_reason == "length" for o in outs.values())
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert {"publish": "v5", "mode": mode} in [
            {k: d[k] for k in ("publish", "mode")} for d in lines if "publish" in d]


# ---------------------------------------------------------------------------
# The reference's host-side assertions (tests/test_serving.py,
# tests/test_serve_qos.py), replayed on the port's copies.
# ---------------------------------------------------------------------------
def _seq(rid, n_prompt, priority="interactive", tenant="", deadline_s=None):
    return SequenceState(request=Request(
        prompt_ids=list(range(1, n_prompt + 1)), request_id=rid,
        priority=priority, tenant=tenant, deadline_s=deadline_s,
    ))


def test_block_manager_alloc_grow_free():
    bm = KVBlockManager(num_blocks=6, block_size=4)
    assert bm.num_free == 5  # block 0 reserved as the null block
    assert bm.blocks_for(1) == 1 and bm.blocks_for(4) == 1
    assert bm.blocks_for(5) == 2
    t = bm.allocate("a", 2)
    assert len(t) == 2 and KVBlockManager.NULL_BLOCK not in t
    assert bm.num_allocated("a") == 2 and bm.num_free == 3
    bm.grow("a")
    assert bm.num_allocated("a") == 3
    assert bm.utilization() == pytest.approx(3 / 5)
    with pytest.raises(ValueError):
        bm.allocate("a", 1)  # double-allocate
    assert bm.free_seq("a") == 3
    assert bm.num_free == 5 and bm.free_seq("a") == 0  # idempotent
    with pytest.raises(ValueError):
        KVBlockManager(num_blocks=8, block_size=6)  # not a power of two


def test_block_manager_exhaustion():
    bm = KVBlockManager(num_blocks=4, block_size=4)
    bm.allocate("a", 3)
    assert not bm.can_allocate(1)
    with pytest.raises(RuntimeError):
        bm.grow("a")
    with pytest.raises(RuntimeError):
        bm.allocate("b", 1)
    bm.free_seq("a")
    assert bm.can_allocate(3)


def test_block_manager_unknown_seq_errors_are_actionable():
    """grow()/table() on an unknown sequence name the sequence and the
    valid transition instead of a bare KeyError (satellite bugfix)."""
    bm = KVBlockManager(num_blocks=6, block_size=4)
    bm.allocate("a", 1)
    with pytest.raises(KeyError, match=r"ghost.*grow\(\) is only valid"):
        bm.grow("ghost")
    with pytest.raises(KeyError, match=r"ghost.*table\(\) is only valid"):
        bm.table("ghost")
    # the message lists what IS allocated, so the operator can see the typo
    with pytest.raises(KeyError, match=r"'a'"):
        bm.table("ghost")


def test_block_manager_refcounts_shared_and_cow():
    """Shared allocation refcounts blocks; free_seq releases references,
    not blocks; the copy-on-write source is pinned through allocation."""
    bm = KVBlockManager(num_blocks=8, block_size=4)
    t_a, fresh_a = bm.allocate_shared("a", [], 3)
    assert t_a == fresh_a and all(bm.refcount(b) == 1 for b in t_a)
    # b shares a's first two blocks and adds one of its own
    t_b, fresh_b = bm.allocate_shared("b", t_a[:2], 1)
    assert t_b[:2] == t_a[:2] and len(fresh_b) == 1
    assert bm.refcount(t_a[0]) == 2 and bm.refcount(t_a[2]) == 1
    assert bm.num_used == 4  # 3 + 1 shared-suffix block
    bm.free_seq("a")
    # shared blocks survive a's release (b still references them); a's
    # exclusive third block is back on the free list (no cache attached)
    assert bm.refcount(t_a[0]) == 1 and bm.refcount(t_a[2]) == 0
    assert bm.num_used == 3
    # CoW: the pinned source keeps a reference until released
    t_c, fresh_c = bm.allocate_shared("c", t_b[:1], 1, cow_src=t_b[1])
    assert bm.cow_count == 1 and bm.refcount(t_b[1]) == 2
    bm.release_block(t_b[1])
    assert bm.refcount(t_b[1]) == 1  # b's own reference remains
    bm.free_seq("b")
    bm.free_seq("c")
    assert bm.num_used == 0 and bm.num_free == 7


def test_prefix_cache_match_insert_refcount_gated_eviction():
    bm = KVBlockManager(num_blocks=10, block_size=2)
    cache = PrefixCache(bm)
    toks = [1, 2, 3, 4, 5, 6, 7]  # 3 full blocks + 1 partial token
    table, _ = bm.allocate_shared("a", [], 4)
    assert cache.match(toks) == []  # cold
    assert cache.insert(toks[:6], table[:3]) == 3  # full blocks only
    assert cache.match(toks) == table[:3]
    assert cache.match([1, 2, 3, 99]) == table[:1]  # divergence mid-stream
    assert cache.match([9, 9, 9, 9]) == []
    # a still references everything -> nothing evictable
    assert cache.num_evictable() == 0 and bm.num_free == 5
    bm.free_seq("a")
    # refcounts dropped to 0: cached blocks are warm AND count as free
    assert cache.num_evictable() == 3 and bm.num_free == 9
    assert bm.num_used == 0
    # eviction is leaf-first (deepest block goes first), LRU-ordered
    assert cache.evict_lru() == table[2]
    assert cache.match(toks) == table[:2]
    # a match bumps LRU recency but refcount-0 blocks stay evictable
    assert cache.num_evictable() == 2
    # re-referencing a cached block removes it from the evictable set
    bm.allocate_shared("b", table[:1], 0)
    assert cache.num_evictable() == 1
    assert cache.evict_lru() == table[1]  # only the unreferenced leaf
    assert cache.evict_lru() is None  # table[0] is referenced by b
    bm.free_seq("b")
    assert cache.evict_lru() == table[0]
    assert len(cache) == 0


def test_block_manager_pool_pressure_evicts_before_exhaustion():
    """free ∪ evictable: allocation reclaims refcount-0 cached blocks LRU
    instead of failing (the engine-level counterpart: eviction before any
    preemption fires)."""
    bm = KVBlockManager(num_blocks=6, block_size=2)
    cache = PrefixCache(bm)
    table, _ = bm.allocate_shared("a", [], 3)
    cache.insert([1, 2, 3, 4, 5, 6], table)
    bm.free_seq("a")
    assert bm.num_free == 5 and bm.num_free_uncached == 2
    # needs 4 blocks: 2 free + 2 evicted from the cache (leaf-first)
    t_b, _ = bm.allocate_shared("b", [], 4)
    assert len(t_b) == 4 and bm.evictions == 2
    assert cache.match([1, 2, 3, 4, 5, 6]) == table[:1]  # root survived
    with pytest.raises(RuntimeError, match="out of KV blocks"):
        bm.grow("b", 2)  # 1 evictable + 0 free < 2


def test_scheduler_fifo_head_of_line_and_self_preempt():
    bm = KVBlockManager(num_blocks=4, block_size=4)  # 3 usable
    sched = Scheduler(2, bm)
    a, b = _seq("a", 8), _seq("b", 4)
    sched.add(a)
    sched.add(b)
    assert [s.seq_id for s in sched.admit()] == ["a"]  # idle: no headroom
    # b needs 1+1 (headroom) but only 1 block is free -> head-of-line blocked
    assert sched.admit() == []
    a.prefilling = False  # engine contract: prefill completed
    a.pos = 8  # crosses into block 3
    assert sched.ensure_decode_capacity() == []
    assert bm.num_allocated("a") == 3
    a.pos = 12  # needs a 4th block: pool dry, a is the only victim
    preempted = sched.ensure_decode_capacity()
    assert preempted == [a] and a.slot == -1 and a.preemptions == 1
    # recompute requeue lands at the FRONT (FIFO order preserved)
    assert [s.seq_id for s in sched.waiting] == ["a", "b"]
    assert bm.num_free == 3


def test_scheduler_lifo_preemption():
    bm = KVBlockManager(num_blocks=5, block_size=4)  # 4 usable
    sched = Scheduler(2, bm)
    a, b = _seq("a", 4), _seq("b", 4)
    sched.add(a)
    sched.add(b)
    assert len(sched.admit()) == 2
    a.prefilling = b.prefilling = False  # engine contract: prefill completed
    a.pos, b.pos = 4, 4
    sched.ensure_decode_capacity()  # both grow; pool now dry
    a.pos = 8
    preempted = sched.ensure_decode_capacity()
    # a needed a block; the LATEST admission (b) is the victim
    assert preempted == [b] and b.slot == -1
    assert bm.num_allocated("a") == 3
    assert sched.waiting[0] is b


def test_scheduler_admission_headroom_excludes_matched_blocks():
    """Regression: matched cached blocks leave the evictable set the moment
    admission references them, so they must not double-count as claimable
    headroom — a fully-cached tight pool head-of-line waits cleanly instead
    of exploding inside allocate_shared."""
    bm = KVBlockManager(num_blocks=6, block_size=4)  # 5 usable
    cache = PrefixCache(bm)
    sched = Scheduler(2, bm, prefix_cache=cache)
    r = _seq("r", 8)  # running seq holds 2 blocks
    sched.add(r)
    assert sched.admit() == [r]
    toks = list(range(100, 112))  # 12 tokens = 3 full blocks
    table, _ = bm.allocate_shared("x", [], 3)
    cache.insert(toks, table)
    bm.free_seq("x")  # 3 cached evictable, free list empty
    y = SequenceState(request=Request(prompt_ids=toks, request_id="y"))
    sched.add(y)
    # full-match CoW admission needs 1 fresh block + 1 headroom, but every
    # "free" block is a matched block about to be pinned -> must WAIT
    assert sched.admit() == []
    assert sched.waiting[0] is y and bm.cow_count == 0
    sched.finish(r)  # releases 2 uncached blocks to the free list
    admitted = sched.admit()
    assert admitted == [y] and bm.cow_count == 1
    assert y.cow_src == table[2] and y.cached_tokens == 11  # P-1
    assert bm.refcount(y.cow_src) == 1  # pinned until the engine's copy


def test_parse_classes():
    assert parse_classes("interactive:4,batch:1") == [
        ("interactive", 4), ("batch", 1)
    ]
    assert parse_classes(None) == [("interactive", 4), ("batch", 1)]
    assert parse_classes("rt:8, bulk:2 ,best_effort") == [
        ("rt", 8), ("bulk", 2), ("best_effort", 1)
    ]
    assert parse_classes([("a", 2)]) == [("a", 2)]
    with pytest.raises(ValueError, match="weight"):
        parse_classes("a:x")
    with pytest.raises(ValueError, match="weight"):
        parse_classes("a:0")
    with pytest.raises(ValueError, match="duplicate"):
        parse_classes("a:1,a:2")
    with pytest.raises(ValueError, match="no classes"):
        parse_classes(",")
    with pytest.raises(ValueError):  # malformed spec fails at construction
        EngineConfig(classes="a:-1")


def test_scheduler_unknown_priority():
    bm = KVBlockManager(num_blocks=8, block_size=4)
    multi = Scheduler(2, bm, classes=parse_classes(None))
    with pytest.raises(ValueError, match="unknown priority class 'vip'"):
        multi.add(_seq("a", 4, priority="vip"))
    # a single-class scheduler is the seed FIFO and accepts ANY label
    single = Scheduler(2, KVBlockManager(num_blocks=8, block_size=4),
                       classes=[("default", 1)])
    assert single.add(_seq("a", 4, priority="vip"))
    assert single.add(_seq("b", 4, priority="batch"))
    assert [s.seq_id for s in single.admit()] == ["a", "b"]  # plain FIFO


def test_scheduler_interactive_jumps_batch_backlog():
    """A batch backlog arrives first; interactive requests still get the
    weighted share of admissions (4:1 default) instead of queueing behind
    the entire backlog — and batch is NOT starved."""
    bm = KVBlockManager(num_blocks=64, block_size=4)
    sched = Scheduler(4, bm, classes=parse_classes(None))
    for i in range(4):
        sched.add(_seq(f"b{i}", 4, priority="batch"))
    for i in range(2):
        sched.add(_seq(f"i{i}", 4, priority="interactive"))
    # stride pick: interactive first (priority tie-break), then batch's
    # 1-in-5 turn, then interactive again
    assert [s.seq_id for s in sched.admit()] == ["i0", "b0", "i1", "b1"]


def test_scheduler_admission_order_weighted_share():
    """Drain a long mixed backlog through one slot: interactive ends up
    with ~4/5 of admissions while batch keeps progressing."""
    bm = KVBlockManager(num_blocks=64, block_size=4)
    sched = Scheduler(1, bm, classes=parse_classes(None))
    for i in range(10):
        sched.add(_seq(f"b{i}", 4, priority="batch"))
    for i in range(10):
        sched.add(_seq(f"i{i}", 4, priority="interactive"))
    order = []
    while sched.waiting and len(order) < 10:
        (adm,) = sched.admit()
        order.append(adm.seq_id)
        sched.finish(adm)
    n_inter = sum(1 for x in order if x.startswith("i"))
    assert n_inter == 8, order  # 4:1 stride over the first 10 picks
    assert any(x.startswith("b") for x in order)  # batch not starved


def test_scheduler_class_aware_preemption_order():
    """Pool pressure preempts BATCH before interactive even when the
    interactive sequence was admitted later (seed LIFO would evict it)."""
    bm = KVBlockManager(num_blocks=5, block_size=4)  # 4 usable
    sched = Scheduler(2, bm, classes=parse_classes(None))
    b = _seq("b", 4, priority="batch")
    sched.add(b)
    assert sched.admit() == [b]
    i = _seq("i", 4, priority="interactive")
    sched.add(i)
    assert sched.admit() == [i]
    assert b.admit_order < i.admit_order  # i is the newest admission
    b.prefilling = i.prefilling = False  # engine contract
    b.pos, i.pos = 4, 4
    sched.ensure_decode_capacity()  # both grow; pool dry
    i.pos = 8  # interactive needs another block
    preempted = sched.ensure_decode_capacity()
    # victim = newest admission of the LOWEST-priority class: batch
    assert preempted == [b] and b.slot == -1 and i.slot >= 0
    # within one class the choice stays LIFO (the seed test still passes
    # via test_serving.py; pin the class tie-break here too)
    assert sched._preempt_victim() is i  # only interactive left running


def test_scheduler_tenant_fairness_bounded_share():
    """A greedy tenant floods the queue; a trickle tenant arriving later
    still gets every other admission inside the class (unit-quantum DRR) —
    bounded share, no starvation."""
    bm = KVBlockManager(num_blocks=64, block_size=4)
    sched = Scheduler(1, bm, classes=parse_classes(None))
    for i in range(8):
        sched.add(_seq(f"greedy{i}", 4, tenant="greedy"))
    for i in range(3):
        sched.add(_seq(f"small{i}", 4, tenant="small"))
    order = []
    for _ in range(6):
        (adm,) = sched.admit()
        order.append(adm.seq_id)
        sched.finish(adm)
    # alternating shares while both are backlogged; FIFO within each tenant
    assert order == ["greedy0", "small0", "greedy1", "small1",
                     "greedy2", "small2"], order
    # a tenant joining late starts at the current credit level — it cannot
    # burst to "catch up" on rounds it never waited through
    sched.add(_seq("late0", 4, tenant="late"))
    sched.add(_seq("late1", 4, tenant="late"))
    (adm,) = sched.admit()
    assert adm.tenant == "late"  # fair share from now on...
    sched.finish(adm)
    (adm2,) = sched.admit()
    assert adm2.tenant == "greedy"  # ...but not two in a row


def test_scheduler_queue_bound_and_requeue_exempt():
    bm = KVBlockManager(num_blocks=8, block_size=4)
    sched = Scheduler(1, bm, classes=parse_classes(None), queue_bound=2)
    a = _seq("a", 4)
    sched.add(a)
    assert sched.admit() == [a]
    assert sched.add(_seq("w1", 4))
    assert sched.add(_seq("w2", 4))
    assert not sched.add(_seq("w3", 4))  # bound reached: shed
    assert len(sched.waiting) == 2
    # preemption requeue is EXEMPT: admitted work is never shed by its own
    # recompute — the queue may transiently exceed the bound
    a.prefilling = False
    a.pos = 40  # needs more blocks than the whole pool holds
    assert sched.ensure_decode_capacity() == [a]
    assert len(sched.waiting) == 3 and sched.waiting[0] is a


def test_scheduler_tenant_inflight_cap():
    bm = KVBlockManager(num_blocks=16, block_size=4)
    sched = Scheduler(2, bm, classes=parse_classes(None),
                      tenant_max_inflight=2)
    assert sched.add(_seq("a1", 4, tenant="a"))
    assert sched.add(_seq("a2", 4, tenant="a"))
    assert not sched.add(_seq("a3", 4, tenant="a"))  # cap: waiting counts
    assert sched.add(_seq("b1", 4, tenant="b"))  # other tenants unaffected
    sched.admit()  # a1, a2 admitted (b1 waits: 2 slots)
    assert not sched.add(_seq("a4", 4, tenant="a"))  # running counts too
    for _, s in sched.running():
        sched.finish(s)
    assert sched.add(_seq("a5", 4, tenant="a"))  # capacity released
