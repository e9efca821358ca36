"""The port's int8 serving tier (``veomni_tpu_torch/ops/quantization.py``,
the q8 paged attends, the engine's ``kv_quant``/``weight_quant`` and
``serving/quality.py``) against the JAX package, on the CPU, in f32.

* ``quantize_rows`` and ``quantize_weight``: payload and scale bit-equal to
  the reference's on seeded inputs, zero rows included.
* ``QuantizedKV``: a float write quantizes as the reference's
  ``.at[idx].set``, a ``QuantizedKV`` write (copy-on-write) copies bit for
  bit; ``kv_block_nbytes`` and ``DECODE_QUANT_KEYS`` equal the reference's;
  ``quantize_decode_params`` leaves the experts untouched.
* ``xla_q8`` and both q8 attends against the reference's at rtol 1e-6.
* The int8 engines (KV, weights, both) token-exact with the JAX engine on
  the qwen3 toy (events, outputs, trace counts and pool stats equal):
  staggered requests with chunked prefill behind a shared prefix,
  preemption recompute, copy-on-write mid-block and spec-decode rollback
  (``tests/test_kv_quant.py:265-380``'s drills); the int8 pool's bytes and
  the capacity it buys at equal pool bytes.
* ``quality_stats`` equal to the reference's at rtol 1e-5 (``ppl_rel_delta``,
  the relative difference of two such perplexities, within 2e-5) and inside
  the pinned bounds on the qwen3, gpt_oss-like and qwen3_moe toys; a planted
  4x scale on one layer's ``down_proj`` fails the gate in both packages.
"""

import functools
import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import build_foundation_model
from veomni_tpu.ops import paged_attention as jpa
from veomni_tpu.ops import quantization as jq
from veomni_tpu.serving import quality as jquality
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models import decode as tdec
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.ops import paged_attention as tpa
from veomni_tpu_torch.ops import quantization as tq
from veomni_tpu_torch.serving import EngineConfig, InferenceEngine, quality as tquality
from test_torch_serving import _cow_script, _greedy, _loopy_prompts, _prompts, _staggered
from test_torch_serving import _system_prompts, drive, models
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
from quality_gate import PPL_REL_DELTA_BOUND, TOP_K, TOPK_OVERLAP_BOUND  # noqa: E402

T = torch.from_numpy
MODES = [("int8", "none"), ("none", "int8"), ("int8", "int8")]
MODE_IDS = ["kv", "weights", "both"]
# tests/test_kv_quant.py's GPT_OSS_ISH and QWEN3_MOE toys (the bounds'
# provenance, tests/tools/quality_gate.py:10-18)
GATE_TOYS = {
    "qwen3": dict(model_type="qwen3", vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, qk_norm=True),
    "gpt_oss_ish": dict(model_type="gpt_oss", vocab_size=128, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16, attention_sinks=True,
                        attention_bias=True, o_bias=True, sliding_window=8,
                        layer_types=["sliding_attention", "full_attention"] * 2,
                        hidden_act="gpt_oss_glu"),
    "qwen3_moe": dict(model_type="qwen3_moe", vocab_size=128, hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16, qk_norm=True, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=32),
}


@pytest.fixture(autouse=True, scope="module")
def _release_models():
    yield
    models.cache_clear()
    _gate_models.cache_clear()
    gc.collect()


def _rows(shape, seed=0, zero_rows=True):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3.0
    if zero_rows:
        x[0, 1] = 0.0
        x[-1, -1, 0] = 0.0
    return x


# ------------------------------------------------------------- the storage
def test_quantize_rows_and_weights_bit_equal_to_reference():
    x = _rows((3, 5, 4, 16))
    q_j, s_j = jq.quantize_rows(jnp.asarray(x))
    q_t, s_t = tq.quantize_rows(T(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert (s_t[0, 1] == 0).all() and (q_t[0, 1] == 0).all()
    np.testing.assert_array_equal(tq.dequantize_rows(q_t, s_t).numpy(),
                                  np.asarray(jq.dequantize_rows(q_j, s_j)))
    w = _rows((2, 48, 24), seed=1)
    w[1, :, 3] = 0.0  # a zero output channel
    wq_j = jq.quantize_weight(jnp.asarray(w))
    for layer in range(2):
        wq_t = tq.quantize_weight(T(w[layer]))
        assert np.array_equal(wq_t.data.numpy(), np.asarray(wq_j.data[layer]))
        assert np.array_equal(wq_t.scale.numpy(), np.asarray(wq_j.scale[layer]))


def test_quantized_kv_writes_and_copy_on_write_are_exact():
    shape = (2, 6, 4, 2, 16)
    rows = _rows((2, 3, 2, 16), seed=2)
    blocks, offs = np.array([[1, 4, 5], [2, 2, 3]]), np.array([[0, 3, 1], [2, 0, 3]])
    pool_j = jq.make_kv_pool(shape, "int8", jnp.float32)
    pool_t = tq.make_kv_pool(shape, "int8", torch.float32)
    for layer in range(2):
        pool_j = jq.QuantizedKV(*[
            a.at[layer].set(b) for a, b in zip(
                (pool_j.data, pool_j.scale),
                (lambda p: (p.data, p.scale))(pool_j[layer].at[blocks, offs].set(
                    jnp.asarray(rows[layer]))))])
        layer_pool = pool_t[layer]
        layer_pool[T(blocks), T(offs)] = T(rows[layer])
    assert np.array_equal(pool_t.data.numpy(), np.asarray(pool_j.data))
    assert np.array_equal(pool_t.scale.numpy(), np.asarray(pool_j.scale))
    assert pool_t.nbytes == pool_j.nbytes and pool_t.shape == tuple(pool_j.shape)
    before = (pool_t.data.clone(), pool_t.scale.clone())
    tdec.copy_block((pool_t,), src=4, dst=1)  # copy-on-write: bit for bit
    assert torch.equal(pool_t.data[:, 1], before[0][:, 4])
    assert torch.equal(pool_t.scale[:, 1], before[1][:, 4])
    assert torch.equal(pool_t.data[:, 4], before[0][:, 4])


@pytest.mark.parametrize("kv_quant,dtype_bytes", [("none", 4), ("none", 2), ("int8", 4)])
def test_kv_block_nbytes_equals_reference(kv_quant, dtype_bytes):
    args = (28, 16, 8, 128)
    assert tq.kv_block_nbytes(*args, kv_quant=kv_quant, dtype_bytes=dtype_bytes) == \
        jq.kv_block_nbytes(*args, kv_quant=kv_quant, dtype_bytes=dtype_bytes)
    with pytest.raises(NotImplementedError, match="only 'int8' ships"):
        tq.make_kv_pool((1, 2, 4, 1, 8), "fp8", torch.float32)


def test_quantize_decode_params_leaves_experts_untouched():
    assert tq.DECODE_QUANT_KEYS == jq.DECODE_QUANT_KEYS
    _, _, model, cfg = models("qwen3_moe")
    dense = tdec._compute_cast(model, cfg)
    quant = tdec._compute_cast(model, cfg, weight_quant="int8")
    for lp_d, lp_q in zip(dense["layers"], quant["layers"]):
        for name, w in lp_d.items():
            if name in tq.DECODE_QUANT_KEYS:
                assert isinstance(lp_q[name], tq.QuantizedWeight), name
            elif isinstance(w, torch.Tensor):
                assert torch.equal(lp_q[name], w), name
            else:  # the experts' namespace: the same tensors
                assert all(torch.equal(getattr(lp_q[name], n), t) for n, t in vars(w).items())
    for key in ("embed_tokens", "norm", "lm_head"):
        assert torch.equal(quant[key], dense[key])


def test_q8_matmul_and_attends_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = _rows((48, 24), seed=4, zero_rows=False)
    wq_j = jq.quantize_weight(jnp.asarray(w)[None])
    got = tq.decode_dot(T(x), tq.quantize_weight(T(w)))
    want = jq.decode_dot(jnp.asarray(x), jq.QuantizedWeight(wq_j.data[0], wq_j.scale[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    nb, bs, hkv, d, hq, s, t = 6, 4, 2, 16, 4, 2, 3
    k, v = _rows((nb, bs, hkv, d), seed=5, zero_rows=False), _rows((nb, bs, hkv, d), seed=6,
                                                                    zero_rows=False)
    pools_j = [jq.QuantizedKV(*jq.quantize_rows(jnp.asarray(a))) for a in (k, v)]
    pools_t = [tq.QuantizedKV(*tq.quantize_rows(T(a))) for a in (k, v)]
    q = rng.standard_normal((s, t, hq, d)).astype(np.float32)
    tables = np.array([[1, 3, 0], [2, 4, 5]])
    mask = np.arange(3 * bs)[None, None] <= (np.array([[5, 6, 7], [9, 10, 11]])[..., None])
    for jop, top in ((jpa.paged_attend, tpa.paged_attend),
                     (jpa.paged_prefill_attend, tpa.paged_prefill_attend)):
        want = jop(jnp.asarray(q), *pools_j, jnp.asarray(tables), jnp.asarray(mask),
                   num_rep=2, scale=d ** -0.5)
        got = top(T(q), *pools_t, T(tables), T(mask), num_rep=2, scale=d ** -0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    ctx_j = jpa.gather_block_kv_q8(*pools_j, jnp.asarray(tables), jnp.float32)
    ctx_t = tpa.gather_block_kv_q8(*pools_t, T(tables), torch.float32)
    for a, b in zip(ctx_t, ctx_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------- the int8 engines
def _quant(engine_kw, mode):
    return dict(engine_kw, kv_quant=mode[0], weight_quant=mode[1])


SCENARIOS = {
    "staggered_chunked": (dict(num_slots=2, block_size=8, max_model_len=96, prefill_chunk=8),
                          lambda: _staggered(_system_prompts(11, 19, (5, 9, 2, 13)), 2, 3,
                                             lambda i: _greedy(6))),
    "preemption": (dict(num_slots=3, block_size=8, max_model_len=40, num_blocks=8),
                   lambda: [("submit", p, _greedy(10)) for p in _prompts((9, 11, 7), seed=1)]
                   + [("drain",)]),
    "cow_mid_block": (dict(num_slots=2, block_size=8, max_model_len=64), _cow_script),
    "spec_rollback": (dict(num_slots=2, block_size=8, max_model_len=64, spec_k=3),
                      lambda: [("submit", p, _greedy(8))
                               for p in _loopy_prompts((9, 13, 5), seed=2)] + [("drain",)]),
}


# every mode on the staggered drill, both tiers on the others
DRILLS = [("staggered_chunked", m) for m in MODES] + [
    (s, ("int8", "int8")) for s in ("preemption", "cow_mid_block", "spec_rollback")]


@pytest.mark.parametrize("scenario,mode", DRILLS,
                         ids=[f"{s}-{MODE_IDS[MODES.index(m)]}" for s, m in DRILLS])
def test_int8_engine_matches_jax_engine(scenario, mode):
    engine_kw, script = SCENARIOS[scenario]
    kw = _quant(engine_kw, mode)
    want = drive("jax", "qwen3", kw, script())
    got = drive("torch", "qwen3", kw, script())
    for what, g, w in zip(("events", "outputs", "trace counts", "pool stats"), got, want):
        assert g == w, (what, g, w)
    stats = got[3]
    if scenario == "preemption":
        assert stats["preemptions"] > 0
    if scenario == "cow_mid_block":
        assert stats["cow"] >= 1
    if scenario == "spec_rollback":
        assert stats["metrics"]["spec_proposed"] > 0


def test_int8_pool_bytes_and_capacity_at_equal_pool_bytes():
    _, _, model, cfg = models("qwen3")
    ec = dict(num_slots=2, block_size=8, max_model_len=64)
    dense = InferenceEngine(model, cfg, EngineConfig(**ec), device="cpu")
    q8 = InferenceEngine(model, cfg, EngineConfig(kv_quant="int8", **ec), device="cpu")
    cap_f, cap_q = dense.kv_capacity(), q8.kv_capacity()
    assert cap_q["pool_bytes"] == q8.k_pool.nbytes + q8.v_pool.nbytes
    assert cap_q["block_bytes"] == tq.kv_block_nbytes(
        cfg.num_hidden_layers, 8, cfg.num_key_value_heads, cfg.head_dim, kv_quant="int8")
    per_seq = cap_f["blocks_per_max_len_seq"]
    q_seqs = (cap_f["pool_bytes"] // cap_q["block_bytes"] - 1) // per_seq
    assert q_seqs / cap_f["max_concurrent_seqs"] >= 1.8


# ------------------------------------------------------------ the quality gate
@functools.lru_cache(maxsize=None)
def _gate_models(name):
    jcfg = JaxConfig(dtype=jnp.float32, **GATE_TOYS[name])
    params = build_foundation_model(config=jcfg).family.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(dtype=torch.float32, **GATE_TOYS[name])
    model = Transformer(cfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, jcfg, model, cfg


def test_gate_bounds_are_the_repo_wide_pins():
    assert (tquality.PPL_REL_DELTA_BOUND, tquality.TOPK_OVERLAP_BOUND, tquality.TOP_K) == \
        (PPL_REL_DELTA_BOUND, TOPK_OVERLAP_BOUND, TOP_K)
    assert tquality.fixed_corpus(128) == jquality.fixed_corpus(128)


# every mode on the qwen3 toy, both tiers on the other two
GATE_CASES = [("qwen3", m) for m in MODES] + [(n, ("int8", "int8"))
                                              for n in ("gpt_oss_ish", "qwen3_moe")]


@pytest.mark.parametrize("name,mode", GATE_CASES,
                         ids=[f"{n}-{MODE_IDS[MODES.index(m)]}" for n, m in GATE_CASES])
def test_quality_stats_match_reference_and_hold_the_bounds(name, mode):
    params, jcfg, model, cfg = _gate_models(name)
    corpus = tquality.fixed_corpus(cfg.vocab_size)
    want = jquality.quality_stats(params, jcfg, corpus, kv_quant=mode[0], weight_quant=mode[1],
                                  top_k=TOP_K, block_size=8)
    got = tquality.assert_quality_gate(model, cfg, kv_quant=mode[0], weight_quant=mode[1],
                                       block_size=8)
    for key in ("ppl_ref", "ppl_quant", "topk_overlap"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    # the relative difference of two perplexities each within rtol 1e-5:
    # within 2e-5 absolute (it is ~1e-5..2e-4 itself, so a relative limit
    # would hold f32 rounding of the two ppl values to a few percent)
    np.testing.assert_allclose(got["ppl_rel_delta"], want["ppl_rel_delta"], rtol=0, atol=2e-5)


def test_wrong_scale_fails_the_gate_in_both_packages():
    """A 4x scale on layer 0's ``down_proj`` blows a bound in both packages."""
    params, jcfg, model, cfg = _gate_models("qwen3")
    corpus = tquality.fixed_corpus(cfg.vocab_size)
    qp = jq.quantize_decode_params(params)
    dp = qp["layers"]["down_proj"]
    broken_j = dict(qp, layers=dict(qp["layers"], down_proj=jq.QuantizedWeight(
        dp.data, dp.scale.at[0].multiply(4.0))))
    broken_t = tdec._compute_cast(model, cfg, weight_quant="int8")
    w = broken_t["layers"][0]["down_proj"]
    broken_t["layers"][0]["down_proj"] = tq.QuantizedWeight(w.data, w.scale * 4.0)
    dense_t = tdec._compute_cast(model, cfg)
    for package, ref_p, bad_p, score in (
            ("jax", params, broken_j, functools.partial(jquality.teacher_forced_logits, cfg=jcfg)),
            ("torch", dense_t, broken_t, functools.partial(tquality.teacher_forced_logits,
                                                           cfg=cfg))):
        q = jquality if package == "jax" else tquality
        nll_ref, nll_bad, overlaps = [], [], []
        for toks in corpus:
            ref, bad = score(ref_p, tokens=toks, block_size=8), score(bad_p, tokens=toks,
                                                                      block_size=8)
            nll_ref.append(np.log(q._ppl(ref, toks)))
            nll_bad.append(np.log(q._ppl(bad, toks)))
            overlaps.append(q._topk_overlap(ref, bad, TOP_K))
        ppl_ref, ppl_bad = np.exp(np.mean(nll_ref)), np.exp(np.mean(nll_bad))
        stats = {"ppl_ref": ppl_ref, "ppl_quant": ppl_bad,
                 "ppl_rel_delta": abs(ppl_bad - ppl_ref) / ppl_ref,
                 "topk_overlap": float(np.mean(overlaps))}
        assert tquality.gate_failures(stats), (package, stats)
