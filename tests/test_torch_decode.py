"""Port KV-cache decoding (``veomni_tpu_torch.models.decode``) vs the JAX reference.

f32 on the CPU, on the reference's serving toys ``QWEN3`` and ``QWEN3_MOE``
(``tests/test_serving.py``), the dense dialect toys ``GEMMA3`` (sliding
windows shorter than the prompts) and ``QWEN2`` (biases, llama3 rope
scaling), ``DEEPSEEK_MOE`` (a dense first layer, sigmoid group-limited
routing with a correction bias, a shared expert) and ``GPT_OSS``
(``tests/test_serving.py``'s ``GPT_OSS_ISH``: sinks, alternating 8-token
windows, q/k/v/o biases, the clamped GLU; with 4 experts at top-2, router
and expert biases), weights carried from JAX ``init_params`` (their
biases, sinks and norm weights drawn at random) by ``load_jax_params``;
inputs from numpy seeds.

* ``paged_prefill_step`` (a chunk after a cached prefix, null-padded table),
  ``paged_decode_step`` (an inactive slot included), ``paged_verify_step``,
  ``copy_block`` and ``scatter_prompt_cache`` against the JAX steps applied
  to the same pools: logits atol/rtol 1e-5, and the pools equal after each
  step within 1e-5 (the written rows are f32 products of either framework;
  the null block 0, which takes the padded rows' writes in no set order,
  is left out);
* ``greedy_generate`` token for token against the JAX one, greedy and
  sampled, with eos trimming, and against rescoring with the port's
  training forward;
* the threefry port bit for bit against ``jax.random`` (keys, splits, bits,
  uniforms; Gumbel noise within 1 ulp-scale of 1e-6; categorical draws
  equal), ``sample_tokens`` draws and keep thresholds against the
  reference's over mixes of temperature, top-k and top-p, and
  ``verify_accept``'s targets, ``n_emit`` and carries equal to JAX's;
* the prompt buckets keep ``TRACE_COUNTS`` flat as the reference's do, and
  the configs the port cannot decode raise.
"""

import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import build_foundation_model
from veomni_tpu.models import decode as jdec
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models import decode as tdec
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.ops import threefry
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

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
# the dense HF dialects at the same width: gemma3 with windows (8) that the
# prompts outgrow, dual rope, sandwich and zero-centered norms, embedding
# scale, GELU and softcap; qwen2 with q/k/v biases under llama3 rope scaling
GEMMA3 = dict(
    model_type="gemma3", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    qk_norm=True, norm_zero_centered=True, sandwich_norms=True, embed_scale=8.0,
    query_pre_attn_scalar=16, sliding_window=8, rope_local_base_freq=1e4, rope_theta=1e6,
    layer_types=["sliding_attention", "sliding_attention", "full_attention"],
    hidden_act="gelu_pytorch_tanh", final_logit_softcap=30.0, tie_word_embeddings=True,
)
QWEN2 = dict(
    model_type="qwen2", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, attention_bias=True,
    rope_theta=5e5, rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                  "high_freq_factor": 4.0,
                                  "original_max_position_embeddings": 16},
)
# the deepseek MoE pieces without MLA (the reference has no cached decode
# for MLA): a dense first layer, then sigmoid noaux-tc routing in 2 groups
# with a correction bias (drawn at random by ``perturb``) and a shared expert
DEEPSEEK_MOE = dict(
    model_type="deepseek_v3", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1,
    scoring_func="sigmoid", n_group=2, topk_group=1, routed_scaling_factor=1.5,
    first_k_dense_replace=1,
)
# tests/test_serving.py's GPT_OSS_ISH with 4 experts at top-2 and router and
# expert biases: the gpt_oss dialect's sinks, windows, routing and clamped GLU
GPT_OSS = dict(
    model_type="gpt_oss", vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    attention_sinks=True, attention_bias=True, o_bias=True, sliding_window=8,
    layer_types=["sliding_attention", "full_attention"] * 2, hidden_act="gpt_oss_glu",
    num_experts=4, num_experts_per_tok=2, router_bias=True, mlp_bias=True,
)
CONFIGS = {"qwen3": QWEN3, "qwen3_moe": QWEN3_MOE, "gemma3": GEMMA3, "qwen2": QWEN2,
           "deepseek_moe": DEEPSEEK_MOE, "gpt_oss": GPT_OSS}
TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy


def perturb(params, seed=0):
    """The init's biases and sinks (0) and norm weights (1) drawn at random,
    so that a misplaced one shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "bias" in name or name.endswith(("norm']", "sinks']")):
            x = np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def models(name):
    """(jax params, jax cfg, port model, port cfg) with the same weights."""
    jcfg = JaxConfig(dtype=jnp.float32, **CONFIGS[name])
    params = build_foundation_model(config=jcfg).family.init_params(jax.random.PRNGKey(0), jcfg)
    if name in ("gemma3", "qwen2", "deepseek_moe", "gpt_oss"):
        params = perturb(params)
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


def _assert_pools(jpools, tpools):
    for jp, tp in zip(jpools, tpools):
        np.testing.assert_allclose(tp[:, 1:].numpy(), np.asarray(jp)[:, 1:], **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_steps_match_jax(name):
    params, jcfg, model, cfg = models(name)
    compute = tdec._compute_cast(model, cfg)
    rng = np.random.default_rng(1)
    L, nb, bs, hkv, d = cfg.num_hidden_layers, 24, 4, cfg.num_key_value_heads, cfg.head_dim
    pools_np = [rng.standard_normal((L, nb, bs, hkv, d)).astype(np.float32) for _ in range(2)]
    jpools = tuple(jnp.asarray(p) for p in pools_np)
    tpools = tuple(T(p.copy()) for p in pools_np)

    # one chunk of 9 rows at positions 11..19 after a cached 11-row prefix,
    # through a 5-block table padded to 8 entries
    table = np.zeros(8, np.int32)
    table[:5] = [3, 7, 1, 12, 5]
    tokens = np.zeros(16, np.int32)
    tokens[:9] = _prompts((9,), seed=2)[0]
    # the JAX steps as compiled programs (the engine's form; faster on the
    # CPU than their op-by-op trace)
    want, jpools = jax.jit(lambda p, pools, t, tok: jdec.paged_prefill_step(
        p, jcfg, pools, t, 11, tok, 9, 16))(params, jpools, jnp.asarray(table),
                                            jnp.asarray(tokens))
    got = tdec.paged_prefill_step(compute, cfg, tpools, T(table).long(), 11, T(tokens).long(), 9,
                                  16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools(jpools, tpools)

    # decode over three slots: two live (one mid-block, one on a block
    # edge) and one inactive (null table, position 0)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :5 - 1] = [3, 7, 1, 12]
    tables[1, :2] = [9, 14]
    positions = np.array([14, 4, 0], np.int32)
    tok = np.array([17, 99, 0], np.int32)
    want, jpools = jax.jit(lambda p, pools, *a: jdec.paged_decode_step(p, jcfg, pools, *a))(
        params, jpools, jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(tok))
    got = tdec.paged_decode_step(compute, cfg, tpools, T(tables).long(), T(positions).long(),
                                 T(tok).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools(jpools, tpools)

    # verify: 4 candidate rows per slot, 1, 3 and 4 of them real
    vt = np.array(_prompts((4, 4, 4), seed=3), np.int32)
    n_input = np.array([1, 3, 4], np.int32)
    vtables = np.zeros((3, 8), np.int32)
    vtables[0, :5] = [3, 7, 1, 12, 5]
    vtables[1, :2] = [9, 14]
    vtables[2, :3] = [16, 18, 20]
    vpos = np.array([15, 5, 8], np.int32)
    want, jpools = jax.jit(lambda p, pools, *a: jdec.paged_verify_step(p, jcfg, pools, *a))(
        params, jpools, jnp.asarray(vtables), jnp.asarray(vpos), jnp.asarray(vt),
        jnp.asarray(n_input))
    got = tdec.paged_verify_step(compute, cfg, tpools, T(vtables).long(), T(vpos).long(),
                                 T(vt).long(), T(n_input).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools(jpools, tpools)

    # copy-on-write of one block, then a contiguous prompt cache scattered in
    jpools = jdec.copy_block(jpools, 12, 21)
    tdec.copy_block(tpools, 12, 21)
    _assert_pools(jpools, tpools)
    prompt = _prompts((13,), seed=4)[0]
    ptoks = np.zeros((1, 16), np.int32)
    ptoks[0, :13] = prompt
    jl, jcaches = jax.jit(lambda p, t: jdec._prefill_impl(p, jcfg, t, 13, 16, 16))(
        params, jnp.asarray(ptoks))
    tl, tcaches = tdec._prefill_impl(compute, cfg, T(ptoks).long(), 13, 16, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    ids = np.array([22, 23, 2, 0], np.int32)  # 4 blocks of 4, the last a pad
    jpools = jdec.scatter_prompt_cache(jpools, jcaches, jnp.asarray(ids))
    tdec.scatter_prompt_cache(tpools, tcaches, T(ids).long())
    _assert_pools(jpools, tpools)


def test_step_pools_written_in_place():
    _, _, model, cfg = models("qwen3")
    compute = tdec._compute_cast(model, cfg)
    pools = tuple(torch.zeros(cfg.num_hidden_layers, 6, 4, 2, 16) for _ in range(2))
    ptrs = [p.data_ptr() for p in pools]
    tdec.paged_decode_step(compute, cfg, pools, torch.tensor([[1, 2]]), torch.tensor([5]),
                           torch.tensor([7]))
    assert [p.data_ptr() for p in pools] == ptrs
    assert pools[0][:, 2, 1].abs().sum() > 0  # position 5 = block 2, row 1


SAMPLINGS = {"greedy": dict(), "topk-topp": dict(temperature=0.8, top_k=10, top_p=0.9, seed=3),
             "topp": dict(temperature=1.1, top_p=0.7, seed=5),
             "topk-over-vocab": dict(temperature=0.7, top_k=10_000, seed=1)}


# the sampler does not depend on the model: the deepseek toy runs greedy and
# one sampled mix, the gpt_oss toy greedy (the time the suite can spare)
@pytest.mark.parametrize("sampling,name", [
    pytest.param(SAMPLINGS[sid], name, id=f"{sid}-{name}")
    for sid in SAMPLINGS for name in sorted(CONFIGS)
    if (name != "deepseek_moe" or sid in ("greedy", "topk-topp"))
    and (name != "gpt_oss" or sid == "greedy")])
def test_greedy_generate_matches_jax(name, sampling):
    params, jcfg, model, cfg = models(name)
    for prompt in _prompts((5, 13, 20), seed=7):
        want = jdec.greedy_generate(params, jcfg, prompt, max_new_tokens=7, **sampling)
        assert tdec.greedy_generate(model, cfg, prompt, max_new_tokens=7, **sampling) == want


def test_greedy_generate_eos_and_rescoring():
    """eos trims after its first occurrence as in the reference; greedy
    tokens equal argmax rescoring through the port's training forward."""
    params, jcfg, model, cfg = models("qwen3")
    prompt = _prompts((9,), seed=5)[0]
    full = tdec.greedy_generate(model, cfg, prompt, max_new_tokens=8)
    eos = full[len(prompt) + 3]
    assert (tdec.greedy_generate(model, cfg, prompt, max_new_tokens=8, eos_id=eos)
            == jdec.greedy_generate(params, jcfg, prompt, max_new_tokens=8, eos_id=eos)
            == full[: full.index(eos, len(prompt)) + 1])
    with torch.no_grad():
        ids = torch.tensor([full])
        hidden, _ = model.forward_hidden(ids, torch.arange(len(full))[None])
        logits = hidden @ model.lm_head_kernel()
    assert logits[0, len(prompt) - 1:-1].argmax(-1).tolist() == full[len(prompt):]


def test_prompt_bucketing_keeps_counts_flat():
    """Prompt lengths 5/6/7 share the prompt bucket (16) and the cache
    bucket: one prefill and one decode shape, as in the reference."""
    params, jcfg, model, cfg = models("qwen3")
    # configs of their own: each package keeps its programs per config
    jcfg, cfg = dataclasses.replace(jcfg), dataclasses.replace(cfg)
    prompt = _prompts((9,), seed=2)[0]
    jbase, tbase = dict(jdec.TRACE_COUNTS), dict(tdec.TRACE_COUNTS)
    for n in (5, 6, 7):
        assert (tdec.greedy_generate(model, cfg, prompt[:n], max_new_tokens=6)
                == jdec.greedy_generate(params, jcfg, prompt[:n], max_new_tokens=6))
    for key in ("prefill", "decode"):
        assert tdec.TRACE_COUNTS[key] - tbase[key] == jdec.TRACE_COUNTS[key] - jbase[key]
    assert tdec.TRACE_COUNTS["prefill"] - tbase["prefill"] == 1


def test_threefry_matches_jax_random():
    from jax._src import prng

    seeds = (0, 1, 7, 123456, 2**31 - 1, -5)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
    assert (np.stack([threefry.prng_key(s) for s in seeds]) == keys).all()
    split = np.stack([np.asarray(jax.random.split(k, 3)) for k in keys])
    assert (threefry.split(keys, 3).numpy() == split).all()
    bits = np.stack([np.asarray(prng.threefry_random_bits(jnp.asarray(k), 32, (1001,)))
                     for k in keys])
    assert (threefry.random_bits(keys, 1001).numpy() == bits).all()
    tiny = np.finfo(np.float32).tiny
    uni = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (1001,), minval=tiny))
                    for k in keys])
    assert (threefry.uniform_low(keys, 1001).numpy() == uni).all()
    gum = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (1001,))) for k in keys])
    np.testing.assert_allclose(threefry.gumbel(keys, 1001).numpy(), gum, rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(0).standard_normal((len(seeds), 1001)).astype(np.float32)
    draws = jax.vmap(lambda k, r: jax.random.categorical(k, r))(jnp.asarray(keys),
                                                               jnp.asarray(logits))
    assert (threefry.categorical(threefry.as_keys(keys), T(logits)).numpy()
            == np.asarray(draws)).all()


# one row per mix: (temperature, top_k, top_p)
MIXES = np.array([(0.0, 0, 1.0), (0.7, 5, 0.9), (1.0, 0, 0.5), (1.3, 50, 1.0),
                  (0.5, 1, 0.3), (2.0, 200, 0.95), (0.9, 0, 1e-6), (0.8, 3, 1.0)])


def _mix(rows):
    temps = MIXES[:rows, 0].astype(np.float32)
    top_ks = MIXES[:rows, 1].astype(np.int32)
    top_ps = MIXES[:rows, 2].astype(np.float32)
    return temps, top_ks, top_ps


def _jax_keep_threshold(l, top_k, top_p):
    """The reference's keep threshold, ``sample_tokens`` lines ``:695-702``."""
    v = l.shape[-1]
    sl = jnp.sort(l, axis=-1)[..., ::-1]
    k_idx = jnp.clip(jnp.where(top_k > 0, top_k, v), 1, v) - 1
    in_k = jnp.arange(v)[None] <= k_idx[:, None]
    p = jax.nn.softmax(jnp.where(in_k, sl, -jnp.inf), axis=-1)
    cum = jnp.cumsum(p, axis=-1)
    keep = in_k & ((cum - p) < top_p[:, None])
    nkeep = jnp.maximum(keep.sum(-1), 1)
    return jnp.take_along_axis(sl, (nkeep - 1)[:, None], axis=-1)


def test_sample_tokens_matches_jax():
    rng = np.random.default_rng(3)
    rows = len(MIXES)
    temps, top_ks, top_ps = _mix(rows)
    logits = (rng.standard_normal((rows, 128)) * 3).astype(np.float32)
    l = logits / np.maximum(temps, 1e-6)[:, None]
    thresh = np.asarray(_jax_keep_threshold(jnp.asarray(l), jnp.asarray(top_ks),
                                            jnp.asarray(top_ps)))
    got = tdec.keep_threshold(T(l), T(top_ks).long(), T(top_ps))
    np.testing.assert_array_equal(got.numpy(), thresh)
    args_t = (T(temps), T(top_ks).long(), T(top_ps))
    args_j = (jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
    for trial in range(16):
        keys = np.stack([np.asarray(jax.random.PRNGKey(100 * trial + i)) for i in range(rows)])
        want = np.asarray(jdec.sample_tokens(jnp.asarray(logits), jnp.asarray(keys), *args_j))
        got = tdec.sample_tokens(T(logits), threefry.as_keys(keys), *args_t).numpy()
        np.testing.assert_array_equal(got, want)
        # every draw lies in its row's keep-set; greedy rows are the argmax
        assert (l[np.arange(rows), got] >= thresh[:, 0]).all()
        assert got[0] == logits[0].argmax()


def test_nucleus_and_select_token_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    # the reference's nucleus mask is the port's keep threshold with no top-k
    for top_p in (0.2, 0.6, 0.95):
        l = T(logits)
        thresh = tdec.keep_threshold(l, torch.zeros(3, dtype=torch.long), torch.full((3,), top_p))
        np.testing.assert_array_equal(
            l.masked_fill(l < thresh, float("-inf")).numpy(),
            np.asarray(jdec._nucleus_mask(jnp.asarray(logits), top_p)))
    key = np.asarray(jax.random.PRNGKey(9))
    for temperature, top_k, top_p in ((0.0, 0, 1.0), (0.8, 10, 0.9), (1.2, 0, 0.5),
                                      (0.6, 200, 1.0)):
        want = jdec._select_token(jnp.asarray(logits), jnp.asarray(key), temperature, top_k, top_p)
        got = tdec._select_token(T(logits), threefry.as_keys(key), temperature, top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_requires_keys_on_the_logits_device():
    """The draw hashes every logit: keys elsewhere (host numpy words, or a
    tensor on another device) raise instead of hashing on the host."""
    logits = torch.zeros(2, 8)
    key = threefry.prng_key(0)
    with pytest.raises(ValueError, match="the host"):
        threefry.categorical(key, logits)
    with pytest.raises(ValueError, match="meta"):
        threefry.categorical(threefry.as_keys(key), logits.to("meta"))
    assert threefry.categorical(threefry.as_keys(key), logits).shape == (2,)


@pytest.mark.parametrize("kb", [1, 2, 4])
def test_verify_accept_matches_jax(kb):
    rng = np.random.default_rng(kb)
    s, v = 6, 64
    temps, top_ks, top_ps = _mix(s)
    logits = (rng.standard_normal((s, kb, v)) * 2).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(40 + i)) for i in range(s)])
    n_input = np.array([1, kb, kb, max(1, kb - 1), kb, kb], np.int32)
    args_j = (jnp.asarray(keys), jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
    # drafts that equal the targets on some slots and break off on others
    probe = np.zeros((s, kb), np.int32)
    targets, _, _ = jdec.verify_accept(jnp.asarray(logits), jnp.asarray(probe),
                                       jnp.asarray(n_input), *args_j)
    tokens = np.zeros((s, kb), np.int32)
    tokens[:, 1:] = np.asarray(targets)[:, :-1]
    if kb > 2:
        tokens[2, 2] = (tokens[2, 2] + 1) % v  # reject from the second draft on
    want = jdec.verify_accept(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(n_input),
                              *args_j)
    got = tdec.verify_accept(T(logits), T(tokens).long(), T(n_input).long(),
                             threefry.as_keys(keys), T(temps), T(top_ks).long(), T(top_ps))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unsupported_configs_raise():
    with pytest.raises(ValueError, match="cached-decode"):
        tdec.check_decode_supported(TransformerConfig(
            model_type="deepseek_v3", vocab_size=64, hidden_size=64, num_hidden_layers=1,
            num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
            v_head_dim=8))
    # sliding windows and biases are ported (tests/test_torch_dialects.py),
    # the deepseek MoE pieces without MLA (sigmoid and group-limited
    # routing, shared experts, leading dense layers), gpt_oss, the
    # offloading remat, chunk_mbs and the async Ulysses chunks (training
    # knobs the decode path does not read); the output gate is not
    tdec.check_decode_supported(TransformerConfig(**DEEPSEEK_MOE))
    for extra in (dict(remat_policy="offload"), dict(chunk_mbs=64),
                  dict(ulysses_async_chunks=2)):
        tdec.check_decode_supported(TransformerConfig(**{**QWEN3, **extra}))
    with pytest.raises(NotImplementedError, match="not ported"):
        tdec.check_decode_supported(TransformerConfig(**{**QWEN3, **QWEN3_MOE,
                                                         "attn_output_gate": True}))
