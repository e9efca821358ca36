"""The deepseek MoE dialect of the port's model (MLA, sigmoid noaux-tc and
group-limited routing, shared experts, leading dense layers) against the
JAX package, on the CPU, at toy sizes.

* ``route_tokens`` in its four dialect branches (softmax, softmax with the
  deepseek_v2 max-per-group mask, sigmoid noaux-tc with a correction bias,
  sigmoid with the deepseek_v3 top-2-sum-per-group mask), on random and on
  tie-heavy routers at ``n_group`` 4: expert indices equal, weights and aux
  loss within 1e-6.
* The rope tables (both layouts, yarn included) and the interleaved
  rotation: rtol 1e-5.
* MLA attention, with and without ``q_lora_rank`` and with yarn, against
  the reference's ``_mla_attention`` given the same tables: rtol 1e-5.
* The whole model: a deepseek_v3 toy (q low-rank pair, sigmoid routing in
  2 groups, a shared expert, a leading dense layer, a nonzero correction
  bias) and a deepseek_v2 toy (no q low-rank pair, yarn, softmax routing in
  2 groups, no renorm): f32 loss rtol 1e-5 and every gradient leaf within
  1e-5 of its largest magnitude against ``loss_fn``, through the plain
  attention and through the ``cuda_flash`` wrapper (MLA's v head dim takes
  the reference's dispatch to the plain attention, counted); bf16 loss rtol
  1e-3. The reference builds the MLA rope from the concatenated-halves
  tables (ROADMAP.md queue 3); the port's interleaved tables are its
  ``rotary_tables(..., interleaved=True)``, so the JAX side here runs with
  those tables (``_repaired_rope``). ``tests/test_torch_deepseek_hf_io.py``
  holds the port to HF transformers' deepseek itself.
* The MoE MLP with shared experts, sigmoid-gated or not, against the
  reference's ``_moe_mlp``: rtol 1e-5.
* One AdamW step with weight decay through ``build_train_step`` against the
  reference's optax step: the correction bias (no gradient: it reaches the
  loss only through the expert choice) shrinks alike (rtol 5e-7).
* The blockwise attention at a v head dim other than q's (the reference
  raises there, ROADMAP.md queue 3) against the dense one and the
  reference's dense one: rtol 1e-5.
* ``FlopsCounter`` equal to the reference's for Moonlight-16B-A3B and
  DeepSeek-V2-Lite, and the feature gate admitting the five features.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veomni_tpu.ops as jops
from veomni_tpu.data.data_collator import TextPackingCollator
from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu.ops.attention import _attention_dense as j_attention_dense
from veomni_tpu.ops.attention import _attention_xla_chunked as j_attention_chunked
from veomni_tpu.ops.rotary import _apply_rotary_xla as j_apply_rotary
from veomni_tpu.ops.rotary import rotary_tables as j_rotary_tables
from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.utils.count_flops import FlopsCounter as JaxFlopsCounter
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.models.transformer import check_supported, route_tokens
from veomni_tpu_torch.ops.attention import (_attention_dense, _attention_xla,
                                             _attention_xla_chunked)
from veomni_tpu_torch.ops.cuda import flash_attention as fa
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from veomni_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.train import build_train_state, build_train_step
from veomni_tpu_torch.train_text_step import HF_CONFIGS
from veomni_tpu_torch.utils.count_flops import FlopsCounter
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy
RTOL = 1e-5
YARN = {"type": "yarn", "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1}
# tests/test_hf_parity.py's DIMS and deepseek toys, each with a leading
# dense layer, a shared expert and routing in 2 groups
DIMS = dict(vocab_size=257, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
            tie_word_embeddings=False, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, num_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, n_shared_experts=1, n_group=2, topk_group=1,
            first_k_dense_replace=1, rope_interleave=True, router_aux_loss_coef=0.01)
TOYS = {
    "deepseek_v3": dict(DIMS, model_type="deepseek_v3", q_lora_rank=24, scoring_func="sigmoid",
                        norm_topk_prob=True, routed_scaling_factor=1.5),
    "deepseek_v2": dict(DIMS, model_type="deepseek_v2", scoring_func="softmax",
                        norm_topk_prob=False, rope_scaling=YARN),
}


def _rng(seed=0):
    return np.random.default_rng(seed)


@contextlib.contextmanager
def _repaired_rope():
    """The reference's ``forward_hidden`` with the interleaved rope tables
    its MLA rotation pairs with (ROADMAP.md queue 3)."""
    orig = jops.rotary_tables
    jops.rotary_tables = functools.partial(orig, interleaved=True)
    try:
        yield
    finally:
        jops.rotary_tables = orig


# ---------------------------------------------------------------------------
# route_tokens
# ---------------------------------------------------------------------------
ROUTERS = {
    "softmax": dict(scoring_func="softmax", n_group=0, topk_group=0),
    "softmax-groups": dict(scoring_func="softmax", n_group=4, topk_group=2,
                           norm_topk_prob=False),
    "sigmoid": dict(scoring_func="sigmoid", n_group=1, topk_group=1, routed_scaling_factor=2.5),
    "sigmoid-groups": dict(scoring_func="sigmoid", n_group=4, topk_group=2,
                           routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("router_kind", ["random", "few-values"])
@pytest.mark.parametrize("dialect", list(ROUTERS))
def test_route_tokens_match_jax(dialect, router_kind):
    rng = _rng(3)
    e, k, h = 16, 4, 32
    x = rng.standard_normal((128, h)).astype(np.float32)
    if router_kind == "random":
        router = (rng.standard_normal((h, e)) * 0.2).astype(np.float32)
        bias = (rng.standard_normal(e) * 0.05).astype(np.float32)
    else:
        # x @ router takes at most 3 values per token and the bias 2: ties
        # inside groups, across groups and across the top k
        cols = (rng.standard_normal((h, 3)) * 0.2).astype(np.float32)
        router = cols[:, rng.integers(0, 3, e)]
        bias = np.where(rng.random(e) < 0.5, 0.0, 0.05).astype(np.float32)
    fields = dict(DIMS, num_experts=e, num_experts_per_tok=k, hidden_size=h, **ROUTERS[dialect])
    lp = {"router": jnp.asarray(router), "e_score_correction_bias": jnp.asarray(bias)}
    idx_j, w_j, aux_j = jtf.route_tokens(jnp.asarray(x), lp, JaxConfig(dtype=jnp.float32,
                                                                       **fields))
    idx_t, w_t, aux_t = route_tokens(T(x), T(router), TransformerConfig(dtype=torch.float32,
                                                                        **fields), T(bias))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("gated", [False, True], ids=["shared", "gated-shared"])
def test_moe_mlp_with_shared_experts_matches_jax(gated):
    """The MoE MLP with sigmoid group-limited routing and shared experts of
    an explicit width, plain or under the qwen2-moe style sigmoid gate,
    against the reference's ``_moe_mlp`` (f32, rtol 1e-5)."""
    from types import SimpleNamespace

    from veomni_tpu_torch.models.transformer import moe_mlp

    rng = _rng(6)
    t, h, e, im, si = 96, 32, 8, 16, 24
    fields = dict(DIMS, hidden_size=h, num_experts=e, moe_intermediate_size=im,
                  shared_expert_intermediate_size=si, shared_expert_gated=gated,
                  scoring_func="sigmoid", routed_scaling_factor=2.0)

    def draw(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = draw(t, h, scale=1.0)
    lp = {"router": draw(h, e), "e_score_correction_bias": draw(e, scale=0.05),
          "experts": {"gate_proj": draw(e, h, im), "up_proj": draw(e, h, im),
                      "down_proj": draw(e, im, h)},
          "shared_experts": {"gate_proj": draw(h, si), "up_proj": draw(h, si),
                             "down_proj": draw(si, h)}}
    if gated:
        lp["shared_expert_gate"] = draw(h, 1)
    want, aux_j = jtf._moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                               JaxConfig(dtype=jnp.float32, **fields))

    def ns(tree):
        return SimpleNamespace(**{k: T(v) for k, v in tree.items()})

    got, aux_t = moe_mlp(T(x), T(lp["router"]), ns(lp["experts"]),
                         TransformerConfig(dtype=torch.float32, **fields),
                         correction_bias=T(lp["e_score_correction_bias"]),
                         shared=ns(lp["shared_experts"]),
                         shared_gate=T(lp["shared_expert_gate"]) if gated else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)


# ---------------------------------------------------------------------------
# rope: the tables and the interleaved rotation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rope_scaling", [None, YARN], ids=["plain", "yarn"])
@pytest.mark.parametrize("interleaved", [False, True], ids=["halves", "interleaved"])
def test_interleaved_rotary_matches_jax(interleaved, rope_scaling):
    rng = _rng(1)
    pos = rng.integers(0, 300, (2, 24))
    cos_j, sin_j = j_rotary_tables(jnp.asarray(pos), 8, 10000.0, rope_scaling=rope_scaling,
                                   interleaved=interleaved)
    cos_t, sin_t = rotary_tables(T(pos), 8, 10000.0, rope_scaling=rope_scaling,
                                 interleaved=interleaved)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=RTOL, atol=1e-6)
    q = rng.standard_normal((2, 24, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 24, 1, 8)).astype(np.float32)
    want = j_apply_rotary(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j, interleaved=True)
    got = apply_rotary(T(q), T(k), cos_t, sin_t, interleaved=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)


def test_mla_rope_depends_on_the_position_difference_alone():
    """The port's MLA q.k under its rope is a function of (query position -
    key position): shifting both positions leaves it unchanged. (The
    reference's concatenated-halves tables under the interleaved rotation
    do not have this property: ROADMAP.md queue 3.)"""
    rng = _rng(2)
    q = T(rng.standard_normal((1, 1, 1, 8)).astype(np.float32))
    k = T(rng.standard_normal((1, 1, 1, 8)).astype(np.float32))

    def dot(pq, pk):
        cq, sq = rotary_tables(torch.tensor([[pq]]), 8, 10000.0, interleaved=True)
        ck, sk = rotary_tables(torch.tensor([[pk]]), 8, 10000.0, interleaved=True)
        return (apply_rotary(q, q, cq, sq, True)[0] * apply_rotary(k, k, ck, sk, True)[0]).sum()

    for shift in (7, 100):
        np.testing.assert_allclose(dot(5 + shift, 2 + shift).item(), dot(5, 2).item(), rtol=1e-5)


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("toy,rope_scaling", [("deepseek_v3", None), ("deepseek_v2", None),
                                               ("deepseek_v2", YARN)],
                         ids=["q_lora", "no_q_lora", "no_q_lora-yarn"])
def test_mla_attention_matches_jax(toy, rope_scaling):
    """Layer 1 (the first MoE layer) of each toy: the deepseek_v3 one has a
    q low-rank pair, the deepseek_v2 one none."""
    jcfg, params, model = models(toy, rope_scaling=rope_scaling)
    rng = _rng(4)
    b, s = 2, 32
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    seg = np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 3]], np.int32), s // 4, axis=1)
    pos = np.tile(np.arange(s), (b, 1))
    cos, sin = rotary_tables(T(pos), 8, jcfg.rope_theta, rope_scaling=rope_scaling,
                             interleaved=True)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    # the reference's layer norms its input before _mla_attention, the port's MLA in it
    x_normed = jtf._norm(jnp.asarray(x), lp["input_layernorm"], jcfg)
    want = jtf._mla_attention(x_normed, lp, jcfg, jnp.asarray(cos.numpy()),
                              jnp.asarray(sin.numpy()), jnp.asarray(seg), None)
    layer = model.layers[1]
    with torch.no_grad():
        q, k, v = layer._mla_qkv(T(x), cos, sin)
        assert q.shape[-1] == k.shape[-1] == 24 and v.shape[-1] == 16
        got = layer._linear(layer._attend(q, k, v, T(seg)).reshape(b, s, -1), "o_proj")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the model: loss and gradients against the JAX loss_fn
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params(toy):
    """The reference's parameter tree for ``toy``, its structure traced from
    ``init_params`` (``jax.eval_shape``: the eager init takes ~20 s on one
    core), its leaves drawn from numpy: matrices N(0, 0.05), norm weights
    1 + N(0, 0.2), correction biases N(0, 0.1) (the init's 1 and 0 would
    hide a misplaced norm or a bias left out of the expert choice)."""
    jcfg = JaxConfig(dtype=jnp.float32, **TOYS[toy])
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    rng = _rng(0)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(x.shape).astype(np.float32)
        if name.endswith("norm']"):
            return jnp.asarray(1 + 0.2 * z)
        return jnp.asarray((0.1 if "bias" in name else 0.05) * z)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def models(toy, dtype="float32", remat_policy="ctx", **extra):
    """(JAX config, JAX params, the port's model with the same weights)."""
    fields = {**TOYS[toy], **extra}
    jcfg = JaxConfig(dtype=getattr(jnp, dtype), **fields)
    params = _jax_params(toy)
    tcfg = TransformerConfig(dtype=getattr(torch, dtype), remat_policy=remat_policy, **fields)
    model = Transformer(tcfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def batch(seed=0, b=2, s=64):
    rng = _rng(seed)
    docs = [{"input_ids": rng.integers(0, DIMS["vocab_size"], int(n))}
            for n in rng.integers(20, 60, 5)]
    return TextPackingCollator(s, b)(docs)


def _assert_grads_close(got, ref, rel_to_max, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for key in ref:
            _assert_grads_close(got[key], ref[key], rel_to_max, f"{path}/{key}")
        return
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel_to_max * np.abs(ref).max(),
                               err_msg=path)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(toy, dtype):
    jcfg, params, _ = models(toy, dtype)
    loss = functools.partial(jtf.loss_fn, cfg=jcfg,
                             batch={k: jnp.asarray(v) for k, v in batch().items()})
    with _repaired_rope():
        (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return (float(loss_j), float(metrics_j["moe_aux_loss"]), int(metrics_j["ntokens"]),
            jax.tree.map(np.asarray, grads_j))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_results():
    yield
    _jax_loss_grads.cache_clear()
    _jax_params.cache_clear()


@pytest.mark.parametrize("attention_impl,remat_policy",
                         [("xla", "ctx"), ("cuda_flash", "nothing")],
                         ids=["plain-ctx", "flash-nothing"])
@pytest.mark.parametrize("toy", list(TOYS))
def test_loss_and_grads_match_jax(toy, attention_impl, remat_policy):
    _, _, model = models(toy, remat_policy=remat_policy)
    loss_j, aux_j, ntokens_j, grads_j = _jax_loss_grads(toy, "float32")
    fa.reset_counts()
    apply_ops_config({"attention": attention_impl})
    try:
        loss_t, metrics_t = model.loss_fn({k: T(v) for k, v in batch().items()})
        loss_t.backward()
    finally:
        apply_ops_config(None)
    assert int(metrics_t["ntokens"]) == ntokens_j
    # through cuda_flash every MLA layer is one dispatch to the plain
    # attention, two under remat "nothing" (backward reruns the forward)
    assert fa.FALLBACK_CALLS == (6 if attention_impl == "cuda_flash" else 0)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=RTOL)
    np.testing.assert_allclose(metrics_t["moe_aux_loss"].item(), aux_j, rtol=RTOL)
    grads_t = to_jax_tree(model, grads=True)
    assert set(grads_t) == {"embed_tokens", "norm", "lm_head", "dense_layers", "layers"}
    _assert_grads_close(grads_t, grads_j, RTOL)


@pytest.mark.parametrize("toy", list(TOYS))
def test_bf16_loss_matches_jax(toy):
    jcfg, params, model = models(toy, "bfloat16")
    data = batch()
    with _repaired_rope():
        loss_j, _ = jax.jit(functools.partial(jtf.loss_fn, cfg=jcfg))(
            params, batch={k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        loss_t, _ = model.loss_fn({k: T(v) for k, v in data.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-3)


def test_adamw_decays_the_correction_bias_like_optax():
    """The correction bias has no gradient; optax decays every leaf of the
    gradient tree all the same. One AdamW step of lr 1e-2 and weight decay
    0.5: the port's train step against the reference's optax update of the
    same (token-normalized) gradients. The biases agree to rtol 5e-7 and
    have shrunk by the decay (a bias the optimizer skipped would not)."""
    import optax

    _, params, model = models("deepseek_v3", remat_policy="nothing")
    _, _, ntokens, grads_j = _jax_loss_grads("deepseek_v3", "float32")
    lr, wd = 1e-2, 0.5
    schedule = build_lr_scheduler(lr=lr, train_steps=1)
    j_opt = j_build_optimizer(params, lr=j_build_lr_scheduler(lr=lr, train_steps=1),
                              weight_decay=wd)

    @jax.jit
    def optax_step(grads, params):
        updates, _ = j_opt.update(jax.tree.map(lambda g: g / ntokens, grads), j_opt.init(params),
                                  params)
        return optax.apply_updates(params, updates)["layers"]["e_score_correction_bias"]

    want = np.asarray(optax_step(grads_j, params))
    state = build_train_state(model, build_optimizer(model, lr=schedule, weight_decay=wd))
    build_train_step(Transformer.loss_fn)(state, {k: T(v)[None] for k, v in batch().items()})
    got = to_jax_tree(model)["layers"]["e_score_correction_bias"]
    before = np.asarray(params["layers"]["e_score_correction_bias"])
    np.testing.assert_allclose(got, want, rtol=5e-7)
    assert schedule(0) > 0
    np.testing.assert_allclose(got, before * (1 - schedule(0) * wd), rtol=5e-7)


# ---------------------------------------------------------------------------
# the blockwise attention at an asymmetric v head dim
# ---------------------------------------------------------------------------
def test_chunked_attention_takes_v_head_dim(monkeypatch):
    """MLA's v head dim (16 here, 128 in Moonlight) differs from q/k's (24,
    192): the port's blockwise path keeps V's own, where the reference's
    raises a TypeError. Held, f32, rtol 1e-5, to the port's dense path and
    the reference's dense one; through ``_attention_xla`` above a threshold
    lowered to 256, and blockwise on 128-token blocks (3 x 3)."""
    rng = _rng(5)
    b, s, h = 1, 384, 2
    q = rng.standard_normal((b, s, h, 24)).astype(np.float32)
    k = rng.standard_normal((b, s, h, 24)).astype(np.float32)
    v = rng.standard_normal((b, s, h, 16)).astype(np.float32)
    seg = np.repeat(np.array([[1, 2, 2, 3]], np.int32), s // 4, axis=1)
    want = np.asarray(j_attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(seg), True, 0.2))
    with pytest.raises(TypeError):  # the reference's fault, left as it is
        j_attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
                            True, 0.2, q_chunk=128, k_chunk=128)
    dense = _attention_dense(T(q), T(k), T(v), T(seg), True, 0.2)
    blocks = _attention_xla_chunked(T(q), T(k), T(v), T(seg), True, 0.2,
                                          q_chunk=128, k_chunk=128)
    monkeypatch.setenv("VEOMNI_ATTN_CHUNK_THRESHOLD", "256")
    above = _attention_xla(T(q), T(k), T(v), T(seg), True, 0.2)
    for got in (dense, blocks, above):
        assert got.shape == (b, s, h, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the flops counter and the feature gate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("preset", ["moonlight_16b_a3b", "deepseek_v2_lite"])
def test_flops_match_jax(preset):
    tcfg = TransformerConfig.from_hf_config(HF_CONFIGS[preset])
    jcfg = JaxConfig.from_hf_config(HF_CONFIGS[preset])
    for seq in (4096, 333):
        np.testing.assert_allclose(FlopsCounter.from_config(tcfg).flops_per_token_fwd(seq),
                                   JaxFlopsCounter.from_config(jcfg).flops_per_token_fwd(seq),
                                   rtol=1e-12)


@pytest.mark.parametrize("extra", [
    dict(scoring_func="sigmoid"), dict(n_group=4, topk_group=2),
    dict(n_shared_experts=1), dict(first_k_dense_replace=1),
    dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8),
], ids=["sigmoid", "group-limited", "shared-experts", "first-k-dense", "mla"])
def test_ported_features_pass_the_gate(extra):
    check_supported(TransformerConfig(**{**DIMS, "kv_lora_rank": 0, **extra}))
