"""The dense HF dialects of the port's model (llama + rope scaling, qwen2
biases, gemma3) against the JAX package, on the CPU, at toy sizes.

* Loss and every gradient leaf against
  ``veomni_tpu.models.transformer.loss_fn`` for toy ``llama31``, ``qwen2``
  and ``gemma3`` configs at ``tests/test_hf_parity.py``'s DIMS (gemma3:
  window 16, layer types sliding/sliding/full), biases and norm weights
  drawn at random so that every one of them moves the loss. f32: loss rtol
  1e-5, each gradient leaf within 1e-5 of its largest magnitude (gemma3:
  2e-5; its embedding scale and norm gains leave both packages' f32
  gradients ~1e-5 of the largest apart from an evaluation in another order,
  and a swapped or misread norm is off by orders of magnitude more), through
  the plain attention and through the ``cuda_flash`` wrapper (its plain
  version on the CPU; the windowed layers take the reference's dispatch to
  the plain attention). bf16 compute on f32 weights (gemma3 and llama31):
  loss rtol 1e-3 (XLA and torch round bf16 elementwise chains at other
  points; the observed gaps are 1.4e-4 and 6e-6).
* The feature gate: the variants it admits (linear and yarn rope scaling,
  partial rotary, o and MLP biases, ``gemma3_text`` with exact GELU) give
  the JAX loss; the features it does not admit raise, naming their item of
  ROADMAP.md queue 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.data.data_collator import TextPackingCollator
from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy
RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# the model: loss and gradients against the JAX loss_fn
# ---------------------------------------------------------------------------
# tests/test_hf_parity.py's DIMS and dialect configs
DIMS = dict(vocab_size=257, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
DIALECTS = {
    "llama31": dict(model_type="llama", tie_word_embeddings=False, rope_theta=500000.0,
                    rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                  "high_freq_factor": 4.0,
                                  "original_max_position_embeddings": 64}),
    "qwen2": dict(model_type="qwen2", tie_word_embeddings=False, attention_bias=True),
    "gemma3": dict(model_type="gemma3", tie_word_embeddings=True, head_dim=16, qk_norm=True,
                   norm_zero_centered=True, sandwich_norms=True, embed_scale=64 ** 0.5,
                   query_pre_attn_scalar=16, sliding_window=16, rope_local_base_freq=10000.0,
                   rope_theta=1000000.0, hidden_act="gelu_pytorch_tanh",
                   final_logit_softcap=30.0,
                   layer_types=["sliding_attention", "sliding_attention", "full_attention"]),
}


def _perturbed(params, seed):
    """The JAX init with every bias and norm weight drawn at random (the
    init leaves them at 0 and 1, where a missing bias or a norm read as
    ``w`` for ``1 + w`` would go unseen)."""
    rng = _rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "bias" in name:
            return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1)
        if name.endswith("norm']"):
            return jnp.asarray((x + rng.standard_normal(x.shape) * 0.2).astype(np.float32))
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def models(dialect, dtype="float32", remat_policy="ctx", seed=0):
    fields = {**DIMS, **DIALECTS[dialect]}
    jcfg = JaxConfig(dtype=getattr(jnp, dtype), **fields)
    params = _perturbed(jtf.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    tcfg = TransformerConfig(dtype=getattr(torch, dtype), remat_policy=remat_policy, **fields)
    model = Transformer(tcfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def batch(seed=0, b=2, s=64):
    """Packed documents longer than the window (16) and shorter than S."""
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
def _jax_loss_grads(dialect, dtype, with_grads=True):
    """The reference's (loss, ntokens, grads or None) on ``batch()``, once
    per dialect and dtype (it does not depend on the port's impl pins)."""
    jcfg, params, _ = models(dialect, dtype)
    loss = functools.partial(jtf.loss_fn, cfg=jcfg,
                             batch={k: jnp.asarray(v) for k, v in batch().items()})
    if not with_grads:
        loss_j, metrics_j = jax.jit(loss)(params)
        return float(loss_j), int(metrics_j["ntokens"]), None
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(loss_j), int(metrics_j["ntokens"]), jax.tree.map(np.asarray, grads_j)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_results():
    yield
    _jax_loss_grads.cache_clear()


def _losses(dialect, dtype, attention_impl, remat_policy, with_grads=True):
    _, _, model = models(dialect, dtype, remat_policy)
    data = batch()
    loss_j, ntokens_j, grads_j = _jax_loss_grads(dialect, dtype, with_grads)
    apply_ops_config({"attention": attention_impl})
    try:
        loss_t, metrics_t = model.loss_fn({k: T(v) for k, v in data.items()})
        loss_t.backward()
    finally:
        apply_ops_config(None)
    assert int(metrics_t["ntokens"]) == ntokens_j
    return loss_j, loss_t.item(), grads_j, to_jax_tree(model, grads=True)


@pytest.mark.parametrize("attention_impl,remat_policy",
                         [("xla", "ctx"), ("cuda_flash", "nothing")],
                         ids=["plain-ctx", "flash-nothing"])
@pytest.mark.parametrize("dialect", list(DIALECTS))
def test_loss_and_grads_match_jax(dialect, attention_impl, remat_policy):
    loss_j, loss_t, grads_j, grads_t = _losses(dialect, "float32", attention_impl, remat_policy)
    np.testing.assert_allclose(loss_t, loss_j, rtol=RTOL)
    _assert_grads_close(grads_t, grads_j, 2e-5 if dialect == "gemma3" else RTOL)


@pytest.mark.parametrize("dialect", ["gemma3", "llama31"])
def test_bf16_loss_matches_jax(dialect):
    loss_j, loss_t, _, grads_t = _losses(dialect, "bfloat16", "xla", "ctx", with_grads=False)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-3)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(grads_t))


def test_windowed_layers_take_the_plain_dispatch():
    """Through ``cuda_flash`` on the CPU, gemma3's two windowed layers are
    the reference's feature dispatch to the plain attention (counted), its
    full-attention layer is not."""
    from veomni_tpu_torch.ops.cuda import flash_attention as fa

    _, _, model = models("gemma3")
    data = {k: T(v) for k, v in batch(s=128).items()}
    fa.reset_counts()
    apply_ops_config({"attention": "cuda_flash"})
    try:
        with torch.no_grad():
            model.loss_fn(data)
    finally:
        apply_ops_config(None)
    assert fa.FALLBACK_CALLS == 2
    assert [layer.window for layer in model.layers] == [16, 16, 0]
    assert [layer.local_rope for layer in model.layers] == [True, True, False]


# ---------------------------------------------------------------------------
# the feature gate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra,item", [
    (dict(remat_policy="dots"), None),
    (dict(ulysses_async_chunks=2), None),
    (dict(linear_num_value_heads=4), "slice F"),
    (dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
          index_topk=4), "slice F"),
    (dict(index_topk=4), "slice F"),
    (dict(attn_output_gate=True), "slice F"),
    (dict(chunk_mbs=64), None),
    (dict(remat_policy="offload"), None),
], ids=["remat-dots", "ulysses-async-chunks", "linear-attention", "mla-dsa", "dsa",
        "output-gate", "chunk-mbs", "remat-offload"])
def test_unported_features_name_their_queue_item(extra, item):
    """Each unported feature raises naming its queue item; the remat
    policies, chunk_mbs and the async Ulysses chunks (item None) are ported
    and pass the gate."""
    from veomni_tpu_torch.models.transformer import check_supported

    cfg = TransformerConfig(**{**DIMS, **extra})
    if item is None:
        check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=item):
        check_supported(cfg)


# ROADMAP.md queue 3's MoE toy
MOE_TOY = dict(model_type="qwen3_moe", vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, head_dim=16,
               num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16)


def test_capacity_factor_at_ep_size_1_is_dropless():
    """``moe_capacity_factor`` 2.0 at expert-parallel size 1: the reference
    reads the factor only under expert parallelism and runs the dropless
    MoE otherwise, so the port's loss equals its own at factor 0 and the
    reference's (f32, rtol 1e-5)."""
    params = jtf.init_params(jax.random.PRNGKey(0), JaxConfig(dtype=jnp.float32, **MOE_TOY))
    ids = _rng(0).integers(0, MOE_TOY["vocab_size"], (1, 32))
    data = {"input_ids": ids, "labels": ids, "position_ids": np.arange(32)[None],
            "segment_ids": np.ones((1, 32), np.int64)}
    losses = {}
    for factor in (0.0, 2.0):
        model = Transformer(TransformerConfig(dtype=torch.float32, moe_capacity_factor=factor,
                                              **MOE_TOY), None, device="cpu")
        load_jax_params(model, jax.tree.map(np.asarray, params))
        losses[factor] = model.loss_fn({k: T(np.asarray(v)) for k, v in data.items()})[0].item()
    jcfg = JaxConfig(dtype=jnp.float32, moe_capacity_factor=2.0, **MOE_TOY)
    loss_j, _ = jax.jit(lambda p, b: jtf.loss_fn(p, jcfg, b))(
        params, {k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_allclose(losses[2.0], losses[0.0], rtol=RTOL)
    np.testing.assert_allclose(losses[2.0], float(loss_j), rtol=RTOL)


@pytest.mark.parametrize("dialect,extra", [
    ("llama31", dict(rope_scaling={"rope_type": "linear", "factor": 2.0})),
    ("llama31", dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                   "original_max_position_embeddings": 32})),
    ("llama31", dict(partial_rotary_factor=0.5)),
    ("qwen2", dict(o_bias=True, mlp_bias=True)),
    ("gemma3", dict(model_type="gemma3_text", hidden_act="gelu")),
], ids=["linear", "yarn", "partial-rotary", "o-and-mlp-bias", "gemma3-text-gelu"])
def test_ported_features_are_admitted(dialect, extra):
    """The dialects' variants the gate admits build and train: the loss
    equal to the JAX ``loss_fn``'s (f32, rtol 1e-5) and a finite gradient
    for every parameter."""
    fields = {**DIMS, **DIALECTS[dialect], **extra}
    jcfg = JaxConfig(dtype=jnp.float32, **fields)
    params = _perturbed(jtf.init_params(jax.random.PRNGKey(1), jcfg), 1)
    model = Transformer(TransformerConfig(dtype=torch.float32, **fields), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    data = batch()
    loss_j, _ = jax.jit(lambda p, b: jtf.loss_fn(p, jcfg, b))(
        params, {k: jnp.asarray(v) for k, v in data.items()})
    loss, _ = model.loss_fn({k: T(v) for k, v in data.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
