"""Port transformer (veomni_tpu_torch/models/transformer.py) vs JAX loss_fn.

At the ``configs/text/qwen3_toy_cpu.yaml`` dims (qk-norm, GQA 8/4) in f32,
with weights carried from JAX ``init_params`` by ``load_jax_params``, the
port's token-sum loss and every per-leaf gradient match JAX ``loss_fn`` +
``jax.grad``, with and without packing, through the plain attention and
through the ``cuda_flash`` wrapper (its plain version on the CPU), under both
remat policies. Tolerances (f32; XLA and torch accumulate matmuls in other
orders): loss rtol 1e-5; each gradient leaf within 1e-5 of its largest
magnitude (the observed gap is ~1e-6 of it).
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

# configs/text/qwen3_toy_cpu.yaml model dims
TOY = dict(model_type="qwen3", vocab_size=512, hidden_size=128, intermediate_size=256,
           num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
           head_dim=16, qk_norm=True)


def toy_batch(packed: bool, b=2, s=128, seed=0):
    """Seeded [B,S] batch: packed documents, or one document per row."""
    rng = np.random.default_rng(seed)
    if packed:
        docs = [{"input_ids": rng.integers(0, TOY["vocab_size"], int(n))}
                for n in rng.integers(10, 70, 6)]
        return TextPackingCollator(s, b)(docs)
    ids = rng.integers(0, TOY["vocab_size"], (b, s)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1).astype(np.int32)
    return {"input_ids": ids, "labels": labels,
            "position_ids": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy(),
            "segment_ids": np.ones((b, s), np.int32)}


def jax_and_torch_models(tie=False, remat_policy="nothing", seed=0):
    jcfg = JaxConfig(dtype=jnp.float32, tie_word_embeddings=tie, **TOY)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = TransformerConfig(dtype=torch.float32, tie_word_embeddings=tie,
                             remat_policy=remat_policy, **TOY)
    model = Transformer(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def assert_tree_close(got, ref, rel_to_max, path=""):
    """Every leaf within ``rel_to_max`` x (its largest reference magnitude)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for key in ref:
            assert_tree_close(got[key], ref[key], rel_to_max, f"{path}/{key}")
        return
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel_to_max * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize(
    "packed,attention_impl,remat_policy,tie",
    [(True, "cuda_flash", "ctx", False), (True, "xla", "nothing", True),
     (False, "cuda_flash", "nothing", True), (False, "xla", "ctx", False)],
    ids=["packed-flash-ctx", "packed-plain-nothing-tied",
         "unpacked-flash-nothing-tied", "unpacked-plain-ctx"],
)
def test_loss_and_grads_match_jax(packed, attention_impl, remat_policy, tie):
    jcfg, params, model = jax_and_torch_models(tie=tie, remat_policy=remat_policy)
    batch = toy_batch(packed)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg, batch={k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True,
    )(params)
    apply_ops_config({"attention": attention_impl})
    try:
        loss_t, metrics_t = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
        loss_t.backward()
    finally:
        apply_ops_config(None)
    assert int(metrics_t["ntokens"]) == int(metrics_j["ntokens"])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert_tree_close(to_jax_tree(model, grads=True), grads_j, 1e-5)


MOE = dict(model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64)


def test_unported_features_raise():
    # the DSA indexer on MLA still raises; the remat policies and chunk_mbs
    # are ported (tests/test_torch_remat.py), chunk_mbs on a MoE leaves its
    # MoE layers unchunked as the reference does (the deepseek and gpt_oss
    # dialects: tests/test_torch_deepseek.py, tests/test_torch_gpt_oss.py;
    # mrope with the VLM models: tests/test_torch_qwen2_vl.py)
    with pytest.raises(NotImplementedError):
        Transformer(TransformerConfig(**{**TOY, **dict(
            kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
            index_topk=4)}), torch.Generator(), device="cpu")
    for extra in (dict(MOE, chunk_mbs=64), dict(remat_policy="ctx_offload"),
                  dict(remat_policy="dots")):
        Transformer(TransformerConfig(**{**TOY, **extra}), torch.Generator(), device="cpu")
    # the softmax top-k MoE itself is ported
    Transformer(TransformerConfig(**{**TOY, **MOE}), torch.Generator(), device="cpu")


@pytest.mark.parametrize("extra,raises", [
    (dict(remat_policy="dots"), False), (dict(remat_policy="offload"), False),
    (dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, index_topk=4),
     True),
    (dict(linear_num_value_heads=4), True), (dict(attn_output_gate=True), True),
    (dict(chunk_mbs=64), False), (dict(ulysses_async_chunks=2), False),
], ids=["remat-dots", "remat-offload", "mla-dsa", "linear-attention", "output-gate",
        "chunk-mbs", "ulysses-async-chunks"])
def test_unported_moe_features_raise(extra, raises):
    """The unported features raise on a MoE config; the remat policies,
    chunk_mbs and the async Ulysses chunks (raises False) build."""
    cfg = TransformerConfig(**{**TOY, **MOE, **extra})
    if not raises:
        Transformer(cfg, torch.Generator(), device="cpu")
        return
    with pytest.raises(NotImplementedError):
        Transformer(cfg, torch.Generator(), device="cpu")


def test_capacity_factor_leaves_the_moe_dropless():
    """At expert-parallel size 1 a capacity factor changes nothing (the
    reference reads it only under expert parallelism): a factor of 0.5,
    which would drop assignments under EP, gives the factor-0 loss bit for
    bit on the same weights."""
    data = {k: torch.from_numpy(v) for k, v in toy_batch(True).items()}
    gen = torch.Generator().manual_seed(0)
    dropless = Transformer(TransformerConfig(**{**TOY, **MOE}), gen, device="cpu")
    capped = Transformer(TransformerConfig(**{**TOY, **MOE, "moe_capacity_factor": 0.5}), None,
                         device="cpu")
    capped.load_state_dict(dropless.state_dict())
    with torch.no_grad():
        assert torch.equal(capped.loss_fn(data)[0], dropless.loss_fn(data)[0])


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh"])
def test_moe_experts_take_the_dialect_activation(act):
    """The routed experts apply the config's gated activation, as the
    reference's ``experts_apply_sorted`` does (``gated_act``), not SwiGLU
    whatever the dialect (ROADMAP.md queue 3): a GELU MoE toy's loss
    against the reference's, f32, rtol 1e-5 (SwiGLU experts land 2.1e-5
    off it)."""
    fields = {**TOY, **MOE, "hidden_act": act}
    jcfg = JaxConfig(dtype=jnp.float32, **fields)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(TransformerConfig(dtype=torch.float32, **fields), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    batch = toy_batch(False)
    loss_j, _ = jax.jit(functools.partial(jtf.loss_fn, cfg=jcfg))(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss_t, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
