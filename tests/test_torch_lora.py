"""The port's LoRA (``veomni_tpu_torch/lora``) against ``veomni_tpu/lora``, on
the CPU, f32, at the reference's LoRA test toys (``tests/test_lora.py``:
qwen3 and qwen3_moe, 2 layers, hidden 32, 4 experts top-2 of width 32).

* The adapter tree: the port's ``init_lora_params`` adapts the same leaves
  as the reference's with the same shapes (expert-batched ``A [L, E, in,
  r]`` / ``B [L, E, r, out]`` on the MoE toy), ``B = 0`` and ``scale =
  alpha / rank``, so the merged model equals the base exactly.
* With the reference's adapters carried across (``load_jax_adapters``;
  ``B`` drawn nonzero from numpy so every gradient moves) the LoRA loss
  and every adapter gradient (``lora_a``, ``lora_b`` and the trainable
  ``scale``) equal the JAX ``apply_lora_to_loss_fn``'s, rtol 1e-5 (each
  leaf within 1e-5 of its largest magnitude; a ``scale``'s gradient,
  ``<dL/dW, A @ B>``, within 1e-5 of the sum of its terms' magnitudes, as
  the sum cancels), with and without ``ctx``
  remat (the merge reruns inside the recomputed regions); the base gets no
  gradient. ``merge_lora_params`` equals the reference's.
* Files: an adapter saved by the reference loads into the port, one saved
  by the port loads into the reference, and the port's save/load round
  trip is bit-equal, with the reference's file names and keys.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.lora import LoraConfig as JaxLoraConfig
from veomni_tpu.lora import apply_lora_to_loss_fn as j_apply
from veomni_tpu.lora import init_lora_params as j_init
from veomni_tpu.lora import merge_lora_params as j_merge
from veomni_tpu.lora.lora import load_adapter as j_load_adapter
from veomni_tpu.lora.lora import save_adapter as j_save_adapter
from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu_torch.lora import (
    LoraConfig,
    apply_lora_to_loss_fn,
    init_lora_params,
    load_adapter,
    merge_lora_params,
    save_adapter,
)
from veomni_tpu_torch.lora.lora import ADAPTER_CONFIG, ADAPTER_WEIGHTS
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import (
    adapters_to_jax_tree,
    load_jax_adapters,
    load_jax_params,
    to_jax_tree,
)

RTOL = 1e-5
DENSE = dict(model_type="qwen3", vocab_size=128, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
             qk_norm=True)
MOE = dict(DENSE, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32)
RANK, ALPHA = 4, 8.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v)
    return out


def batch(seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, DENSE["vocab_size"], (b, s))
    labels = np.where(rng.random((b, s)) < 0.3, -100, rng.integers(0, DENSE["vocab_size"], (b, s)))
    seg = np.repeat(np.array([[1] * 20 + [2] * 12]), b, 0)
    pos = np.concatenate([np.arange(20), np.arange(12)])[None].repeat(b, 0)
    return {"input_ids": ids, "labels": labels, "position_ids": pos, "segment_ids": seg}


@functools.lru_cache(maxsize=None)
def _jax_side(name, seed=0):
    """(JAX config, base params, JAX adapters with B drawn nonzero, the LoRA
    loss and its adapter gradients on ``batch()``), once per toy."""
    fields = {"dense": DENSE, "moe": MOE}[name]
    jcfg = JaxConfig(dtype=jnp.float32, **fields)
    base = jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.PRNGKey(seed))
    lora = j_init(jax.random.PRNGKey(seed + 1), base, JaxLoraConfig(rank=RANK, alpha=ALPHA))
    rng = np.random.default_rng(seed)

    def draw_b(path, leaf):
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.05)
        return leaf

    lora = jax.tree_util.tree_map_with_path(draw_b, lora)
    j_loss = j_apply(lambda p, b: jtf.loss_fn(p, jcfg, b)[0], base)
    loss, grads = jax.jit(jax.value_and_grad(j_loss))(
        lora, {k: jnp.asarray(v) for k, v in batch().items()})
    return jcfg, base, lora, float(loss), _flat(grads)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_results():
    yield
    _jax_side.cache_clear()


def toys(name, remat_policy="ctx"):
    """The JAX side and the port model with its base and adapters carried
    across."""
    jcfg, base, lora, loss, grads = _jax_side(name)
    fields = {"dense": DENSE, "moe": MOE}[name]
    model = Transformer(TransformerConfig(dtype=torch.float32, remat=remat_policy != "",
                                          remat_policy=remat_policy or "ctx", **fields),
                        None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, base))
    adapters = init_lora_params(None, model, LoraConfig(rank=RANK, alpha=ALPHA))
    load_jax_adapters(adapters, jax.tree.map(np.asarray, lora))
    return base, lora, loss, grads, model, adapters


@pytest.mark.parametrize("fields", [DENSE, MOE], ids=["dense", "moe"])
def test_init_adapts_the_reference_leaves(fields):
    jcfg = JaxConfig(dtype=jnp.float32, **fields)
    ref = _flat(jax.eval_shape(lambda: j_init(
        jax.random.PRNGKey(1), jtf.init_params(jax.random.PRNGKey(0), jcfg),
        JaxLoraConfig(rank=RANK, alpha=ALPHA))))
    model = Transformer(TransformerConfig(dtype=torch.float32, **fields),
                        torch.Generator().manual_seed(0), device="cpu")
    adapters = init_lora_params(torch.Generator().manual_seed(1), model,
                                LoraConfig(rank=RANK, alpha=ALPHA))
    got = {k: v.detach().numpy() for k, v in adapters.named_jax_parameters()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    if fields is MOE:
        assert got["layers.experts.gate_proj.lora_a"].shape == (2, 4, 32, RANK)
    for k, v in got.items():
        if k.endswith("lora_b"):
            assert not v.any()
        elif k.endswith("scale"):
            assert v == ALPHA / RANK
        else:
            assert 0.015 < v.std() < 0.025
    merged = merge_lora_params(model, adapters)
    for a, b in zip(merged.parameters(), model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,remat", [("dense", "ctx"), ("dense", ""), ("moe", "ctx"),
                                        ("moe", "nothing")],
                         ids=["dense-ctx", "dense-no-remat", "moe-ctx", "moe-nothing"])
def test_loss_and_adapter_grads_match_jax(name, remat):
    _, _, loss_j, ref, model, adapters = toys(name, remat)
    data = {k: torch.from_numpy(v) for k, v in batch().items()}
    loss_fn = apply_lora_to_loss_fn(lambda m, b: m.loss_fn(b), model)
    with adapters.merged():  # a remat backward recomputes on the merged weights
        loss, _ = loss_fn(adapters, data)
        loss.backward()
    assert not any(layer.merges for layer in model.layers)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=RTOL)
    got = _flat(adapters_to_jax_tree(adapters, grads=True))
    assert got.keys() == ref.keys()
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    # a scale's gradient is <dL/dW, A @ B>, a sum that cancels: it is held to
    # 1e-5 of the sum of its terms' magnitudes (dL/dW from the merged model)
    merged = merge_lora_params(model, adapters)
    merged.loss_fn(data)[0].backward()
    w_grads = to_jax_tree(merged, grads=True)
    for k in ref:
        assert np.abs(ref[k]).max() > 0, k
        magnitude = np.abs(ref[k]).max()
        if k.endswith(".scale"):
            leaf = adapters.leaf(k[:-len(".scale")])
            ab = torch.matmul(leaf.lora_a, leaf.lora_b).detach().numpy()
            magnitude = np.abs(_flat(w_grads)[k[:-len(".scale")]] * ab).sum()
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=RTOL * magnitude, err_msg=k)


def test_merge_matches_jax():
    base, lora, _, _, model, adapters = toys("moe")
    ref = _flat(j_merge(base, lora))
    got = _flat(to_jax_tree(merge_lora_params(model, adapters)))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_merged_export_streams_one_layer_at_a_time(tmp_path, monkeypatch):
    """``save_merged_hf`` writes the merged model ``merge_lora_params``
    builds, bit for bit, merging each adapted tensor once and each owner's
    (layer's) tensors in one run, so one layer's merged copy is held at a
    time; afterwards the base reads its own weights again."""
    from veomni_tpu_torch.lora import lora as lora_mod
    from veomni_tpu_torch.lora import save_merged_hf
    from veomni_tpu_torch.models.hf_io import hf_to_params

    _, _, _, _, model, adapters = toys("moe")
    calls = []
    merge = lora_mod._merge_layer

    def counted(leaf, layer, w):
        calls.append((leaf, layer))
        return merge(leaf, layer, w)

    monkeypatch.setattr(lora_mod, "_merge_layer", counted)
    save_merged_hf(model, adapters, str(tmp_path / "hf"))
    owners = [layer for _, layer in calls]
    assert len(set(calls)) == len(calls) == sum(len(adapters._owners[p]) for p in adapters.paths)
    assert owners == sorted(owners)  # layer 0's merges, then layer 1's
    assert not any(layer.merges for layer in model.layers)
    back = hf_to_params(str(tmp_path / "hf"), model.cfg,
                        Transformer(model.cfg, None, device="cpu"))
    want = merge_lora_params(model, adapters)
    for (n, a), (_, b) in zip(back.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), n


def test_adapter_files_cross_load(tmp_path):
    _, lora, _, _, model, adapters = toys("moe")
    j_save_adapter(lora, JaxLoraConfig(rank=RANK, alpha=ALPHA), str(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ref")) == sorted([ADAPTER_CONFIG, ADAPTER_WEIGHTS])
    fresh = init_lora_params(None, model, LoraConfig(rank=RANK, alpha=ALPHA))
    load_adapter(str(tmp_path / "ref"), fresh)
    for (k, a), (_, b) in zip(fresh.named_jax_parameters(), adapters.named_jax_parameters()):
        assert torch.equal(a, b), k
    # the port's round trip, bit for bit, after a perturbation
    with torch.no_grad():
        for _, p in adapters.named_jax_parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    cfg = LoraConfig(rank=RANK, alpha=ALPHA)
    save_adapter(adapters, cfg, str(tmp_path / "port"))
    back = load_adapter(str(tmp_path / "port"), init_lora_params(None, model, cfg))
    for (k, a), (_, b) in zip(back.named_jax_parameters(), adapters.named_jax_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # and the reference reads the port's file
    restored = j_load_adapter(str(tmp_path / "port"), jax.eval_shape(lambda: lora))
    got = _flat(adapters_to_jax_tree(adapters))
    for k, v in _flat(restored).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
