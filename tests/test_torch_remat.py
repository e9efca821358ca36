"""The remat policies and ``chunk_mbs`` of the port's model against the JAX
package, on the CPU, at toy sizes.

* Loss and every gradient leaf under ``nothing``, ``ctx``, ``dots``,
  ``offload`` and ``ctx_offload``, and under ``chunk_mbs`` 10 on a length
  of 48 (rounded down to the divisor 8, as the reference rounds it), against
  ``veomni_tpu.models.transformer.loss_fn`` run with the same policy and
  chunk: f32, loss rtol 1e-5, each gradient leaf within 1e-5 of its largest
  magnitude. A dense qwen3 toy and a qwen3_moe toy (whose MoE layers are
  not chunked).
* The same loss and gradients against the port's own ``ctx`` run: bit-equal
  for every policy (each runs the forward's kernels in the same order, and a
  saved product is the product a recompute would give), within the f32
  limits above under ``chunk_mbs`` (chunked GEMMs sum in another order).
* The attention forward runs once a layer under every policy but
  ``nothing``, which reruns it in the backward (the flash wrapper's plain
  version, counted on the CPU): the reckoning ``chip_smoke.py`` holds the
  card's launch counts to.
* ``offload`` really parks its products: the forward copies one host tensor
  per product and the backward reads each back.
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
from veomni_tpu_torch.models import transformer as ttf
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.ops.cuda import flash_attention as fa
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

RTOL = 1e-5
DENSE = dict(model_type="qwen3", vocab_size=257, hidden_size=64, intermediate_size=112,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             qk_norm=True)
MOE = dict(DENSE, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32)
MODELS = {"dense": DENSE, "moe": MOE}
SEQ = 48
# (remat_policy, chunk_mbs): chunk 10 on a length of 48 runs at 8
CASES = [("nothing", 0), ("ctx", 0), ("dots", 0), ("offload", 0), ("ctx_offload", 0),
         ("ctx", 10), ("dots", 10), ("offload", 10)]
IDS = [f"{p}-chunk{c}" if c else p for p, c in CASES]


def _batch(seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    docs = [{"input_ids": rng.integers(0, DENSE["vocab_size"], int(n))}
            for n in rng.integers(10, seq - 8, 4)]
    return TextPackingCollator(seq, 2)(docs)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return jtf.init_params(jax.random.PRNGKey(0), JaxConfig(dtype=jnp.float32, **MODELS[name]))


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name, policy, chunk):
    cfg = JaxConfig(dtype=jnp.float32, remat_policy=policy, chunk_mbs=chunk, **MODELS[name])
    loss = functools.partial(jtf.loss_fn, cfg=cfg,
                             batch={k: jnp.asarray(v) for k, v in _batch().items()})
    (loss_j, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(_jax_params(name))
    return float(loss_j), jax.tree.map(np.asarray, grads)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_results():
    yield
    _jax_loss_grads.cache_clear()
    _jax_params.cache_clear()


def _port(name, policy, chunk, batch=None, impl="xla"):
    """(loss, gradient tree in the reference's layout) of the port's model
    with the JAX weights, under ``policy`` and ``chunk``."""
    model = Transformer(TransformerConfig(dtype=torch.float32, remat_policy=policy,
                                          chunk_mbs=chunk, **MODELS[name]), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, _jax_params(name)))
    batch = _batch() if batch is None else batch
    apply_ops_config({"attention": impl})
    try:
        loss, _ = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
    finally:
        apply_ops_config(None)
    return loss.item(), to_jax_tree(model, grads=True)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, np.asarray(tree, np.float32))]


def _assert_close(got, ref):
    for (path, g), (_, r) in zip(_leaves(got), _leaves(ref), strict=True):
        np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * np.abs(r).max(), err_msg=path)


@pytest.mark.parametrize("policy,chunk", CASES, ids=IDS)
@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_grads_match_jax_and_ctx(name, policy, chunk):
    loss_j, grads_j = _jax_loss_grads(name, policy, chunk)
    loss_t, grads_t = _port(name, policy, chunk)
    np.testing.assert_allclose(loss_t, loss_j, rtol=RTOL)
    _assert_close(grads_t, grads_j)
    loss_c, grads_c = _port(name, "ctx", 0)
    if chunk and name == "dense":
        np.testing.assert_allclose(loss_t, loss_c, rtol=RTOL)
        _assert_close(grads_t, grads_c)
        return
    assert loss_t == loss_c
    for (path, g), (_, c) in zip(_leaves(grads_t), _leaves(grads_c), strict=True):
        assert np.array_equal(g, c), path


@pytest.mark.parametrize("chunk,s,want", [(10, 48, 8), (8, 48, 8), (64, 64, 0), (16, 64, 16),
                                          (4, 7, 0), (5, 9, 3), (1, 8, 0), (0, 48, 0)])
def test_chunk_len_rounds_down_as_the_reference(chunk, s, want):
    assert ttf.chunk_len(chunk, s) == want


@pytest.mark.parametrize("policy", ["nothing", "ctx", "dots", "offload", "ctx_offload"])
def test_attention_forward_runs_once_a_layer_but_under_nothing(policy, monkeypatch):
    """K1 (here its plain version through the flash wrapper, S = 128) runs
    once a layer in the forward; ``nothing`` reruns it in the backward. K2
    and K3 run once a layer under every policy."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fa, "flash_fwd", counted(fa.flash_fwd, "fwd"))
    monkeypatch.setattr(fa, "flash_bwd", counted(fa.flash_bwd, "bwd"))
    layers = DENSE["num_hidden_layers"]
    _port("dense", policy, 0, batch=_batch(seq=128), impl="cuda_flash")
    assert calls == {"fwd": layers * (2 if policy == "nothing" else 1), "bwd": layers}


def test_offload_parks_every_product_on_the_host(monkeypatch):
    """Under ``offload`` each checkpointed block copies its products to the
    host in the forward and hands each back once in the recompute: q, k, v
    a layer in the first block, o, gate, up and down in the second."""
    made = []
    real = ttf._host_matmul_contexts

    def spy():
        fwd, rec = real()
        made.append(fwd.saved)
        return fwd, rec

    monkeypatch.setattr(ttf, "_host_matmul_contexts", spy)
    _port("dense", "offload", 0)
    assert [len(saved) for saved in made] == [3, 4] * DENSE["num_hidden_layers"]
    assert all(t.device.type == "cpu" for saved in made for t in saved)
