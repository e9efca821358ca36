"""The port's post-training ops against the JAX package, on the CPU.

* ``ops.fused_linear_cross_entropy_per_token`` and
  ``ops.fused_linear_topk_distill`` against the reference's
  (``veomni_tpu/ops/cross_entropy.py:69-203``): every per-token output and
  the gradients with respect to the hidden states and the head matrix, at
  chunk sizes that divide T and that do not, with and without a softcap
  (per-token CE), and with temperature 1 and 0.7 with and without a
  log-prob clamp (distill). Inputs from ``np.random.default_rng``, f32.
* ``Transformer.sequence_logprob_sums`` against the reference's on a toy
  (2 layers, hidden 64) with one sample a row and a padded tail (segment
  0), forward and gradients; the ``no_grad`` scores equal the grad ones.
* The softcap (ROADMAP.md queue 3, diverges on purpose 7): on a capped toy
  the reference's ``sequence_logprob_sums`` leaves the cap out, so its sums
  disagree with its own ``head_loss`` on the same rows; the port's agree
  with ``head_loss`` (in both packages) and so depart from the reference's.

Tolerances: outputs rtol 1e-5 (atol 1e-6 for values near 0); gradients
within 1e-5 of their largest magnitude (XLA and torch sum in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu.ops import cross_entropy as jce
from veomni_tpu_torch import ops
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.ops.cross_entropy import DISTILL_OUTPUTS

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T, H, V, K = 50, 16, 64, 4
TOY = dict(model_type="qwen3", vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           qk_norm=True)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((T, H)).astype(np.float32)
    kernel = (rng.standard_normal((H, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    labels[rng.random(T) < 0.2] = -100
    t_ids = np.stack([rng.choice(V, K, replace=False) for _ in range(T)]).astype(np.int32)
    t_lp = np.log(rng.dirichlet(np.ones(V), T)[np.arange(T)[:, None], t_ids]).astype(np.float32)
    return hidden, kernel, labels, t_ids, t_lp, rng


def grads_close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("chunk,softcap", [(10, None), (16, None), (16, 3.0), (4096, None)],
                         ids=["divides", "ragged", "ragged-softcap", "one-chunk"])
def test_per_token_ce_matches_jax(chunk, softcap):
    hidden, kernel, labels, _, _, rng = inputs()
    w = rng.standard_normal(T).astype(np.float32)

    def j_loss(h, k):
        nll = jce.fused_linear_cross_entropy_per_token(
            h, k, jnp.asarray(labels), chunk_size=chunk, logit_softcap=softcap)
        return (nll * w).sum(), nll

    (_, nll_j), grads_j = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(kernel))
    h, k = torch.tensor(hidden, requires_grad=True), torch.tensor(kernel, requires_grad=True)
    nll = ops.fused_linear_cross_entropy_per_token(h, k, torch.from_numpy(labels),
                                                   chunk_size=chunk, logit_softcap=softcap)
    (nll * torch.from_numpy(w)).sum().backward()
    assert nll.shape == (T,) and bool((nll[torch.from_numpy(labels) == -100] == 0).all())
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(nll_j), rtol=1e-5, atol=1e-6)
    grads_close((h.grad, k.grad), grads_j)


@pytest.mark.parametrize("chunk,temperature,clamp",
                         [(10, 1.0, None), (16, 0.7, None), (16, 0.7, -3.0), (64, 1.0, -2.5)],
                         ids=["divides", "ragged-tempered", "ragged-tempered-clamped",
                              "one-chunk-clamped"])
def test_topk_distill_matches_jax(chunk, temperature, clamp):
    hidden, kernel, labels, t_ids, t_lp, rng = inputs(1)
    weights = {name: rng.standard_normal(T).astype(np.float32)
               for name in ("log_probs", "entropy", "distill", "nll")}
    kw = dict(chunk_size=chunk, temperature=temperature, log_prob_min_clamp=clamp)

    def j_loss(h, k):
        out = jce._topk_distill_chunked(h, k, jnp.asarray(labels), jnp.asarray(t_ids),
                                        jnp.asarray(t_lp), **kw)
        return sum((out[n] * w).sum() for n, w in weights.items()), out

    (_, out_j), grads_j = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(kernel))
    h, k = torch.tensor(hidden, requires_grad=True), torch.tensor(kernel, requires_grad=True)
    out = ops.fused_linear_topk_distill(h, k, torch.from_numpy(labels), torch.from_numpy(t_ids),
                                        torch.from_numpy(t_lp), **kw)
    assert set(out) == set(DISTILL_OUTPUTS)
    assert not out["student_mass"].requires_grad and not out["teacher_mass"].requires_grad
    sum((out[n] * torch.from_numpy(w)).sum() for n, w in weights.items()).backward()
    for name in DISTILL_OUTPUTS:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(out_j[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    grads_close((h.grad, k.grad), grads_j)


def toy(softcap=0.0, seed=0):
    jcfg = JaxConfig(dtype=jnp.float32, final_logit_softcap=softcap, **TOY)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    model = Transformer(TransformerConfig(dtype=torch.float32, final_logit_softcap=softcap,
                                          **TOY), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def rows_batch(b=4, s=48, seed=0):
    """One sample a row, lengths 20-48, the tails padding at segment 0 and
    label -100, the first third of each row a masked prompt."""
    rng = np.random.default_rng(seed)
    out = {"input_ids": np.zeros((b, s), np.int32), "labels": np.full((b, s), -100, np.int32),
           "position_ids": np.zeros((b, s), np.int32), "segment_ids": np.zeros((b, s), np.int32)}
    for i in range(b):
        n = int(rng.integers(20, s + 1))
        ids = rng.integers(0, TOY["vocab_size"], n)
        out["input_ids"][i, :n] = ids
        out["labels"][i, n // 3:n - 1] = ids[n // 3 + 1:]
        out["position_ids"][i, :n] = np.arange(n)
        out["segment_ids"][i, :n] = 1
    return out


def test_sequence_logprob_sums_match_jax():
    jcfg, params, model = toy()
    batch = rows_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    w = np.array([1.0, -0.5, 2.0, 0.25], np.float32)

    def j_objective(p):
        sums = jtf.sequence_logprob_sums(p, jcfg, jb)
        return (sums * w).sum(), sums

    (_, sums_j), grads_j = jax.jit(jax.value_and_grad(j_objective, has_aux=True))(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    sums = model.sequence_logprob_sums(tb)
    (sums * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(sums_j), rtol=1e-5)
    got = to_jax_tree(model, grads=True)
    for path, ref in jax.tree_util.tree_leaves_with_path(grads_j):
        g = functools.reduce(lambda t, key: t[key.key], path, got)
        ref = np.asarray(ref)
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=str(path))
    with torch.no_grad():
        assert torch.equal(model.sequence_logprob_sums(tb), sums.detach())


def test_softcap_sums_follow_head_loss_where_the_reference_drops_the_cap():
    jcfg, params, model = toy(softcap=0.1)  # the toy's logits have a std of ~0.16
    batch = rows_batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_sums = np.asarray(jax.jit(lambda p, b: jtf.sequence_logprob_sums(p, jcfg, b))(params, jb))
    hidden, aux, _ = jax.jit(lambda p, b: jtf.forward_hidden(
        p, jcfg, b["input_ids"], b["position_ids"], b["segment_ids"]))(params, jb)
    head_loss = jax.jit(lambda p, h, lab, a: jtf.head_loss(p, jcfg, h, lab, a)[0])
    head = np.array([float(head_loss(params, hidden[i:i + 1], jb["labels"][i:i + 1], aux))
                     for i in range(4)])
    with torch.no_grad():
        got = model.sequence_logprob_sums({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(-got.numpy(), head, rtol=1e-5)  # the port follows head_loss
    gap = np.abs(-ref_sums - head) / head
    # the reference's sums do not: 1.6e-3 to 8.6e-3 apart, over 100x the parity tolerance
    assert gap.min() > 100 * 1e-5, gap
    # without a cap the port keeps the reference's sums (test above)
