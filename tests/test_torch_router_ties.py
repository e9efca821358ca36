"""Router ties: the port picks the experts the reference picks.

``jax.lax.top_k`` (the reference's ``route_tokens``,
``veomni_tpu/models/transformer.py:292``) takes the lower index among equal
values; ``torch.topk`` makes no such promise, and on a zeroed router (every
probability 1/E) it picked the top indices. The port's ``route_tokens`` takes
the first k of a stable descending sort. Held here:

* at the function level, on a zeroed router and on tie-heavy routers whose
  logits take a few distinct values: expert indices equal, weights within
  1e-6 (E in {4, 8, 64, 128});
* at the loss level, ``MOE_TOY`` with both layers' routers zeroed: the
  loss and ``moe_aux_loss`` within rtol 1e-5 of the JAX loss, and every
  gradient leaf (the expert gradients land on the same experts) within 1e-5
  of its largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu_torch.models import TransformerConfig
from veomni_tpu_torch.models.jax_weights import to_jax_tree
from veomni_tpu_torch.models.transformer import route_tokens

from test_torch_moe import MOE_TOY, moe_models
from test_torch_transformer import assert_tree_close, toy_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy


def _route_both(x, router, e, k):
    fields = dict(MOE_TOY, num_experts=e, num_experts_per_tok=k, hidden_size=x.shape[1])
    idx_j, w_j, aux_j = jtf.route_tokens(jnp.asarray(x), {"router": jnp.asarray(router)},
                                         JaxConfig(dtype=jnp.float32, **fields))
    idx_t, w_t, aux_t = route_tokens(T(x), T(router), TransformerConfig(dtype=torch.float32,
                                                                        **fields))
    return (np.asarray(idx_j), np.asarray(w_j), float(aux_j)), (idx_t.numpy(), w_t.numpy(),
                                                                aux_t.item())


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (64, 8), (128, 8)])
@pytest.mark.parametrize("router_kind", ["zero", "few-values"])
def test_route_tokens_ties_pick_lower_index(e, k, router_kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    if router_kind == "zero":
        router = np.zeros((32, e), np.float32)
    else:
        # x @ router takes at most 3 values per token (columns repeat): ties
        # inside and across the top k
        cols = (rng.standard_normal((32, 3)) * 0.2).astype(np.float32)
        router = cols[:, rng.integers(0, 3, e)]
    (idx_j, w_j, aux_j), (idx_t, w_t, aux_t) = _route_both(x, router, e, k)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t, aux_j, rtol=1e-6)
    if router_kind == "zero":
        np.testing.assert_array_equal(idx_t, np.broadcast_to(np.arange(k), (64, k)))


def test_zero_router_loss_and_grads_match_jax():
    jcfg, params, model = moe_models()
    params = jax.tree.map(lambda a: a, params)
    params["layers"]["router"] = jnp.zeros_like(params["layers"]["router"])
    with torch.no_grad():
        for layer in model.layers:
            layer.router.zero_()
    batch = toy_batch(True)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, metrics_t = model.loss_fn({k: T(v) for k, v in batch.items()})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(metrics_t["moe_aux_loss"].item(), float(metrics_j["moe_aux_loss"]),
                               rtol=1e-5)
    assert_tree_close(to_jax_tree(model, grads=True), grads_j, 1e-5)
