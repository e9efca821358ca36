"""Shared fixtures of the port's router, self-healing and weight-publish
tests (``tests/test_torch_{router,self_healing,weight_publish}.py``): the
reference's qwen3 serving toy with the JAX package's weights carried into
the port's model, and the port's router and engine bound to the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import build_foundation_model
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.serving import InferenceEngine as _Engine
from veomni_tpu_torch.serving import Router as _Router
from veomni_tpu_torch.serving import host_state

QWEN3 = dict(
    model_type="qwen3", vocab_size=128, hidden_size=64,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, qk_norm=True,
)

# the tests run the port on the CPU (its entry points default to the card)
Router = functools.partial(_Router, device="cpu")
InferenceEngine = functools.partial(_Engine, device="cpu")


@functools.lru_cache(maxsize=None)
def qwen3_models():
    """(jax params, jax cfg, port model, port cfg) with the same weights."""
    jcfg = JaxConfig(dtype=jnp.float32, **QWEN3)
    params = build_foundation_model(config=jcfg).family.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(dtype=torch.float32, **QWEN3)
    model = Transformer(cfg, None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, jcfg, model, cfg


def perturb(model, seed=7, scale=0.1):
    """A payload congruent with ``model`` but decisively different: its
    state with per-tensor additive noise big enough to move greedy argmaxes
    (``tests/test_weight_publish.py::_perturb``)."""
    rng = np.random.default_rng(seed)
    return {name: t + torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32) * scale)
            for name, t in host_state(model).items()}
