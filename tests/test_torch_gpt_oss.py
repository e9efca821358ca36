"""The gpt_oss dialect of the port's model (attention sinks, the clamped
GLU, router and expert biases, top-k-then-softmax routing) against the JAX
package, on the CPU, at toy sizes.

* ``gated_act('gpt_oss_glu')`` on inputs out to +-24, so both clamps bite:
  rtol 1e-6.
* The gpt_oss ``route_tokens`` with a router bias, on a random router and
  on one whose logits tie (the lower index first among equals, as
  ``lax.top_k``): expert indices equal, weights and aux loss within 1e-6.
* The MoE MLP with expert biases against the reference's ``_moe_mlp``:
  rtol 1e-5.
* The whole model: ``tests/test_serving.py``'s ``GPT_OSS_ISH`` dims (an
  8-token window on alternate layers, sinks, q/k/v/o biases, the clamped
  GLU) with 4 experts at top-2, router and expert biases, and yarn rope;
  every sink and bias drawn away from the init's 0. f32 loss rtol 1e-5 and
  every gradient leaf within 1e-5 of its largest magnitude against
  ``loss_fn`` + ``jax.grad``, through the plain attention under ``ctx``
  remat and through the ``cuda_flash`` wrapper under ``nothing`` (every
  layer has sinks, so each takes the reference's counted dispatch to the
  plain attention); bf16 loss rtol 1e-3.
* Yarn's ``truncate``: at gpt-oss-20b's published rope values the port's
  frequencies equal transformers' ``_compute_yarn_parameters`` (rtol
  1e-6), where the reference, which always rounds the correction range,
  is up to 76% off (ROADMAP.md queue 3). The parity toy above leaves the
  key out, so both sides round.
* ``FlopsCounter`` equal to the reference's on the ``gpt_oss_20b`` preset.
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
from veomni_tpu.ops.rotary import _scale_inv_freq as j_scale_inv_freq
from veomni_tpu.utils.count_flops import FlopsCounter as JaxFlopsCounter
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.models.transformer import check_supported, moe_mlp, route_tokens
from veomni_tpu_torch.ops import gated_act
from veomni_tpu_torch.ops.cuda import flash_attention as fa
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from veomni_tpu_torch.ops.rotary import _scale_inv_freq
from veomni_tpu_torch.train_text_step import HF_CONFIGS
from veomni_tpu_torch.utils.count_flops import FlopsCounter
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy
RTOL = 1e-5
# tests/test_serving.py's GPT_OSS_ISH with 4 experts at top-2, router and
# expert biases (tests/test_hf_parity.py's gpt_oss toy) and yarn rope
TOY = dict(model_type="gpt_oss", vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           attention_sinks=True, attention_bias=True, o_bias=True, sliding_window=8,
           layer_types=["sliding_attention", "full_attention"] * 2, hidden_act="gpt_oss_glu",
           num_experts=4, num_experts_per_tok=2, router_bias=True, mlp_bias=True,
           router_aux_loss_coef=0.9, rope_theta=150000.0,
           rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                         "beta_slow": 1.0, "original_max_position_embeddings": 16})


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_gated_act_matches_jax():
    rng = _rng(1)
    g = (rng.standard_normal((4, 64)) * 8).astype(np.float32)
    u = (rng.standard_normal((4, 64)) * 8).astype(np.float32)
    assert (g > 7).any() and (u > 7).any() and (u < -7).any()
    want = jtf.gated_act(jnp.asarray(g), jnp.asarray(u), JaxConfig(hidden_act="gpt_oss_glu"))
    got = gated_act(T(g), T(u), "gpt_oss_glu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("router_kind", ["random", "ties"])
def test_route_tokens_match_jax(router_kind):
    rng = _rng(2)
    e, k, h = 32, 4, 48
    x = rng.standard_normal((96, h)).astype(np.float32)
    if router_kind == "random":
        router = (rng.standard_normal((h, e)) * 0.2).astype(np.float32)
        bias = (rng.standard_normal(e) * 0.1).astype(np.float32)
    else:
        # at most 3 distinct logits a token, and a bias of 2 values: ties
        # across the top k and at its edge
        cols = (rng.standard_normal((h, 3)) * 0.2).astype(np.float32)
        router = cols[:, rng.integers(0, 3, e)]
        bias = np.where(rng.random(e) < 0.5, 0.0, 0.5).astype(np.float32)
    fields = dict(TOY, num_experts=e, num_experts_per_tok=k, hidden_size=h)
    lp = {"router": jnp.asarray(router), "router_bias": jnp.asarray(bias)}
    idx_j, w_j, aux_j = jtf.route_tokens(jnp.asarray(x), lp,
                                         JaxConfig(dtype=jnp.float32, **fields))
    idx_t, w_t, aux_t = route_tokens(T(x), T(router), TransformerConfig(dtype=torch.float32,
                                                                        **fields),
                                     router_bias=T(bias))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)
    if router_kind == "ties":  # the ties reach the top k
        logits = x @ router + bias
        kth = np.sort(logits, -1)[:, -k]
        assert ((logits == kth[:, None]).sum(-1) > 1).any()


def test_moe_mlp_with_expert_biases_matches_jax():
    """Router bias, per-expert gate/up/down biases and the clamped GLU
    (weights large enough that the clamps bite) against ``_moe_mlp``."""
    from types import SimpleNamespace

    rng = _rng(3)
    t, h, e, im = 80, 32, 8, 24
    fields = dict(TOY, hidden_size=h, num_experts=e, num_experts_per_tok=3,
                  intermediate_size=im)

    def draw(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = draw(t, h, scale=2.0)
    lp = {"router": draw(h, e), "router_bias": draw(e, scale=0.3),
          "experts": {"gate_proj": draw(e, h, im, scale=0.8), "up_proj": draw(e, h, im, scale=0.8),
                      "down_proj": draw(e, im, h), "gate_bias": draw(e, im, scale=0.5),
                      "up_bias": draw(e, im, scale=0.5), "down_bias": draw(e, h, scale=0.5)}}
    want, aux_j = jtf._moe_mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                               JaxConfig(dtype=jnp.float32, **fields))
    got, aux_t = moe_mlp(T(x), T(lp["router"]),
                         SimpleNamespace(**{k: T(v) for k, v in lp["experts"].items()}),
                         TransformerConfig(dtype=torch.float32, **fields),
                         router_bias=T(lp["router_bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: loss and gradients against the JAX loss_fn
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params():
    """The reference's tree for ``TOY``, its structure traced from
    ``init_params`` (``jax.eval_shape``), its leaves drawn from numpy:
    matrices N(0, 0.05), norm weights 1 + N(0, 0.2), biases N(0, 0.1) and
    sinks N(0, 1) (the init's 0 would hide a dropped sink or bias)."""
    jcfg = JaxConfig(dtype=jnp.float32, **TOY)
    shapes = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    rng = _rng(0)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(x.shape).astype(np.float32)
        if name.endswith("norm']"):
            return jnp.asarray(1 + 0.2 * z)
        if name.endswith("sinks']"):
            return jnp.asarray(z)
        return jnp.asarray((0.1 if "bias" in name else 0.05) * z)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _models(remat_policy="ctx"):
    jcfg = JaxConfig(dtype=jnp.float32, **TOY)
    model = Transformer(TransformerConfig(dtype=torch.float32, remat_policy=remat_policy, **TOY),
                        None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, _jax_params()))
    return jcfg, model


def _batch(seed=0, b=2, s=64):
    rng = _rng(seed)
    docs = [{"input_ids": rng.integers(0, TOY["vocab_size"], int(n))}
            for n in rng.integers(12, 40, 6)]
    return TextPackingCollator(s, b)(docs)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads():
    jcfg, _ = _models()
    loss = functools.partial(jtf.loss_fn, cfg=jcfg,
                             batch={k: jnp.asarray(v) for k, v in _batch().items()})
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(_jax_params())
    return (float(loss_j), float(metrics_j["moe_aux_loss"]), int(metrics_j["ntokens"]),
            jax.tree.map(np.asarray, grads_j))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_results():
    yield
    _jax_loss_grads.cache_clear()
    _jax_params.cache_clear()


def _assert_grads_close(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for key in ref:
            _assert_grads_close(got[key], ref[key], f"{path}/{key}")
        return
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0, path
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize("attention_impl,remat_policy",
                         [("xla", "ctx"), ("cuda_flash", "nothing")],
                         ids=["plain-ctx", "flash-nothing"])
def test_loss_and_grads_match_jax(attention_impl, remat_policy):
    _, model = _models(remat_policy)
    loss_j, aux_j, ntokens_j, grads_j = _jax_loss_grads()
    fa.reset_counts()
    apply_ops_config({"attention": attention_impl})
    try:
        loss_t, metrics_t = model.loss_fn({k: T(v) for k, v in _batch().items()})
        loss_t.backward()
    finally:
        apply_ops_config(None)
    assert int(metrics_t["ntokens"]) == ntokens_j
    # through cuda_flash each layer (sinks on all four) is one dispatch to
    # the plain attention, two under "nothing" (backward reruns the layer)
    assert fa.FALLBACK_CALLS == (8 if attention_impl == "cuda_flash" else 0)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=RTOL)
    np.testing.assert_allclose(metrics_t["moe_aux_loss"].item(), aux_j, rtol=RTOL)
    grads_t = to_jax_tree(model, grads=True)
    for name in ("sinks", "router_bias", "o_bias"):
        assert name in grads_t["layers"]
    assert {"gate_bias", "up_bias", "down_bias"} <= set(grads_t["layers"]["experts"])
    _assert_grads_close(grads_t, grads_j)


def test_bf16_loss_matches_jax():
    """The toy in bf16 (compute dtype) against the reference's bf16 loss:
    rtol 1e-3."""
    jcfg = JaxConfig(dtype=jnp.bfloat16, **TOY)
    model = Transformer(TransformerConfig(dtype=torch.bfloat16, **TOY), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, _jax_params()))
    data = _batch()
    loss_j, _ = jax.jit(functools.partial(jtf.loss_fn, cfg=jcfg))(
        _jax_params(), batch={k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        loss_t, _ = model.loss_fn({k: T(v) for k, v in data.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-3)


# ---------------------------------------------------------------------------
# yarn's truncate, the flops counter, the gate
# ---------------------------------------------------------------------------
def test_yarn_frequencies_match_transformers_without_truncation():
    transformers = pytest.importorskip("transformers")
    from transformers.modeling_rope_utils import _compute_yarn_parameters

    published = HF_CONFIGS["gpt_oss_20b"]
    rs = published["rope_scaling"]
    assert rs["truncate"] is False
    hf_cfg = transformers.GptOssConfig(**{k: v for k, v in published.items()
                                          if k not in ("architectures", "torch_dtype")})
    want, want_att = _compute_yarn_parameters(hf_cfg, "cpu")
    d, theta = published["head_dim"], float(published["rope_theta"])
    base = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    got, _ = _scale_inv_freq(base, rs, d, theta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    # the attention factor the port puts on its tables (rotary_tables)
    cfg = TransformerConfig.from_hf_config(published)
    from veomni_tpu_torch.ops.rotary import rotary_tables

    cos, _ = rotary_tables(torch.zeros((1, 1), dtype=torch.long), d, theta,
                           rope_scaling=cfg.rope_scaling)
    np.testing.assert_allclose(cos[0, 0, 0].item(), want_att, rtol=1e-6)
    # the reference rounds the correction range out ([8, 18] for [8.09, 17.4])
    ref, _ = j_scale_inv_freq(jnp.asarray(base.numpy()), rs, d, theta)
    rel = np.abs(np.asarray(ref) - want.numpy()) / want.numpy()
    assert (rel > 1e-3).sum() == 9 and rel.max() > 0.7
    # with truncate left out (or true) both round, and agree
    rounded = {k: v for k, v in rs.items() if k != "truncate"}
    ref, _ = j_scale_inv_freq(jnp.asarray(base.numpy()), rounded, d, theta)
    got, _ = _scale_inv_freq(base, rounded, d, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_flops_match_jax():
    tcfg = TransformerConfig.from_hf_config(HF_CONFIGS["gpt_oss_20b"])
    jcfg = JaxConfig.from_hf_config(HF_CONFIGS["gpt_oss_20b"])
    for seq in (4096, 333):
        np.testing.assert_allclose(FlopsCounter.from_config(tcfg).flops_per_token_fwd(seq),
                                   JaxFlopsCounter.from_config(jcfg).flops_per_token_fwd(seq),
                                   rtol=1e-12)


@pytest.mark.parametrize("extra", [
    dict(attention_sinks=True), dict(hidden_act="gpt_oss_glu"), dict(router_bias=True),
    dict(mlp_bias=True), dict(model_type="gpt_oss"),
], ids=["sinks", "gpt-oss-glu", "router-bias", "expert-biases", "gpt-oss-routing"])
def test_ported_features_pass_the_gate(extra):
    check_supported(TransformerConfig(**{**TOY, "attention_sinks": False, "router_bias": False,
                                         "mlp_bias": False, "hidden_act": "silu",
                                         "model_type": "qwen3_moe", **extra}))
