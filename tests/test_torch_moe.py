"""Port MoE path (veomni_tpu_torch) vs the JAX reference, f32 on the CPU.

A 2-layer ``qwen3_moe`` toy (hidden 128, expert width 128, E=4, top-2,
8/4 heads of 16, vocab 512) on packed S=128, B=2 batches, with weights
carried from JAX ``init_params`` by ``load_jax_params`` (the nested
``layers.experts`` subtree and ``layers.router`` included):

* ``route_tokens``: expert indices equal, weights and aux loss within 1e-6;
* ``loss_fn``: the token-sum loss (rtol 1e-5), ``moe_aux_loss`` (rtol 1e-5)
  and every gradient leaf (within 1e-5 of its largest magnitude, the rule of
  ``test_torch_transformer.py``), with the grouped GEMM through the plain
  ragged impl and through the kernels' autograd Function (its plain versions
  on the CPU), under both remat policies;
* three AdamW steps (A=2 micro-batches, clip engaged) against
  ``build_train_step``: loss, grad norm and ``moe_aux_loss`` rtol 1e-5, final
  parameters atol 2e-6 (Adam eps 1e-5, see ``test_torch_train_step.py``);
* ``load_balancing_loss`` with and without ``valid_mask`` (rtol 1e-6);
* ``FlopsCounter`` at the Qwen3-30B-A3B widths equal to the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.data.data_collator import stack_micro_batches
from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu.ops.load_balancing import _lbl_xla as j_lbl
from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.train import build_train_state as j_build_train_state
from veomni_tpu.train import build_train_step as j_build_train_step
from veomni_tpu.utils.count_flops import FlopsCounter as JaxFlopsCounter
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from veomni_tpu_torch.models.transformer import route_tokens
from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from veomni_tpu_torch.ops.load_balancing import load_balancing_loss
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.train import build_train_state, build_train_step
from veomni_tpu_torch.train_text_step import bench_config, run_train_steps
from veomni_tpu_torch.utils.count_flops import FlopsCounter

from test_torch_transformer import TOY, assert_tree_close, toy_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

MOE_TOY = dict(TOY, model_type="qwen3_moe", num_hidden_layers=2, num_experts=4,
               num_experts_per_tok=2, moe_intermediate_size=128)
T = torch.from_numpy


def moe_models(remat_policy="nothing", seed=0, **extra):
    jcfg = JaxConfig(dtype=jnp.float32, **MOE_TOY, **extra)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = TransformerConfig(dtype=torch.float32, remat_policy=remat_policy, **MOE_TOY, **extra)
    model = Transformer(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def test_moe_weights_round_trip():
    _, params, model = moe_models()
    assert set(params["layers"]["experts"]) == {"gate_proj", "up_proj", "down_proj"}
    assert_tree_close(to_jax_tree(model), params, 0.0)


@pytest.mark.parametrize("norm_topk_prob,scaling", [(True, 1.0), (False, 2.5)],
                         ids=["renorm", "scaled"])
def test_route_tokens_match_jax(norm_topk_prob, scaling):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    router = (rng.standard_normal((128, 4)) * 0.2).astype(np.float32)
    extra = dict(norm_topk_prob=norm_topk_prob, routed_scaling_factor=scaling)
    jcfg = JaxConfig(dtype=jnp.float32, **MOE_TOY, **extra)
    tcfg = TransformerConfig(dtype=torch.float32, **MOE_TOY, **extra)
    idx_j, w_j, aux_j = jtf.route_tokens(jnp.asarray(x), {"router": jnp.asarray(router)}, jcfg)
    idx_t, w_t, aux_t = route_tokens(T(x), T(router), tcfg)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize(
    "group_gemm_impl,remat_policy",
    [("xla", "nothing"), ("cuda_gmm", "ctx"), ("xla", "ctx"), ("cuda_gmm", "nothing")],
    ids=["ragged-nothing", "kernel-plain-ctx", "ragged-ctx", "kernel-plain-nothing"],
)
def test_moe_loss_and_grads_match_jax(group_gemm_impl, remat_policy):
    jcfg, params, model = moe_models(remat_policy=remat_policy)
    batch = toy_batch(True)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    gg.reset_counts()
    apply_ops_config({"group_gemm": group_gemm_impl})
    try:
        loss_t, metrics_t = model.loss_fn({k: T(v) for k, v in batch.items()})
        loss_t.backward()
    finally:
        apply_ops_config(None)
    assert sum(gg.LAUNCHES.values()) == 0  # CPU tensors: the plain versions, no launch
    assert set(metrics_t) == set(metrics_j)
    assert int(metrics_t["ntokens"]) == int(metrics_j["ntokens"])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(metrics_t["moe_aux_loss"].item(), float(metrics_j["moe_aux_loss"]),
                               rtol=1e-5)
    assert float(metrics_t["moe_dropped_frac"]) == float(metrics_j["moe_dropped_frac"]) == 0.0
    assert_tree_close(to_jax_tree(model, grads=True), grads_j, 1e-5)


LR = dict(lr_decay_style="cosine", lr=1e-3, train_steps=4, lr_warmup_steps=1, lr_min=1e-4)


def test_three_moe_steps_match_jax():
    jcfg, params, model = moe_models(remat_policy="ctx")
    batches = [stack_micro_batches([toy_batch(True, seed=3 * i + a) for a in range(2)])
               for i in range(3)]
    j_opt = j_build_optimizer(params, lr=j_build_lr_scheduler(**LR), weight_decay=0.1, eps=1e-5)
    j_state = j_build_train_state(params, j_opt)
    j_step = j_build_train_step(lambda p, micro: jtf.loss_fn(p, jcfg, micro), j_opt, None,
                                max_grad_norm=1.0)
    t_state = build_train_state(model, build_optimizer(
        model, lr=build_lr_scheduler(**LR), weight_decay=0.1, eps=1e-5))
    t_step = build_train_step(Transformer.loss_fn, max_grad_norm=1.0)
    clipped = False
    for batch in batches:
        j_state, jm = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, tm = t_step(t_state, {k: T(v) for k, v in batch.items()})
        assert int(tm["ntokens"]) == int(jm["ntokens"]) and bool(tm["step_ok"])
        for key in ("loss", "grad_norm", "moe_aux_loss", "loss_sum"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        clipped |= float(jm["grad_norm"]) > 1.0
    assert clipped, "the clip must engage for this test to cover it"
    for got, ref in zip(jax.tree.leaves(to_jax_tree(model)), jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["all-tokens", "valid-mask"])
def test_load_balancing_loss_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    mask = (rng.random(64) > 0.3) if masked else None
    ref = j_lbl(jnp.asarray(probs), jnp.asarray(idx), 8,
                None if mask is None else jnp.asarray(mask))
    got = load_balancing_loss(T(probs), T(idx), 8, None if mask is None else T(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("preset", ["qwen3_30b_a3b", "qwen3_0p6b"])
def test_flops_counter_matches_reference(preset):
    """The port's FlopsCounter (MoE branch: top-k experts + router) against the
    reference's, both built from the same config object."""
    cfg = bench_config(preset)
    got, ref = FlopsCounter.from_config(cfg), JaxFlopsCounter.from_config(cfg)
    for seq in (1024, 4096):
        assert got.flops_per_token_fwd(seq) == ref.flops_per_token_fwd(seq)
        assert got.batch_flops(4 * seq, seq) == ref.batch_flops(4 * seq, seq)


def test_moe_train_steps_on_cpu():
    """The MoE entry point end to end at a CPU size: finite steps that
    report the router aux loss (about 1 per layer when balanced)."""
    records = run_train_steps(128, 2, 2, preset="qwen3_moe_smoke", device="cpu")
    for r in records:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["step_ok"]
        assert 1.0 <= r["moe_aux_loss"] < 4.0 and r["moe_dropped_frac"] == 0.0
