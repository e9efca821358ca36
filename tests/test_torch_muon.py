"""The port's Muon (``veomni_tpu_torch/optim/muon.py``) against the JAX one.

* ``newton_schulz`` against ``veomni_tpu.optim.muon._newton_schulz`` on
  seeded matrices, wide, tall and batched: rtol 2e-5 / atol 2e-6 (f32,
  five quintic iterations whose products XLA and torch sum in other
  orders).
* Three updates of ``build_optimizer(optimizer="muon")`` against the
  reference's ``build_muon`` (through its ``build_optimizer``) on a MoE toy
  with tied embeddings and weight decay, from the same seeded gradients:
  the tree holds ``[L, d]`` norm leaves (orthogonalised jointly),
  ``[L, E, m, n]`` experts, an ``[L, d, E]`` router and the embedding on
  AdamW. Each parameter's total change agrees within 1e-4 of that leaf's
  largest change (the Newton–Schulz tolerance carried through the update).
* The joint orthogonalisation pinned: a stacked norm leaf's update is the
  Newton–Schulz of the ``[L, d]`` stack, not of each layer's row.
* ``TextTrainer`` with ``optimizer: muon`` at ``tests/test_muon.py``'s toy
  against the JAX trainer from the same weights (loss and grad norm rtol
  1e-5 each step), and a resumed run bit-identical to a straight one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.optim.muon import _newton_schulz as j_newton_schulz
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params, reference_leaves, to_jax_tree
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.optim.muon import newton_schulz
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextTrainer

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

LR = dict(lr_decay_style="cosine", lr=1e-3, train_steps=4, lr_warmup_steps=1, lr_min=1e-4)
MOE_TOY = dict(model_type="qwen3_moe", vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               qk_norm=True, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def set_grads_from_tree(model, tree):
    """Give each port parameter its slice of a JAX-layout gradient tree."""
    flat = _flatten(tree)
    for path, params, stacked in reference_leaves(model):
        leaf = np.asarray(flat[path])
        for i, p in enumerate(params):
            p.grad = torch.from_numpy(np.array(leaf[i] if stacked else leaf))


def moe_models(seed=0):
    jcfg = JaxConfig(dtype=jnp.float32, tie_word_embeddings=True, **MOE_TOY)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    model = Transformer(TransformerConfig(dtype=torch.float32, tie_word_embeddings=True,
                                          **MOE_TOY), torch.Generator().manual_seed(seed),
                        device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return params, model


@pytest.mark.parametrize("shape", [(24, 40), (40, 24), (3, 16, 32)], ids=["wide", "tall", "batch"])
def test_newton_schulz_matches_jax(shape):
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_newton_schulz(jnp.asarray(g)))
    got = newton_schulz(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_muon_matches_optax_on_the_stacked_tree():
    params, model = moe_models()
    init = jax.tree.map(np.array, to_jax_tree(model))  # a copy: top-level leaves alias
    j_opt = j_build_optimizer(params, optimizer="muon", lr=j_build_lr_scheduler(**LR),
                              weight_decay=0.1)
    j_state = j_opt.init(params)
    update = jax.jit(j_opt.update)
    t_opt = build_optimizer(model, optimizer="muon", lr=build_lr_scheduler(**LR),
                            weight_decay=0.1)
    labels = t_opt.labels
    assert labels["embed_tokens"] == labels["norm"] == "adamw"
    assert "lm_head" not in labels  # tied
    for path in ("layers.input_layernorm", "layers.q_norm", "layers.router",
                 "layers.experts.gate_proj", "layers.q_proj"):
        assert labels[path] == "muon", path
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
                             params)
        updates, j_state = update(grads, j_state, params)
        params = optax.apply_updates(params, updates)
        set_grads_from_tree(model, grads)
        t_opt.step()
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    for path, got in jax.tree_util.tree_leaves_with_path(to_jax_tree(model)):
        want = np.asarray(ref[path]) - start[path]
        moved = got - start[path]
        scale = np.abs(want).max()
        assert scale > 0, jax.tree_util.keystr(path)
        assert np.abs(moved - want).max() <= 1e-4 * scale, jax.tree_util.keystr(path)


def test_stacked_norm_leaf_is_orthogonalised_jointly():
    _, model = moe_models()
    opt = build_optimizer(model, optimizer="muon", lr=lambda n: 1.0)
    norms = [layer.get_parameter("input_layernorm") for layer in model.layers]
    rng = np.random.default_rng(1)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
    before = torch.stack([p.detach().clone() for p in norms])
    grads = torch.stack([p.grad for p in norms])
    opt.step()
    moved = torch.stack([p.detach() for p in norms]) - before
    eff = 1.95 * grads  # first step: buf = g, Nesterov eff = 0.95 g + g
    joint = -newton_schulz(eff)  # [3, 64]: m < n, scale 1
    per_row = -torch.cat([newton_schulz(row[None]) for row in eff])
    torch.testing.assert_close(moved, joint, rtol=1e-4, atol=1e-6)
    assert (moved - per_row).abs().max() > 1e-2  # ~0.06 apart: 600x the tolerance above


def _muon_args(args):
    args.train.optimizer = "muon"
    return args


def test_muon_trainer_matches_jax_trainer(tmp_path):
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer

    from test_e2e_training import _make_args, _write_dummy_data
    from test_torch_trainer import port_args, record_steps

    _write_dummy_data(tmp_path / "data.jsonl")
    j_trainer = JaxTextTrainer(_muon_args(_make_args(tmp_path, train_steps=4)))
    init = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    trainer = TextTrainer(_muon_args(port_args(tmp_path, train_steps=4)))
    load_jax_params(trainer.train_state.model, init)
    seen = record_steps(trainer)
    assert trainer.train().global_step == 4
    trainer.checkpointer.close()
    got, ref = np.array(seen), np.array(j_seen)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-5, err_msg="grad_norm")


def test_muon_resume_is_bit_exact(tmp_path):
    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import StopAt, assert_bit_identical, port_args, record_steps, \
        state_tensors

    _write_dummy_data(tmp_path / "data.jsonl")
    a = TextTrainer(_muon_args(port_args(tmp_path, "a", train_steps=4)))
    losses_a = record_steps(a)
    a.train()
    ref = state_tensors(a)
    a.checkpointer.close()
    destroy_parallel_state()
    b1 = TextTrainer(_muon_args(port_args(tmp_path, "b", train_steps=4, save_steps=2)))
    b1.callbacks.append(StopAt(2))
    losses_b = record_steps(b1)
    b1.train()
    b1.checkpointer.close()
    destroy_parallel_state()
    b2 = TextTrainer(_muon_args(port_args(tmp_path, "b", train_steps=4, save_steps=2)))
    losses_b2 = record_steps(b2)
    assert b2.train().global_step == 4
    assert losses_b + losses_b2 == losses_a
    assert_bit_identical(ref, state_tensors(b2), "resumed muon state")
    b2.checkpointer.close()
