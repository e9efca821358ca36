"""The port's optimizer parameter groups and frozen-gradient mask against the
JAX package's, on the CPU, at ``tests/test_torch_transformer.py``'s toy.

* ``with_param_groups`` (``freeze_patterns`` over the embedding, two
  ``lr_scales`` regexes of which the first match wins) on AdamW with weight
  decay: three updates from identical gradients agree with the reference's
  optax transform to f32 rounding (rtol 5e-7 / atol 5e-8, the tolerance of
  ``test_adamw_matches_optax_on_identical_grads``); the frozen parameters
  are bit-unchanged in both.
* The train step's ``grad_mask`` with the groups, as the trainers build
  them: one step with the embedding frozen gives
  the JAX step's loss and grad norm (rtol 1e-5), the grad norm is the norm
  of the unfrozen gradients alone, and the frozen weights stay bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from veomni_tpu.data.data_collator import stack_micro_batches
from veomni_tpu.models import transformer as jtf
from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.optim.optimizer import with_param_groups as j_with_param_groups
from veomni_tpu.train import build_train_state as j_build_train_state
from veomni_tpu.train import build_train_step as j_build_train_step
from veomni_tpu_torch.models import Transformer
from veomni_tpu_torch.models.jax_weights import named_jax_parameters, to_jax_tree
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.optim.optimizer import with_param_groups
from veomni_tpu_torch.train import build_train_state, build_train_step

from test_torch_train_step import LR, WEIGHT_DECAY, _set_grads
from test_torch_transformer import jax_and_torch_models, toy_batch

FREEZE = (r"^embed_tokens$",)
# q_proj at 0.1, every other projection at 0.5 (first match wins)
SCALES = {r"layers\.q_proj$": 0.1, r"_proj$": 0.5}


def test_with_param_groups_matches_optax_on_identical_grads():
    _, params, model = jax_and_torch_models()
    j_opt = j_with_param_groups(
        j_build_optimizer(params, lr=j_build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY),
        params, freeze_patterns=FREEZE, lr_scales=SCALES)
    j_state = j_opt.init(params)
    j_update = jax.jit(j_opt.update)
    t_opt = with_param_groups(
        build_optimizer(model, lr=build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY),
        named_jax_parameters(model), freeze_patterns=FREEZE, lr_scales=SCALES)
    assert sorted({g["lr_scale"] for g in t_opt.param_groups}) == [0.0, 0.1, 0.5, 1.0]
    embed_before = model.embed_tokens.detach().clone()
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32), params)
        updates, j_state = j_update(grads, j_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads)
        t_opt.step()
    for got, ref in zip(jax.tree.leaves(to_jax_tree(model)), jax.tree.leaves(params)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-7, atol=5e-8)
    assert torch.equal(model.embed_tokens, embed_before)
    np.testing.assert_array_equal(np.asarray(params["embed_tokens"]), embed_before.numpy())


def test_grad_mask_zeroes_frozen_grads_before_the_clip():
    jcfg, params, model = jax_and_torch_models()
    batch = stack_micro_batches([toy_batch(True, seed=a) for a in range(2)])
    mask = jax.tree_util.tree_map_with_path(
        lambda p, _: 0.0 if jax.tree_util.keystr(p) == "['embed_tokens']" else 1.0, params)
    j_opt = j_with_param_groups(j_build_optimizer(params, lr=1e-3, weight_decay=WEIGHT_DECAY),
                                params, freeze_patterns=FREEZE)
    j_step = j_build_train_step(lambda p, micro: jtf.loss_fn(p, jcfg, micro), j_opt, None,
                                max_grad_norm=0.5, grad_mask=mask)
    j_state, jm = j_step(j_build_train_state(params, j_opt),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    frozen = [p for path, p in named_jax_parameters(model) if path == "embed_tokens"]
    opt = with_param_groups(build_optimizer(model, lr=1e-3, weight_decay=WEIGHT_DECAY),
                            named_jax_parameters(model), freeze_patterns=FREEZE)
    embed_before = model.embed_tokens.detach().clone()
    step = build_train_step(Transformer.loss_fn, max_grad_norm=0.5, grad_mask=frozen)
    _, tm = step(build_train_state(model, opt), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert not model.embed_tokens.grad.any()
    rest = [p.grad for p in model.parameters() if p is not model.embed_tokens]
    # the clip engaged, on the unfrozen grads alone: their norm is now the bound
    clipped = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in rest])))
    np.testing.assert_allclose(clipped, 0.5, rtol=1e-4)
    assert float(tm["grad_norm"]) > 0.5
    assert torch.equal(model.embed_tokens, embed_before)
    np.testing.assert_array_equal(np.asarray(j_state.params["embed_tokens"]),
                                  embed_before.numpy())
