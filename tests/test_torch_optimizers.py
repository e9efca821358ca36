"""The port's other optimizers against optax, on the CPU.

``build_optimizer``'s ``anyprecision_adamw`` (first moment stored in bf16),
``adafactor`` at optax's defaults and ``sgd``, at
``tests/test_torch_transformer.py``'s toy (hidden 128, 4 layers, f32): three
updates from the same seeded gradients (numpy, seed 7) through the JAX
``build_optimizer`` and the port's, then every parameter compared. The toy
holds Adafactor's both branches: ``q_proj`` [4, 128, 128] and the embedding
[512, 128] are factored (their second largest axis is 128), a norm [4, 128]
and the final norm [128] are not. Tolerances (f32):

* SGD: rtol 1e-7, atol 1e-9 (one product and one sum a parameter);
* ``anyprecision_adamw``: rtol 5e-7 / atol 2e-7. optax multiplies the
  stored bf16 moment by b1 taken in bf16 (0.8984375), which the port
  mirrors; a sum one f32 ulp apart can still round to a bf16 moment one
  bf16 ulp (at most 2**-7 of it) apart, so the stored moments agree within
  rtol 2**-7 and the parameters a few f32 ulps wider than AdamW's 5e-8;
* Adafactor: rtol 2e-6 / atol 1e-8 (means over 128-wide rows and ``x **
  -0.5`` in another order than XLA's).

Also: ``with_param_groups`` over each and over Muon (three updates with a
frozen embedding and a 0.5 scale on the projections, against optax's
``with_param_groups``; Muon's parameters within rtol 1e-6 / atol 5e-8,
~1e-4 of its ~1e-4 steps: its Newton–Schulz products sum in another order
than XLA's), an unknown name raising ``ValueError`` as the
reference does, and a resume of each through the port's checkpoint payload
that continues bit-identically.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.optim.optimizer import with_param_groups as j_with_param_groups
from veomni_tpu_torch.checkpoint.checkpointer import load_state_into, snapshot_state
from veomni_tpu_torch.models.jax_weights import named_jax_parameters, to_jax_tree
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.optim.optimizer import with_param_groups
from veomni_tpu_torch.train import build_train_state

from test_torch_muon import set_grads_from_tree
from test_torch_train_step import LR, WEIGHT_DECAY
from test_torch_transformer import jax_and_torch_models
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TOL = {"sgd": (1e-7, 1e-9), "anyprecision_adamw": (5e-7, 2e-7), "adafactor": (2e-6, 1e-8),
       "muon": (1e-6, 5e-8)}
FREEZE = (r"^embed_tokens$",)
SCALES = {r"_proj$": 0.5}


def _grads(rng, params):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
                        params)


def _run_both(name, groups=False, steps=3):
    _, params, model = jax_and_torch_models()
    j_opt = j_build_optimizer(params, optimizer=name, lr=j_build_lr_scheduler(**LR),
                              weight_decay=WEIGHT_DECAY)
    t_opt = build_optimizer(model, optimizer=name, lr=build_lr_scheduler(**LR),
                            weight_decay=WEIGHT_DECAY)
    if groups:
        j_opt = j_with_param_groups(j_opt, params, freeze_patterns=FREEZE, lr_scales=SCALES)
        t_opt = with_param_groups(t_opt, named_jax_parameters(model), freeze_patterns=FREEZE,
                                  lr_scales=SCALES)
    j_state = j_opt.init(params)
    update = jax.jit(j_opt.update)
    rng = np.random.default_rng(7)
    embed_before = model.embed_tokens.detach().clone()
    for _ in range(steps):
        grads = _grads(rng, params)
        updates, j_state = update(grads, j_state, params)
        params = optax.apply_updates(params, updates)
        set_grads_from_tree(model, grads)
        t_opt.step()
    return params, j_state, model, t_opt, embed_before


@pytest.mark.parametrize("name", ["sgd", "anyprecision_adamw", "adafactor"])
def test_optimizer_matches_optax(name):
    params, j_state, model, t_opt, _ = _run_both(name)
    rtol, atol = TOL[name]
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, got in jax.tree_util.tree_leaves_with_path(to_jax_tree(model)):
        np.testing.assert_allclose(got, np.asarray(ref[path]), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
    assert t_opt.num_updates == 3
    if name == "anyprecision_adamw":
        mu = j_state[0].mu  # (ScaleByAdamState, ...) of the adamw chain
        assert jax.tree.leaves(mu)[0].dtype == np.dtype("bfloat16")
        q = model.layers[1].get_parameter("q_proj")
        st = t_opt.state[q]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        ref_mu = np.asarray(mu["layers"]["q_proj"][1].astype(np.float32))
        np.testing.assert_allclose(st["exp_avg"].float().numpy(), ref_mu, rtol=2**-7, atol=0)


@pytest.mark.parametrize("name", ["sgd", "anyprecision_adamw", "adafactor", "muon"])
def test_param_groups_over_optimizer(name):
    params, _, model, t_opt, embed_before = _run_both(name, groups=True)
    assert sorted({g["lr_scale"] for g in t_opt.param_groups}) == [0.0, 0.5, 1.0]
    assert torch.equal(model.embed_tokens, embed_before)  # frozen: bit-unchanged
    rtol, atol = TOL[name]
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, got in jax.tree_util.tree_leaves_with_path(to_jax_tree(model)):
        np.testing.assert_allclose(got, np.asarray(ref[path]), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_unknown_optimizer_raises_like_the_reference():
    _, params, model = jax_and_torch_models()
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        j_build_optimizer(params, optimizer="lion")
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        build_optimizer(model, optimizer="lion")


@pytest.mark.parametrize("name", ["sgd", "anyprecision_adamw", "adafactor", "muon"])
def test_resume_through_the_checkpoint_payload_is_bit_identical(name):
    """Four updates straight against two, a snapshot into a fresh model and
    optimizer, and two more: parameters and optimizer state bit-equal."""

    def run(model, opt, grads_list):
        for grads in grads_list:
            set_grads_from_tree(model, grads)
            opt.step()

    _, params, model_a = jax_and_torch_models()
    rng = np.random.default_rng(3)
    grads = [_grads(rng, params) for _ in range(4)]
    opt_a = build_optimizer(model_a, optimizer=name, lr=build_lr_scheduler(**LR),
                            weight_decay=WEIGHT_DECAY)
    run(model_a, opt_a, grads)

    _, _, model_b = jax_and_torch_models()
    opt_b = build_optimizer(model_b, optimizer=name, lr=build_lr_scheduler(**LR),
                            weight_decay=WEIGHT_DECAY)
    run(model_b, opt_b, grads[:2])
    payload = snapshot_state(build_train_state(model_b, opt_b))
    _, _, model_c = jax_and_torch_models(seed=1)  # other weights: the load must overwrite
    opt_c = build_optimizer(model_c, optimizer=name, lr=build_lr_scheduler(**LR),
                            weight_decay=WEIGHT_DECAY)
    load_state_into(build_train_state(model_c, opt_c), payload)
    run(model_c, opt_c, grads[2:])
    assert opt_c.num_updates == 4
    for (n, a), (_, c) in zip(model_a.named_parameters(), model_c.named_parameters()):
        assert torch.equal(a, c), n
        for k, v in opt_a.state[a].items():
            w = opt_c.state[c][k]
            assert v.dtype == w.dtype and torch.equal(v, w), f"{n}.{k}"
