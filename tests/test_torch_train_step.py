"""Port train step + AdamW + LR schedule vs JAX build_train_step/build_optimizer.

Three steps at the toy dims in f32 with A=2 micro-batches per step, warmup +
cosine LR, global-norm clipping that engages, and weight decay: the port's
loss and grad-norm trajectory and its final parameters match JAX's
(loss and grad_norm rtol 1e-5, params atol 2e-6, i.e. 0.2% of the peak lr).

That trajectory test runs Adam with eps=1e-5. The two frameworks' gradients
agree to ~1e-6 of each leaf's largest magnitude, ~3e-8 after token
normalization and clipping here; Adam's update g / (|g| + eps) turns such a
difference into up to (3e-8 / eps) x lr of displacement for an element whose
gradient is near eps, i.e. O(lr) at the default eps=1e-8. The optimizer
itself is held at the default eps=1e-8 by feeding both the same gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.data.data_collator import TextPackingCollator as JaxCollator
from veomni_tpu.data.data_collator import stack_micro_batches
from veomni_tpu.models import transformer as jtf
from veomni_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from veomni_tpu.optim import build_optimizer as j_build_optimizer
from veomni_tpu.train import build_train_state as j_build_train_state
from veomni_tpu.train import build_train_step as j_build_train_step
from veomni_tpu_torch.data import TextPackingCollator
from veomni_tpu_torch.models import Transformer
from veomni_tpu_torch.models.jax_weights import to_jax_tree
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.train import build_train_state, build_train_step

from test_torch_transformer import jax_and_torch_models, toy_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

LR = dict(lr_decay_style="cosine", lr=1e-3, train_steps=4, lr_warmup_steps=1, lr_min=1e-4)
MAX_GRAD_NORM = 1.0
WEIGHT_DECAY = 0.1
EPS = 1e-5  # see the module docstring


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_step_metrics_match_jax(moe):
    """One step of A=2 micro-batches: the same metric keys as the reference's
    step, the loss fn's scalar extras (loss_sum, moe_aux_loss,
    moe_dropped_frac) averaged over the micro-batches, values rtol 1e-5."""
    if moe:
        from test_torch_moe import moe_models

        jcfg, params, model = moe_models()
    else:
        jcfg, params, model = jax_and_torch_models()
    batch = stack_micro_batches([toy_batch(True, seed=a) for a in range(2)])
    j_opt = j_build_optimizer(params, lr=1e-3)
    j_step = j_build_train_step(lambda p, micro: jtf.loss_fn(p, jcfg, micro), j_opt, None)
    _, jm = j_step(j_build_train_state(params, j_opt), {k: jnp.asarray(v) for k, v in batch.items()})
    t_step = build_train_step(Transformer.loss_fn)
    _, tm = t_step(build_train_state(model, build_optimizer(model, lr=1e-3)),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert (float(tm["moe_aux_loss"]) > 0) == moe


def test_lr_schedule_matches_optax():
    for kw in (LR, dict(lr_decay_style="linear", lr=2e-3, train_steps=10, lr_warmup_ratio=0.3),
               dict(lr_decay_style="constant", lr=5e-4, train_steps=7)):
        ref, got = j_build_lr_scheduler(**kw), build_lr_scheduler(**kw)
        for n in range(12):
            np.testing.assert_allclose(got(n), float(ref(n)), rtol=1e-6, atol=1e-12)


def test_three_steps_match_jax():
    jcfg, params, model = jax_and_torch_models(remat_policy="ctx")
    batches = [stack_micro_batches([toy_batch(True, seed=3 * i + a) for a in range(2)])
               for i in range(3)]

    j_opt = j_build_optimizer(params, lr=j_build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY,
                              eps=EPS)
    j_state = j_build_train_state(params, j_opt)
    j_step = j_build_train_step(lambda p, micro: jtf.loss_fn(p, jcfg, micro), j_opt, None,
                                max_grad_norm=MAX_GRAD_NORM)
    t_state = build_train_state(model, build_optimizer(
        model, lr=build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY, eps=EPS))
    t_step = build_train_step(Transformer.loss_fn, max_grad_norm=MAX_GRAD_NORM)

    clipped = False
    for batch in batches:
        j_state, jm = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert int(tm["ntokens"]) == int(jm["ntokens"]) and bool(tm["step_ok"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        clipped |= float(jm["grad_norm"]) > MAX_GRAD_NORM
    assert clipped, "the clip must engage for this test to cover it"
    assert t_state.step == 3 and t_state.optimizer.num_updates == 3
    for got, ref in zip(jax.tree.leaves(to_jax_tree(model)), jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-6)


def _set_grads(model, tree):
    """Give each port parameter the matching leaf of a JAX-layout tree."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = tree["layers"][parts[2]][int(parts[1])] if parts[0] == "layers" else tree[name]
        p.grad = torch.from_numpy(np.array(leaf))


def test_adamw_matches_optax_on_identical_grads():
    """Default eps=1e-8, warmup + cosine, weight decay (the reference's mask:
    per-layer norm weights decayed, the final norm not): 3 updates from the
    same gradients agree to f32 rounding: rtol 5e-7 / atol 5e-8, a few ulps
    of each parameter."""
    import optax

    _, params, model = jax_and_torch_models()
    j_opt = j_build_optimizer(params, lr=j_build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY)
    j_state = j_opt.init(params)
    t_opt = build_optimizer(model, lr=build_lr_scheduler(**LR), weight_decay=WEIGHT_DECAY)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32), params)
        updates, j_state = j_opt.update(grads, j_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads)
        t_opt.step()
    for got, ref in zip(jax.tree.leaves(to_jax_tree(model)), jax.tree.leaves(params)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-7, atol=5e-8)


def test_skip_nonfinite_leaves_state_untouched():
    _, _, model = jax_and_torch_models()
    state = build_train_state(model, build_optimizer(model, lr=1e-3))
    before = [p.detach().clone() for p in model.parameters()]

    def nan_loss(m, micro):
        loss, metrics = m.loss_fn(micro)
        return loss * float("nan"), metrics

    step = build_train_step(nan_loss, skip_nonfinite=True)
    batch = stack_micro_batches([toy_batch(True)])
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not bool(metrics["step_ok"])
    assert state.step == 1 and state.optimizer.num_updates == 0
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_packing_collator_copy_matches_reference():
    """The port's TextPackingCollator copy packs seeded documents (with
    prompt-masked labels, an oversized sample and carry-over) exactly as the
    reference does."""
    rng = np.random.default_rng(11)
    ref, got = JaxCollator(64, 3), TextPackingCollator(64, 3)
    for _ in range(3):
        docs = []
        for n in rng.integers(5, 40, 7):
            ids = rng.integers(0, 500, int(n))
            docs.append({"input_ids": ids, "labels": np.where(np.arange(n) < 3, -100, ids)})
        docs.append({"input_ids": rng.integers(0, 500, 80)})  # oversized: dropped
        a, b = ref(docs), got(docs)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])
        assert got.carryover_len() == ref.carryover_len()
    assert got.dropped_oversized == ref.dropped_oversized == 3
