"""The port's DPO trainer (``veomni_tpu_torch/trainer/dpo_trainer.py``)
against the JAX one, on the CPU.

* The ``dpo`` transform and ``DPOPairCollator`` give the reference's arrays
  on the same rows (token ids, and text through the ``bytelevel`` fixture
  tokenizer).
* The trainers on the e2e toy (``tests/test_e2e_training.py``: 2 layers,
  hidden 64, f32) from the same initial weights (the JAX trainer's, carried
  over), full-parameter and with LoRA (rank 4; the fresh adapter's bare base
  is the reference policy): three steps' loss, grad norm and ``dpo_acc``;
  step 1's loss is ln 2 per pair in both (policy = reference); then, on the
  trained weights (nonzero margins), the DPO loss and every gradient leaf
  of one micro-batch, and ``evaluate()``'s ``eval_loss`` over
  ``data.eval_path``.
* With a loaded nonzero LoRA adapter the reference is the base merged with
  it, and step 1 is ln 2.
* A run stopped at step 2 and resumed equals the uninterrupted run: the
  losses, the final parameters, and the reference policy, which is frozen
  ahead of the auto-resume and so stays the initial one.

Tolerances: losses and ``eval_loss`` rtol 1e-5, grad norms rtol 1e-4,
gradient leaves within 1e-5 of their largest magnitude, ``dpo_acc`` exact
from step 2 (at step 1 the reference's margins are float noise).
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from veomni_tpu_torch.models.jax_weights import (
    adapters_to_jax_tree,
    load_jax_adapters,
    load_jax_params,
    to_jax_tree,
)
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextDPOTrainer

from test_e2e_training import _make_args
from test_torch_trainer import StopAt, assert_bit_identical, port_args, state_tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "tokenizers")


def write_pairs(path, n=64, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            row = {"prompt": rng.integers(0, vocab, int(rng.integers(4, 13))).tolist()}
            for side in ("chosen", "rejected"):
                row[side] = rng.integers(0, vocab, int(rng.integers(8, 41))).tolist()
            f.write(json.dumps(row) + "\n")


def post_args(args, tmp_path, steps=3, eval_path=None):
    """The e2e toy's arguments for a post-training trainer: seq 64, lr 1e-2
    (the margins move off 0 within three steps)."""
    args.data.max_seq_len = 64
    args.train.train_steps = steps
    args.train.lr = 1e-2
    if eval_path:
        args.data.eval_path = str(eval_path)
        args.train.eval_batches = 2
    return args


def record_metrics(trainer, keys=("loss", "grad_norm")):
    """Wrap the trainer's step; returns the list of each step's metrics."""
    seen = []
    orig = trainer.train_step

    def wrapped(state, batch):
        out = orig(state, batch)
        seen.append([float(v) if np.ndim(v) == 0 else np.asarray(v).tolist()
                     for v in (out[1][k] for k in keys)])
        return out

    trainer.train_step = wrapped
    return seen


def run_both(tmp_path, jax_cls, port_cls, configure, keys, steps=3):
    """The JAX trainer, then the port's on the same arguments and initial
    weights (and adapters), ``steps`` steps each. Returns (JAX trainer,
    port trainer, JAX metrics, port metrics)."""
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy

    j_trainer = jax_cls(configure(_make_args(tmp_path)))
    lora = j_trainer.lora_config is not None
    init = jax.tree.map(np.asarray, j_trainer.base_params if lora else j_trainer.train_state.params)
    adapters = jax.tree.map(np.asarray, j_trainer.train_state.params) if lora else None
    j_seen = record_metrics(j_trainer, keys)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    trainer = port_cls(configure(port_args(tmp_path)))
    if lora:
        load_jax_params(trainer.base_model, init)
        load_jax_adapters(trainer.train_state.model, adapters)
    else:
        load_jax_params(trainer.train_state.model, init)
    seen = record_metrics(trainer, keys)
    assert trainer.train().global_step == steps
    trainer.checkpointer.close()
    return j_trainer, trainer, np.array(j_seen), np.array(seen)


def assert_grads_match(trainer, j_trainer, batch_np):
    """The trainers' own loss fns on one micro-batch of ``batch_np``, at the
    JAX trainer's trained weights (copied into the port's: three AdamW steps
    at lr 1e-2 amplify the two packages' rounding): loss, metrics and every
    gradient leaf."""
    import jax.numpy as jnp

    trained = jax.tree.map(np.asarray, j_trainer.train_state.params)
    if trainer.base_model is not None:
        load_jax_adapters(trainer.train_state.model, trained)
    else:
        load_jax_params(trainer.train_state.model, trained)
    micro_np = {k: v[0] for k, v in batch_np.items()}
    (loss_j, metrics_j), grads_j = jax.value_and_grad(j_trainer._loss_fn, has_aux=True)(
        j_trainer.train_state.params, {k: jnp.asarray(v) for k, v in micro_np.items()})
    model = trainer.train_state.model
    model.zero_grad(set_to_none=True)
    micro = {k: v[0] for k, v in trainer._ship_batch(batch_np).items()}
    with trainer.train_state.model.merged() if trainer.base_model is not None else _null():
        loss, metrics = trainer._loss_fn(model, micro)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-5, err_msg=k)
    got = (adapters_to_jax_tree(model, grads=True) if trainer.base_model is not None
           else to_jax_tree(model, grads=True))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, ref in jax.tree_util.tree_leaves_with_path(grads_j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(flat[path], ref, rtol=0, atol=1e-5 * np.abs(ref).max() + 1e-12,
                                   err_msg=str(path))
    return metrics


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_transform_and_collator_match_jax():
    from veomni_tpu.data.data_transform import build_data_transform as j_transform
    from veomni_tpu.trainer.dpo_trainer import DPOPairCollator as JaxCollator

    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.tokenizer import Tokenizer
    from veomni_tpu_torch.trainer.dpo_trainer import DPOPairCollator

    rows = [{"prompt": [1, 2, 3], "chosen": [4, 5, 6, 7], "rejected": [8, 9]},
            {"prompt": [10] * 30, "chosen": list(range(40)), "rejected": [11, 12, 13]},
            {"prompt": "Which is larger?", "chosen": " The second one.", "rejected": " Three."}]
    # one tokenizer for both transforms (the readers' parity is
    # tests/test_torch_tokenizer.py's)
    tok = Tokenizer.from_pretrained(os.path.join(FIXTURES, "bytelevel"))
    j_fn = j_transform("dpo", tokenizer=tok, max_seq_len=48)
    fn = build_data_transform("dpo", tokenizer=tok, max_seq_len=48)
    samples, j_samples = [fn(r) for r in rows], [j_fn(r) for r in rows]
    assert samples == j_samples
    assert len(samples[1]["chosen_input_ids"]) == 48  # truncated
    got, ref = DPOPairCollator(48, 4)(samples), JaxCollator(48, 4)(j_samples)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["segment_ids"][6:] == 0).all()  # the fourth pair is padding


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_dpo_trainer_matches_jax(tmp_path, lora):
    from veomni_tpu.trainer.dpo_trainer import TextDPOTrainer as JaxDPOTrainer

    write_pairs(tmp_path / "data.jsonl")
    write_pairs(tmp_path / "eval.jsonl", n=16, seed=1)

    def configure(args):
        post_args(args, tmp_path, eval_path=tmp_path / "eval.jsonl")
        if lora:
            args.model.lora = {"rank": 4, "alpha": 8}
        return args

    keys = ("loss", "grad_norm", "dpo_acc")
    j_trainer, trainer, ref, got = run_both(tmp_path, JaxDPOTrainer, TextDPOTrainer,
                                            configure, keys)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-4, err_msg="grad_norm")
    # step 1: policy = reference. The port scores both through the same ops,
    # so every margin is exactly 0: loss ln 2 per pair, no pair counted
    # right. The reference's two XLA programs round apart (margins of float
    # noise), so its step-1 dpo_acc counts the noise's sign; from step 2 on
    # the margins are real and the accuracies equal.
    assert got[0, 0] == np.float32(math.log(2)) and got[0, 2] == 0.0
    np.testing.assert_array_equal(got[1:, 2], ref[1:, 2], err_msg="dpo_acc")
    assert got[-1, 0] < got[0, 0]
    # the trained policy against the frozen reference: loss and every gradient
    batch_np = next(iter(trainer._build_eval_dataloader()))
    metrics = assert_grads_match(trainer, j_trainer, batch_np)
    assert float(metrics["dpo_acc"]) > 0  # the margins moved off 0
    np.testing.assert_allclose(trainer.evaluate(), j_trainer.evaluate(), rtol=1e-5)
    assert trainer.evaluate() == trainer.evaluate()  # the same slice every call
    if lora:
        assert trainer.reference is trainer.base_model
    destroy_parallel_state()


def test_dpo_resume_equals_uninterrupted(tmp_path):
    write_pairs(tmp_path / "data.jsonl")

    def args(name, **kw):
        return post_args(port_args(tmp_path, name, **kw), tmp_path, steps=4)

    straight = TextDPOTrainer(args("a"))
    init = {n: p.detach().clone() for n, p in straight.train_state.model.named_parameters()}
    seen_a = record_metrics(straight)
    straight.train()
    for n, p in straight.reference.named_parameters():
        assert torch.equal(p, init[n]), n  # the reference is the initial policy
    assert not torch.equal(straight.train_state.model.norm, init["norm"])  # the policy moved
    ref_a = state_tensors(straight)
    straight.checkpointer.close()
    destroy_parallel_state()

    first = TextDPOTrainer(args("b", save_steps=2))
    first.callbacks.append(StopAt(2))
    seen_b = record_metrics(first)
    first.train()
    first.checkpointer.close()
    destroy_parallel_state()
    resumed = TextDPOTrainer(args("b", save_steps=2))
    seen_b2 = record_metrics(resumed)
    assert resumed.train().global_step == 4
    assert seen_b + seen_b2 == seen_a
    assert_bit_identical(ref_a, state_tensors(resumed), "resumed DPO state")
    for n, p in resumed.reference.named_parameters():
        assert torch.equal(p, init[n]), n
    resumed.checkpointer.close()


def test_lora_reference_with_a_loaded_adapter(tmp_path):
    """``model.lora_adapter_path`` with a nonzero adapter: the reference is
    the base merged with the loaded adapter (``:129-147``), not the bare
    base, so step 1 is still ln 2 a pair."""
    from veomni_tpu_torch.lora import merge_lora_params, save_adapter

    write_pairs(tmp_path / "data.jsonl")

    def args(name, **model):
        a = post_args(port_args(tmp_path, name), tmp_path, steps=1)
        a.model.lora = {"rank": 4, "alpha": 8}
        for k, v in model.items():
            setattr(a.model, k, v)
        return a

    first = TextDPOTrainer(args("a"))
    with torch.no_grad():
        for p in first.train_state.model.leaves.values():
            p.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    save_adapter(first.train_state.model, first.lora_config, str(tmp_path / "adapter"))
    want = merge_lora_params(first.base_model, first.train_state.model)
    first.checkpointer.close()
    destroy_parallel_state()

    trainer = TextDPOTrainer(args("b", lora_adapter_path=str(tmp_path / "adapter")))
    seen = record_metrics(trainer)
    trainer.train()
    assert seen[0][0] == np.float32(math.log(2))
    assert trainer.reference is not trainer.base_model
    for (name, got), (_, ref) in zip(trainer.reference.named_parameters(),
                                     want.named_parameters()):
        assert torch.equal(got, ref), name
    trainer.checkpointer.close()
