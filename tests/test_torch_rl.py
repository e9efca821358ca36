"""The port's RL trainer (``veomni_tpu_torch/trainer/rl_trainer.py``)
against the JAX one, on the CPU.

* The ``rl`` transform and ``RLSampleCollator`` give the reference's arrays
  on the same rows, with and without ``old_logprobs`` (the +1.0 on-policy
  sentinel).
* The trainers on the e2e toy (2 layers, hidden 64, f32) from the same
  initial weights, ``ppo_clip_ratio`` 0.2, rows whose advantages are drawn
  from N(0, 1), half of them with old log-probs a little off the initial
  policy's (so the ratio departs from 1 and the clip bites) and half on the
  sentinel: three steps' loss, grad norm and ``ratio_mean``; then
  ``evaluate()``'s ``eval_loss`` on the trained weights.
* On the sentinel rows alone the ratio is exactly 1 at every token.
* The softcap (ROADMAP.md queue 3, diverges on purpose 7): on a capped toy
  the RL log-probs are ``head_loss``'s capped ones.

Tolerances: losses rtol 1e-5, grad norms rtol 1e-4, ``ratio_mean`` rtol
1e-5.
"""

import json

import numpy as np
import torch

from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import RLTrainer
from veomni_tpu_torch.trainer.rl_trainer import make_rl_loss

from test_torch_dpo import post_args, run_both
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def rl_rows(n, vocab=256, seed=0):
    """Prompts of 4-12 tokens, responses of 8-40, advantages from N(0, 1);
    every other row carries old log-probs near ln(1/vocab), the initial
    policy's scale, drawn with a spread of 0.3."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        resp = rng.integers(0, vocab, int(rng.integers(8, 41))).tolist()
        row = {"prompt": rng.integers(0, vocab, int(rng.integers(4, 13))).tolist(),
               "response": resp, "advantage": float(rng.standard_normal())}
        if i % 2:
            row["old_logprobs"] = (np.log(1 / vocab) + 0.3 * rng.standard_normal(len(resp))
                                   ).tolist()
        rows.append(row)
    return rows


def write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_transform_and_collator_match_jax():
    from veomni_tpu.data.data_transform import build_data_transform as j_transform
    from veomni_tpu.trainer.rl_trainer import RLSampleCollator as JaxCollator

    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.trainer.rl_trainer import RLSampleCollator

    rows = rl_rows(5)
    samples = [build_data_transform("rl", max_seq_len=40)(r) for r in rows]
    j_samples = [j_transform("rl", max_seq_len=40)(r) for r in rows]
    assert samples == j_samples
    got, ref = RLSampleCollator(64, 6)(samples), JaxCollator(64, 6)(j_samples)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    resp = got["labels"][0] != -100
    assert (got["old_logprobs"][0][resp] == 1.0).all()  # the sentinel row


def test_rl_trainer_matches_jax(tmp_path):
    from veomni_tpu.trainer.rl_trainer import BaseRLTrainer as JaxRLTrainer

    write_rows(tmp_path / "data.jsonl", rl_rows(48))
    write_rows(tmp_path / "eval.jsonl", rl_rows(12, seed=1))

    def configure(args):
        return post_args(args, tmp_path, eval_path=tmp_path / "eval.jsonl")

    keys = ("loss", "grad_norm", "ratio_mean")
    j_trainer, trainer, ref, got = run_both(tmp_path, JaxRLTrainer, RLTrainer, configure, keys)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-4, err_msg="grad_norm")
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=1e-5, err_msg="ratio_mean")
    assert abs(got[0, 2] - 1) > 1e-3  # the old log-probs move the ratio
    np.testing.assert_allclose(trainer.evaluate(), j_trainer.evaluate(), rtol=1e-5)
    destroy_parallel_state()


def rl_batch(softcap=0.0, sentinel=True):
    from veomni_tpu_torch.models import Transformer, TransformerConfig

    from test_torch_post_training_ops import TOY, rows_batch

    cfg = TransformerConfig(dtype=torch.float32, final_logit_softcap=softcap, **TOY)
    model = Transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in rows_batch().items()}
    b, s = batch["input_ids"].shape
    batch["old_logprobs"] = torch.full((b, s), 1.0 if sentinel else 0.0)
    batch["advantages"] = torch.tensor([1.0, -1.0, 0.5, 2.0])
    return model, batch


def test_sentinel_rows_give_a_ratio_of_exactly_one():
    model, batch = rl_batch()
    loss, metrics = make_rl_loss(0.2)(model, batch)
    assert float(metrics["ratio_mean"].detach()) == 1.0
    valid = batch["labels"] != -100
    want = -(batch["advantages"][:, None] * valid).sum()
    assert float(loss.detach()) == float(want)
    loss.backward()
    assert model.lm_head.grad.abs().sum() > 0  # the policy gradient flows


def test_softcap_reaches_the_rl_log_probs():
    model, batch = rl_batch(softcap=0.1, sentinel=False)
    with torch.no_grad():
        _, metrics = make_rl_loss(0.2)(model, batch)
        # old log-probs 0: the ratio is exp(logp), so ratio_mean is the mean
        # token probability, here from head_loss's capped logits
        logits = model.forward_logits(batch["input_ids"], batch["position_ids"],
                                      batch["segment_ids"])
        valid = batch["labels"] != -100
        lab = batch["labels"].clamp(min=0).long()
        p = torch.softmax(logits, -1).gather(-1, lab[..., None])[..., 0]
    torch.testing.assert_close(metrics["ratio_mean"], p[valid].mean(), rtol=1e-5, atol=0)
