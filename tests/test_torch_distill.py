"""The port's distill trainer (``veomni_tpu_torch/trainer/distill_trainer.py``)
against the JAX one, on the CPU.

* The ``distill`` transform and ``DistillCollator`` give the reference's
  arrays on the same rows, ragged teacher data included (fewer teacher
  tokens than ids, fewer columns than ``distill_topk``).
* The trainers on the e2e toy (2 layers, hidden 64, f32) from the same
  initial weights, ``distill_topk`` 8, ``distill_kl_coef`` 0.5 and
  ``distill_temperature`` 0.7: three steps' loss, grad norm, ``distill_kl``,
  ``student_mass`` and ``teacher_mass``; then ``evaluate()``'s ``eval_loss``
  on the trained weights.
* The softcap (ROADMAP.md queue 3, diverges on purpose 7): on a capped toy
  the distill loss's CE term is ``head_loss``'s capped NLL.

Tolerances: losses rtol 1e-5, grad norms rtol 1e-4, the metrics rtol 1e-5.
"""

import json

import numpy as np
import torch

from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import DistillTrainer
from veomni_tpu_torch.trainer.distill_trainer import make_distill_loss

from test_torch_dpo import post_args, run_both
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TOPK = 8


def distill_rows(n, vocab=256, seed=0):
    """Rows of 16-56 tokens with the teacher's top-8 ids and log-probs of a
    random distribution; every fifth row has a ragged teacher (fewer tokens
    and 5 columns)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = int(rng.integers(16, 57))
        nt, k = (t - 3, 5) if i % 5 == 4 else (t, TOPK)
        ids = np.stack([rng.choice(vocab, k, replace=False) for _ in range(nt)])
        lp = np.log(rng.dirichlet(np.ones(vocab) * 0.1, nt)[np.arange(nt)[:, None], ids])
        rows.append({"input_ids": rng.integers(0, vocab, t).tolist(),
                     "teacher_topk_ids": ids.tolist(),
                     "teacher_topk_log_probs": np.maximum(lp, -30.0).tolist()})
    return rows


def write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def test_transform_and_collator_match_jax():
    from veomni_tpu.data.data_transform import build_data_transform as j_transform
    from veomni_tpu.trainer.distill_trainer import DistillCollator as JaxCollator

    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.trainer.distill_trainer import DistillCollator

    rows = distill_rows(5)
    samples = [build_data_transform("distill", max_seq_len=48)(r) for r in rows]
    j_samples = [j_transform("distill", max_seq_len=48)(r) for r in rows]
    assert samples == j_samples
    got, ref = DistillCollator(64, 6, TOPK)(samples), JaxCollator(64, 6, TOPK)(j_samples)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["teacher_topk_log_probs"][4, :, 5:] == DistillCollator.NO_TEACHER).all()


def test_distill_trainer_matches_jax(tmp_path):
    from veomni_tpu.trainer.distill_trainer import DistillTrainer as JaxDistillTrainer

    write_rows(tmp_path / "data.jsonl", distill_rows(48))
    write_rows(tmp_path / "eval.jsonl", distill_rows(12, seed=1))

    def configure(args):
        post_args(args, tmp_path, eval_path=tmp_path / "eval.jsonl")
        args.train.distill_topk = TOPK
        args.train.distill_kl_coef = 0.5
        args.train.distill_temperature = 0.7
        return args

    keys = ("loss", "grad_norm", "distill_kl", "student_mass", "teacher_mass")
    j_trainer, trainer, ref, got = run_both(tmp_path, JaxDistillTrainer, DistillTrainer,
                                            configure, keys)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-4, err_msg="grad_norm")
    for i, key in enumerate(keys[2:], 2):
        np.testing.assert_allclose(got[:, i], ref[:, i], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(trainer.evaluate(), j_trainer.evaluate(), rtol=1e-5)
    destroy_parallel_state()


def test_softcap_reaches_the_distill_ce():
    from veomni_tpu_torch.models import Transformer, TransformerConfig

    from test_torch_post_training_ops import TOY, rows_batch

    cfg = TransformerConfig(dtype=torch.float32, final_logit_softcap=0.1, **TOY)
    model = Transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in rows_batch().items()}
    b, s = batch["input_ids"].shape
    batch["teacher_topk_ids"] = torch.zeros((b, s, TOPK), dtype=torch.int32)
    batch["teacher_topk_log_probs"] = torch.full((b, s, TOPK), -1e9)
    with torch.no_grad():
        loss, metrics = make_distill_loss(1.0, 1.0)(model, batch)
        head, _ = model.loss_fn(batch)
    # no teacher mass: the loss is the CE alone, capped as head_loss caps it
    torch.testing.assert_close(loss, head, rtol=1e-6, atol=0)
    assert float(metrics["distill_kl"]) == 0.0
    model.cfg.final_logit_softcap = 0.0  # the reference's logits, uncapped
    with torch.no_grad():
        uncapped, _ = make_distill_loss(1.0, 1.0)(model, batch)
    assert abs(float(uncapped) / float(loss) - 1) > 1e-3
