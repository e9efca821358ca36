"""Top-k distillation trainer: CE plus forward KL against the teacher's top-k.

Port of ``veomni_tpu/trainer/distill_trainer.py`` (``:1-193``): the
``distill`` transform, ``DistillCollator`` and ``DistillTrainer``. Rows are
{"input_ids": [...], "teacher_topk_ids": [[K]*T], "teacher_topk_log_probs":
[[K]*T]}, the teacher arrays aligned with the prediction made at each input
token (of token t+1), so the collator places them unshifted. The loss is
``nll.sum() + kl_coef * distill.sum()`` from one fused pass
(``ops.fused_linear_topk_distill``), with the token means of the KL and of
the two top-k masses as metrics.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from veomni_tpu_torch import ops
from veomni_tpu_torch.data.data_collator import IGNORE_INDEX
from veomni_tpu_torch.data.data_transform import DATA_TRANSFORM_REGISTRY, build_data_transform
from veomni_tpu_torch.trainer.base import BATCH_KEYS, SUPPORTED_DATA_TYPES, BaseTrainer
from veomni_tpu_torch.trainer.dpo_trainer import one_sample_dataloader, require_text_model


@DATA_TRANSFORM_REGISTRY.register("distill")
def build_distill_transform(tokenizer=None, max_seq_len: int = 0, **_):
    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        ids = list(row["input_ids"])[: max_seq_len or None]
        n = len(ids)
        return {
            "input_ids": ids,
            "teacher_topk_ids": [list(r) for r in row["teacher_topk_ids"][:n]],
            "teacher_topk_log_probs": [list(r) for r in row["teacher_topk_log_probs"][:n]],
        }

    return transform


class DistillCollator:
    """One sample a row [B, S]; the teacher's arrays [B, S, K], unshifted.
    Positions and columns the teacher does not fill (ragged rows, fewer
    than ``topk`` columns, padding) hold log-prob ``NO_TEACHER``, whose
    probability is exactly 0: they add nothing to the KL or the masses."""

    NO_TEACHER = -1e9

    def __init__(self, seq_len: int, micro_batch_size: int, topk: int, sp_size: int = 1):
        if seq_len % max(sp_size, 1):
            raise ValueError("seq_len % sp_size != 0")
        self.seq_len = seq_len
        self.micro_batch_size = micro_batch_size
        self.topk = topk

    def __call__(self, samples):
        b, s, k = self.micro_batch_size, self.seq_len, self.topk
        out = {
            "input_ids": np.zeros((b, s), np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "position_ids": np.zeros((b, s), np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
            "teacher_topk_ids": np.zeros((b, s, k), np.int32),
            "teacher_topk_log_probs": np.full((b, s, k), self.NO_TEACHER, np.float32),
        }
        for i, sample in enumerate(samples[:b]):
            ids = np.asarray(sample["input_ids"], np.int32)[:s]
            n = len(ids)
            t_ids = np.asarray(sample["teacher_topk_ids"], np.int32)
            t_lp = np.asarray(sample["teacher_topk_log_probs"], np.float32)
            if t_ids.shape != t_lp.shape:
                raise ValueError(f"teacher_topk_ids {t_ids.shape} vs teacher_topk_log_probs "
                                 f"{t_lp.shape} shape mismatch in sample {i}")
            nt = min(n, t_ids.shape[0])
            kt = min(k, t_ids.shape[1]) if t_ids.ndim == 2 else 0
            out["input_ids"][i, :n] = ids
            out["labels"][i, : n - 1] = ids[1:]
            out["position_ids"][i, :n] = np.arange(n)
            out["segment_ids"][i, :n] = 1
            if kt:
                out["teacher_topk_ids"][i, :nt, :kt] = t_ids[:nt, :kt]
                out["teacher_topk_log_probs"][i, :nt, :kt] = t_lp[:nt, :kt]
        return out


def make_distill_loss(kl_coef: float, temperature: float):
    """``loss(module, batch)``: ``nll.sum() + kl_coef * distill.sum()`` and
    the metrics (``:158-184``)."""

    def distill_loss(module, batch):
        cfg = module.cfg
        hidden, _ = module.forward_hidden(batch["input_ids"], batch["position_ids"],
                                          batch.get("segment_ids"))
        b, s, h = hidden.shape
        labels = batch["labels"].reshape(b * s)
        # one [T, V] product gives the untempered CE (nll) and the tempered
        # KL; the softcap as head_loss applies it (the reference leaves it
        # out: ROADMAP.md queue 3, diverges on purpose 7)
        out = ops.fused_linear_topk_distill(
            hidden.reshape(b * s, h), module.lm_head_kernel().to(cfg.dtype), labels,
            batch["teacher_topk_ids"].reshape(b * s, -1),
            batch["teacher_topk_log_probs"].reshape(b * s, -1),
            temperature=temperature, logit_softcap=cfg.final_logit_softcap or None)
        ntokens = (labels != IGNORE_INDEX).sum()
        denom = ntokens.clamp(min=1)
        return out["nll"].sum() + kl_coef * out["distill"].sum(), {
            "ntokens": ntokens,
            "distill_kl": out["distill"].sum() / denom,
            "student_mass": out["student_mass"].sum() / denom,
            "teacher_mass": out["teacher_mass"].sum() / denom,
        }

    return distill_loss


class DistillTrainer(BaseTrainer):
    BATCH_KEYS = BATCH_KEYS + ("teacher_topk_ids", "teacher_topk_log_probs")
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES + ("distill",)

    def _build_model(self):
        super()._build_model()
        require_text_model(self, "the distill trainer")

    def _build_data_transform(self):
        self.data_transform = build_data_transform(
            "distill", tokenizer=self.tokenizer, max_seq_len=self.args.data.max_seq_len)

    def _build_dataloader(self):
        t, d = self.args.train, self.args.data
        rows = t.micro_batch_size * self.parallel_state.dp_size
        self.dataloader = one_sample_dataloader(
            self, DistillCollator(d.max_seq_len, rows, topk=t.distill_topk,
                                  sp_size=self.parallel_state.sp_size), rows)

    def _inner_loss_fn(self):
        t = self.args.train
        return make_distill_loss(float(t.distill_kl_coef), float(t.distill_temperature))
