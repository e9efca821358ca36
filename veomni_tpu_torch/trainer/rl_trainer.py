"""PPO-style RL post-training trainer.

Port of ``veomni_tpu/trainer/rl_trainer.py`` (``:1-175``): the ``rl``
transform, ``RLSampleCollator`` and ``BaseRLTrainer``. Rollouts come from
an external engine, so a row is (prompt, response, advantage, and
optionally the rollout policy's per-token ``old_logprobs``). The loss is the
clipped importance-sampling surrogate over the response tokens,
``ratio = exp(logp - old_logp)``, ``-sum(min(ratio * A, clip(ratio, 1 -
eps, 1 + eps) * A))``, with ``ratio_mean`` as a metric. A row without
``old_logprobs`` carries the on-policy sentinel +1.0 (no log-prob is
positive): there ``old`` is ``logp.detach()``, so the ratio is exactly 1
and the gradient is the plain policy gradient.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from veomni_tpu_torch import ops
from veomni_tpu_torch.data.data_collator import IGNORE_INDEX
from veomni_tpu_torch.data.data_transform import DATA_TRANSFORM_REGISTRY, build_data_transform
from veomni_tpu_torch.trainer.base import BATCH_KEYS, SUPPORTED_DATA_TYPES, BaseTrainer
from veomni_tpu_torch.trainer.dpo_trainer import one_sample_dataloader, require_text_model

ON_POLICY = 1.0  # the sentinel old log-prob


@DATA_TRANSFORM_REGISTRY.register("rl")
def build_rl_transform(tokenizer=None, max_seq_len: int = 0, **_):
    """Rows: {"prompt": ids, "response": ids, "advantage": float,
    "old_logprobs": [len(response)] (optional: the on-policy sentinel)}."""

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        prompt, resp = list(row["prompt"]), list(row["response"])
        ids = (prompt + resp)[: max_seq_len or None]
        old = row.get("old_logprobs")
        return {
            "input_ids": ids,
            "labels": ([IGNORE_INDEX] * len(prompt) + resp)[: len(ids)],
            "old_logprobs": ([ON_POLICY] * len(prompt)
                             + list(old or [ON_POLICY] * len(resp)))[: len(ids)],
            "advantage": float(row.get("advantage", 0.0)),
        }

    return transform


class RLSampleCollator:
    """One sample a row [B, S], per-token old log-probs [B, S] (shifted with
    the labels) and per-row advantages [B]."""

    def __init__(self, seq_len: int, micro_batch_size: int, sp_size: int = 1):
        if seq_len % max(sp_size, 1):
            raise ValueError("seq_len % sp_size != 0")
        self.seq_len = seq_len
        self.micro_batch_size = micro_batch_size

    def __call__(self, samples):
        b, s = self.micro_batch_size, self.seq_len
        out = {
            "input_ids": np.zeros((b, s), np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "position_ids": np.zeros((b, s), np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
            "old_logprobs": np.zeros((b, s), np.float32),
            "advantages": np.zeros((b,), np.float32),
        }
        for i, sample in enumerate(samples[:b]):
            ids = np.asarray(sample["input_ids"], np.int32)[:s]
            n = len(ids)
            lab = np.asarray(sample["labels"], np.int32)[:n]
            old = np.asarray(sample["old_logprobs"], np.float32)[:n]
            out["input_ids"][i, :n] = ids
            out["labels"][i, :n] = np.concatenate([lab[1:], [IGNORE_INDEX]])
            out["old_logprobs"][i, :n] = np.concatenate([old[1:], [0.0]])
            out["position_ids"][i, :n] = np.arange(n)
            out["segment_ids"][i, :n] = 1
            out["advantages"][i] = sample["advantage"]
        return out


def make_rl_loss(eps: float):
    """``loss(module, batch)``: the clipped surrogate summed over the
    response tokens and ``ratio_mean`` (``:138-158``)."""

    def rl_loss(module, batch):
        cfg = module.cfg
        hidden, _ = module.forward_hidden(batch["input_ids"], batch["position_ids"],
                                          batch.get("segment_ids"))
        b, s, h = hidden.shape
        # the softcap as head_loss applies it (the reference leaves it out:
        # ROADMAP.md queue 3, diverges on purpose 7)
        logp = -ops.fused_linear_cross_entropy_per_token(
            hidden.reshape(b * s, h), module.lm_head_kernel().to(cfg.dtype),
            batch["labels"].reshape(b * s),
            logit_softcap=cfg.final_logit_softcap or None).view(b, s)
        valid = batch["labels"] != IGNORE_INDEX
        old = batch["old_logprobs"]
        old = torch.where(old > 0.5, logp.detach(), old)
        ratio = torch.exp(torch.where(valid, logp - old, torch.zeros_like(logp)))
        adv = batch["advantages"][:, None]
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv)
        ntokens = valid.sum()
        zero = torch.zeros_like(ratio)
        return -torch.where(valid, surrogate, zero).sum(), {
            "ntokens": ntokens,
            "ratio_mean": torch.where(valid, ratio, zero).sum() / ntokens.clamp(min=1),
        }

    return rl_loss


class BaseRLTrainer(BaseTrainer):
    BATCH_KEYS = BATCH_KEYS + ("old_logprobs", "advantages")
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES + ("rl",)

    def _build_model(self):
        super()._build_model()
        require_text_model(self, "the RL trainer")

    def _build_data_transform(self):
        self.data_transform = build_data_transform(
            "rl", tokenizer=self.tokenizer, max_seq_len=self.args.data.max_seq_len)

    def _build_dataloader(self):
        rows = self.args.train.micro_batch_size * self.parallel_state.dp_size
        self.dataloader = one_sample_dataloader(
            self, RLSampleCollator(self.args.data.max_seq_len, rows,
                                   sp_size=self.parallel_state.sp_size), rows)

    def _inner_loss_fn(self):
        return make_rl_loss(float(self.args.train.ppo_clip_ratio))


# the reference package's name (veomni_tpu.trainer.RLTrainer)
RLTrainer = BaseRLTrainer
