"""Direct Preference Optimization trainer (text).

Port of the text half of ``veomni_tpu/trainer/dpo_trainer.py`` (``:1-184``):
the ``dpo`` transform, ``DPOPairCollator`` and ``TextDPOTrainer``. Each
micro-batch holds the chosen and rejected rows of its pairs adjacent
([c0, r0, c1, r1, ...]); one forward scores both for the policy, a second
one, under ``torch.no_grad`` (so outside remat), for the frozen reference
policy, and the loss is ``-logsigmoid(beta * ((pi_c - ref_c) - (pi_r -
ref_r)))`` summed over the pairs, with ``ntokens`` the pair count and the
``dpo_acc`` metric. ``evaluate()`` scores this objective too.

The reference policy is frozen at the start of ``train()``, ahead of the
checkpoint's auto-resume (a resumed run anchors where the first run did),
or at the first score before that: a detached copy of the initial
parameters; with LoRA, the bare base (a fresh adapter's B is 0, so it is
the initial policy; its forward reads the base's own weights inside the
train step's merge, ``LoraAdapters.unmerged``), or, where
``model.lora_adapter_path`` loaded a nonzero adapter, a merged copy of base
and adapter (``:129-147``). The VLM variant (``:187-399``) is slice F.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from veomni_tpu_torch.data.data_collator import IGNORE_INDEX
from veomni_tpu_torch.data.data_loader import build_dataloader
from veomni_tpu_torch.data.data_transform import DATA_TRANSFORM_REGISTRY, build_data_transform
from veomni_tpu_torch.trainer.base import SUPPORTED_DATA_TYPES, BaseTrainer
from veomni_tpu_torch.trainer.callbacks import Callback


def _token_ids(tokenizer, x):
    """Token ids of ``x``: a string through the tokenizer, else as given."""
    if isinstance(x, str):
        return tokenizer(x, add_special_tokens=False)["input_ids"]
    return list(x)


@DATA_TRANSFORM_REGISTRY.register("dpo")
def build_dpo_transform(tokenizer=None, max_seq_len: int = 0, **_):
    """Rows: {"prompt": ids|text, "chosen": ids|text, "rejected": ids|text};
    the prompt is loss-masked in both branches."""

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        prompt = _token_ids(tokenizer, row["prompt"])
        out = {}
        for side in ("chosen", "rejected"):
            resp = _token_ids(tokenizer, row[side])
            ids, labels = prompt + resp, [IGNORE_INDEX] * len(prompt) + resp
            if max_seq_len:
                ids, labels = ids[:max_seq_len], labels[:max_seq_len]
            out[f"{side}_input_ids"] = ids
            out[f"{side}_labels"] = labels
        return out

    return transform


class DPOPairCollator:
    """[2P, S], one sample a row, the pairs' chosen and rejected rows
    adjacent (even rows chosen, odd rows rejected); labels shifted for the
    next token, padding at segment 0."""

    def __init__(self, seq_len: int, pairs: int, sp_size: int = 1):
        if seq_len % max(sp_size, 1):
            raise ValueError("seq_len must divide sp_size")
        self.seq_len = seq_len
        self.pairs = pairs

    def __call__(self, samples):
        p, s = self.pairs, self.seq_len
        out = {
            "input_ids": np.zeros((2 * p, s), np.int32),
            "labels": np.full((2 * p, s), IGNORE_INDEX, np.int32),
            "position_ids": np.zeros((2 * p, s), np.int32),
            "segment_ids": np.zeros((2 * p, s), np.int32),
        }
        for i, sample in enumerate(samples[:p]):
            for half, side in enumerate(("chosen", "rejected")):
                row = 2 * i + half
                ids = np.asarray(sample[f"{side}_input_ids"], np.int32)[:s]
                lab = np.asarray(sample[f"{side}_labels"], np.int32)[: len(ids)]
                n = len(ids)
                out["input_ids"][row, :n] = ids
                out["labels"][row, :n] = np.concatenate([lab[1:], [IGNORE_INDEX]])
                out["position_ids"][row, :n] = np.arange(n)
                out["segment_ids"][row, :n] = 1
        return out


def require_text_model(trainer, what: str) -> None:
    if trainer.model.is_vlm:
        raise NotImplementedError(
            f"{what} on a vision-language model ({trainer.model.config.model_type}): "
            "VLM-DPO and the multimodal post-training paths are slice F of the port "
            "(ROADMAP.md queue 1)")


def one_sample_dataloader(trainer, collator, rows: int):
    """The native dataloader offering ``rows`` samples to ``collator`` a
    micro-batch (one sample a row, no packing)."""
    t, d = trainer.args.train, trainer.args.data
    shard = trainer.data_shard()
    trainer.grad_accum_steps = trainer.args.compute_grad_accum(trainer.parallel_state.dp_size)
    return build_dataloader(
        d.dataloader_type, dataset=trainer.dataset, collate_fn=collator,
        micro_batch_size=rows, grad_accum_steps=trainer.grad_accum_steps,
        samples_per_micro_batch=rows, seed=t.seed, dp_rank=shard["dp_rank"],
        dp_size=shard["dp_size"], infinite=True,
    )


class _FreezeReference(Callback):
    """First in the callback list: freezes the reference policy before the
    checkpoint callback's auto-resume restores trained weights."""

    def on_train_begin(self, trainer, state):
        trainer.freeze_reference()


class TextDPOTrainer(BaseTrainer):
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES + ("dpo",)

    reference = None  # the frozen reference policy, a Transformer

    def _build_model(self):
        super()._build_model()
        require_text_model(self, "the DPO trainer")

    def _build_data_transform(self):
        self.data_transform = build_data_transform(
            "dpo", tokenizer=self.tokenizer, max_seq_len=self.args.data.max_seq_len)

    def _build_dataloader(self):
        pairs = self.data_shard()["rows"]
        self.dataloader = one_sample_dataloader(
            self, DPOPairCollator(self.args.data.max_seq_len, pairs,
                                  sp_size=self.parallel_state.sp_size), pairs)

    def _init_callbacks(self):
        super()._init_callbacks()
        self.callbacks.insert(0, _FreezeReference())

    @torch.no_grad()
    def freeze_reference(self) -> None:
        """Fix the reference policy to the current (initial) one; no-op once
        it is fixed."""
        if self.reference is not None:
            return
        if self.base_model is None and self.layout is not None:
            # over a mesh: a whole copy on every rank (its experts keep their
            # ep slice), from the state gathered out of the shards
            from veomni_tpu_torch.parallel.parallel_plan import apply_parallel_plan

            full = self.layout.full_state_dict()
            ref = self.model._build(None, self.device)
            ref.load_state_dict({k: v.to(self.device) for k, v in full.items()})
            apply_parallel_plan(ref, self.parallel_state, frozen=True)
            self.reference = ref.requires_grad_(False)
        elif self.base_model is None:
            self.reference = copy.deepcopy(self.train_state.model).requires_grad_(False)
        elif self.args.model.lora_adapter_path:
            from veomni_tpu_torch.lora import merge_lora_params

            self.reference = merge_lora_params(self.base_model, self.train_state.model)
        else:
            self.reference = self.base_model

    def reference_logps(self, batch) -> torch.Tensor:
        """The reference policy's per-row label log-prob sums [2P], no grad."""
        self.freeze_reference()
        with torch.no_grad():
            if self.reference is self.base_model:  # the bare base, inside the merge
                with self.train_state.model.unmerged():
                    return self.reference.sequence_logprob_sums(batch)
            return self.reference.sequence_logprob_sums(batch)

    def _inner_loss_fn(self):
        beta = float(self.args.train.dpo_beta)

        def dpo_loss(module, batch):
            logps = module.sequence_logprob_sums(batch)  # [2P]
            ref = self.reference_logps(batch)
            margin = (logps[0::2] - ref[0::2]) - (logps[1::2] - ref[1::2])
            losses = -F.logsigmoid(beta * margin)
            return losses.sum(), {
                "ntokens": torch.tensor(margin.shape[0], device=margin.device),
                "dpo_acc": (margin > 0).float().mean(),
            }

        return dpo_loss


# the reference package's name (veomni_tpu.trainer.DPOTrainer)
DPOTrainer = TextDPOTrainer
