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
and adapter (``:129-147``). Over a mesh the bare base stays sharded (its
forward runs inside the base's root FSDP2 entry); a copy, merged or not, is
built whole on every rank from the state gathered out of the shards. The
VLM variant (``:186-399``): the ``vlm_dpo``
transform, ``VLMDPOPairCollator`` and ``VLMDPOTrainer``.
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
from veomni_tpu_torch.trainer.vlm_trainer import _REAL_VL, VLMTrainer


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
    """Raise for a vision-language model where the reference has no
    multimodal path (distillation, RL); VLM-DPO is ``VLMDPOTrainer``."""
    if trainer.model.is_vlm:
        raise NotImplementedError(
            f"{what} on a vision-language model ({trainer.model.config.model_type}): the "
            "reference has no multimodal path for it; for DPO use VLMDPOTrainer "
            "(tasks/train_vlm_dpo.py)")


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
        self._check_model_kind()

    def _check_model_kind(self) -> None:
        """The text trainer refuses a VLM (its twin is ``VLMDPOTrainer``)."""
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
        lora = self.base_model is not None
        if lora and not self.args.model.lora_adapter_path:
            self.reference = self.base_model
        elif self.layout is not None:
            # over a mesh: a whole copy on every rank (its experts keep their
            # ep slice), from the state gathered out of the shards; under
            # LoRA, the gathered base merged with the gathered adapter
            from veomni_tpu_torch.lora import init_lora_params, merge_lora_params
            from veomni_tpu_torch.parallel.parallel_plan import apply_parallel_plan

            full = self.layout.full_state_dict()
            ref = self.model._build(None, self.device)
            if lora:
                base = self.base_layout.full_state_dict()
                ref.load_state_dict({k: v.to(self.device) for k, v in base.items()})
                adapters = init_lora_params(None, ref, self.lora_config)
                adapters.load_state_dict({k: v.to(self.device) for k, v in full.items()})
                ref = merge_lora_params(ref, adapters)
            else:
                ref.load_state_dict({k: v.to(self.device) for k, v in full.items()})
            apply_parallel_plan(ref, self.parallel_state, frozen=True)
            self.reference = ref.requires_grad_(False)
        elif lora:
            from veomni_tpu_torch.lora import merge_lora_params

            self.reference = merge_lora_params(self.base_model, self.train_state.model)
        else:
            self.reference = copy.deepcopy(self.train_state.model).requires_grad_(False)

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


# --------------------------------------------------------------- VLM variant
@DATA_TRANSFORM_REGISTRY.register("vlm_dpo")
def build_vlm_dpo_transform(tokenizer=None, vlm_config=None, max_seq_len: int = 0,
                            max_patches_per_sample: int = 0, **_):
    """Multimodal preference rows (``:186-281``): {"messages": [the prompt's
    messages with their image parts], "chosen": ids|text, "rejected":
    ids|text}. The prompt, its image placeholders expanded by the qwen-vl
    chat template, is loss-masked in both branches, which share its media;
    the row's patch budget splits over its images, and trailing images that
    would not get one merge block each are dropped."""
    from veomni_tpu_torch.data.chat_template import qwen_vl_chat_template

    template = qwen_vl_chat_template(tokenizer, vlm_config,
                                     max_patches_per_sample=max_patches_per_sample)

    def is_media(part) -> bool:
        return isinstance(part, dict) and part.get("type") in ("image", "video")

    def parts(msg):
        content = msg.get("content", "")
        return content if isinstance(content, list) else [content]

    def keep_leading_media(messages, keep: int):
        out, seen = [], 0
        for msg in messages:
            if not isinstance(msg.get("content", ""), list):
                out.append(msg)
                continue
            kept = []
            for part in parts(msg):
                seen += is_media(part)
                if not (is_media(part) and seen > keep):
                    kept.append(part)
            out.append({**msg, "content": kept})
        return out

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        messages = row["messages"]
        kwargs: Dict[str, Any] = {}
        n_media = sum(is_media(part) for msg in messages for part in parts(msg))
        if max_patches_per_sample and n_media:
            block = template.min_patch_block
            if n_media * block > max_patches_per_sample:
                n_media = max(1, max_patches_per_sample // block)
                messages = keep_leading_media(messages, n_media)
            kwargs["patch_budget"] = max(1, max_patches_per_sample // n_media)
        enc = template.encode_messages(messages, **kwargs)
        # the assistant turn opens; each branch brings its body and close
        prompt = enc["input_ids"] + template._tok(f"{template.im_start}assistant\n")
        close = template._tok(f"{template.im_end}\n")
        out: Dict[str, Any] = {"vis_patches": enc.get("vis_patches", []),
                               "vis_grids": enc.get("vis_grids", [])}
        for side in ("chosen", "rejected"):
            resp = _token_ids(tokenizer, row[side]) + close
            ids = (prompt + resp)[: max_seq_len or None]
            out[f"{side}_input_ids"] = ids
            out[f"{side}_labels"] = ([IGNORE_INDEX] * len(prompt) + resp)[: len(ids)]
        return out

    return transform


class VLMDPOPairCollator:
    """Pairs -> a per-row-budget VLM micro-batch [2P, S] (``:284-311``): row
    2i the chosen branch, 2i + 1 the rejected one, both with the pair's
    images; the family's collator in per-row mode does the rest."""

    def __init__(self, seq_len: int, pairs: int, vlm_config, max_patches: int,
                 sp_size: int = 1):
        self.pairs = pairs
        self.inner = _REAL_VL[vlm_config.model_type][1](
            seq_len=seq_len, micro_batch_size=2 * pairs, vlm_config=vlm_config,
            max_patches=max_patches, sp_size=sp_size, per_row=True)

    def __call__(self, samples):
        rows = []
        for sample in samples[: self.pairs]:
            patches = sample["vis_patches"]
            for side in ("chosen", "rejected"):
                rows.append({"input_ids": sample[f"{side}_input_ids"],
                             "labels": sample[f"{side}_labels"],
                             "vis_patches": np.concatenate(patches) if len(patches) else None,
                             "vis_grids": list(sample["vis_grids"])})
        return self.inner(rows)


class VLMDPOTrainer(TextDPOTrainer):
    """DPO over a vision-language policy (``:314-399``): the same preference
    math, each row's log-prob sum through the whole composite
    (``VisionLanguageModel.sequence_logprob_sums``). The reference policy is
    the frozen base under LoRA, else a whole copy, as ``TextDPOTrainer``'s."""

    SUPPORTED_DATA_TYPES = TextDPOTrainer.SUPPORTED_DATA_TYPES + ("vlm_dpo",)
    BATCH_KEYS = VLMTrainer.BATCH_KEYS
    SP_WHOLE_KEYS = VLMTrainer.SP_WHOLE_KEYS

    def _check_model_kind(self) -> None:
        pass

    def _patch_budget(self) -> int:
        """The patches this rank's micro-batch holds: ``data.max_patches``
        split over the dp shards (the reference's over processes)."""
        dp = self.parallel_state.dp_size
        return self.args.data.max_patches // dp if dp > 1 else self.args.data.max_patches

    def _build_data_transform(self):
        pairs = self.data_shard()["rows"]
        self.data_transform = build_data_transform(
            "vlm_dpo", tokenizer=self.tokenizer, vlm_config=self.model.config,
            max_seq_len=self.args.data.max_seq_len,
            # the pair collator's per-row budget (two rows a pair)
            max_patches_per_sample=max(self.model.config.vision.merge_unit,
                                       self._patch_budget() // (2 * pairs)))

    def _build_dataloader(self):
        pairs = self.data_shard()["rows"]
        collator = VLMDPOPairCollator(self.args.data.max_seq_len, pairs, self.model.config,
                                      self._patch_budget(), sp_size=self.parallel_state.sp_size)
        self.dataloader = one_sample_dataloader(self, collator, pairs)


# the reference package's name (veomni_tpu.trainer.DPOTrainer)
DPOTrainer = TextDPOTrainer
