"""VLMTrainer: vision-language SFT for Qwen2-VL, Qwen2.5-VL, Qwen3-VL and
Qwen3-VL-MoE.

Port of ``veomni_tpu/trainer/vlm_trainer.py`` (``:33-230``),
for the families that share one data contract: the family's row
transform (``data/multimodal.py``, whatever ``data.data_type`` names, as in
the reference) and its packed-patch collator, one sample a micro-batch row
(no text packing), the micro-batch's images in one padded patch sequence of
``data.max_patches`` rows. ``freeze_vision`` lives in the model config
(``model.config_overrides``): the tower runs without autograd and AdamW
still decays it (``models/qwen2_5_vl.py``).

Over several ranks (``:44-49``) each rank's rows take the per-row patch
budgets (``per_row``: every row its own buffer and index plan, which the
model flattens), as the reference does when its batch is split over
processes; the rows ship whole, and under sequence parallelism the model
keeps its sequence chunk after the vision merge (``models/qwen2_5_vl.py``).
The reference's ``_batch_sharding_map`` has no twin: each rank's arrays
are its own. ``model.lora`` adapts the composite's leaves its target
regexes match, the tower's included (``lora/lora.py``), as the reference's
generic adapter tree does. The slot VLM raises when the model is built
(``models/auto.py``).
"""

from __future__ import annotations

from veomni_tpu_torch.data.data_loader import build_dataloader
from veomni_tpu_torch.data.data_transform import build_data_transform
from veomni_tpu_torch.data.multimodal import Qwen2VLCollator, Qwen3VLCollator, Qwen25VLCollator
from veomni_tpu_torch.trainer.base import BATCH_KEYS, SUPPORTED_DATA_TYPES, BaseTrainer

# model_type -> (the data transform's key, the collator)
_REAL_VL = {
    "qwen2_vl": ("qwen2_vl", Qwen2VLCollator),
    "qwen2_5_vl": ("qwen2_5_vl", Qwen25VLCollator),
    "qwen3_vl": ("qwen3_vl", Qwen3VLCollator),
    "qwen3_vl_moe": ("qwen3_vl", Qwen3VLCollator),  # the same tower and data contract
}


class VLMTrainer(BaseTrainer):
    BATCH_KEYS = BATCH_KEYS + ("pixel_values", "vis_pos_hw", "vis_seg", "vis_seg_window",
                               "vis_seg_full", "vis_reverse", "vis_merged_mask",
                               "vis_pos_interp_idx", "vis_pos_interp_w")
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES + ("qwen2_vl", "qwen2_5_vl", "qwen3_vl",
                                                   "qwen2_5_vl_conversation")
    # whole rows ship to the model, which cuts the sequence after the merge
    SP_WHOLE_KEYS = BATCH_KEYS

    @property
    def _vlm_per_row(self) -> bool:
        """Per-row patch budgets whenever the batch is split over ranks."""
        return self.parallel_state.world_size > 1

    @property
    def _real_vl(self):
        return _REAL_VL[self.model.config.model_type]

    def _build_model(self):
        super()._build_model()
        model_type = self.model.config.model_type
        if model_type not in _REAL_VL:
            raise NotImplementedError(
                f"VLMTrainer: model_type {model_type!r} is not a vision-language family the port "
                f"has ({', '.join(_REAL_VL)}); the others are slice F (ROADMAP.md queue 1)")

    def _build_data_transform(self):
        d = self.args.data
        key, _ = self._real_vl
        global_mb = max(1, self.args.train.micro_batch_size * self.parallel_state.dp_size)
        local_mb = max(1, self.data_shard()["rows"])
        # the budget is per micro-batch (packed) or per row (per-row); each
        # sample is capped to its share, so legitimate data never overflows
        # the static shape
        self.data_transform = build_data_transform(
            key, tokenizer=self.tokenizer, vlm_config=self.model.config,
            max_seq_len=d.max_seq_len,
            max_patches_per_sample=max(self.model.config.vision.merge_unit, d.max_patches // (
                global_mb if self._vlm_per_row else local_mb)),
            text_keys=d.text_keys, channel_list=d.channel_list,
        )

    def _build_dataloader(self):
        t, d = self.args.train, self.args.data
        ps = self.parallel_state
        self.grad_accum_steps = self.args.compute_grad_accum(ps.dp_size)
        shard = self.data_shard()
        local_mb = shard["rows"]
        _, collator_cls = self._real_vl
        collator = collator_cls(seq_len=d.max_seq_len, micro_batch_size=local_mb,
                                vlm_config=self.model.config, max_patches=d.max_patches,
                                sp_size=ps.sp_size, per_row=self._vlm_per_row,
                                with_channels=bool(d.channel_list))
        self.dataloader = build_dataloader(
            d.dataloader_type, dataset=self.dataset, collate_fn=collator,
            micro_batch_size=local_mb, grad_accum_steps=self.grad_accum_steps,
            samples_per_micro_batch=local_mb,  # 1:1, no packing
            seed=t.seed, dp_rank=shard["dp_rank"], dp_size=shard["dp_size"],
            drop_last=d.drop_last, infinite=True,
        )
