"""OmniTrainer: audio + vision + text SFT of the Qwen3-Omni-MoE thinker.

Port of the Qwen3-Omni branch of ``veomni_tpu/trainer/omni_trainer.py``
(``:174-350``): the model from the registry (``_build_model``, ``:175-181``),
the ``qwen3_omni`` row transform with each sample's share of the patch and
mel budgets (``:240-266``), and ``Qwen3OmniCollator`` (``:276-283``): one
sample a micro-batch row, the micro-batch's images in one padded patch
buffer of ``data.max_patches`` rows and its audios in one padded chunk
buffer of ``data.max_audio_chunks`` chunks (``data/omni_data.py``).

Over several ranks each rank takes its dp share of the rows and packs them
into its share of the two buffers; the towers run without sequence
parallelism (the reference's ``without_sp`` scopes, ``:318-325``), as the
VLM's do. The reference's ``_batch_sharding_map`` has no twin: each rank's
arrays are its own. One gate raises ``NotImplementedError`` for what the
port does not have yet, naming its ROADMAP.md item: the seed_omni slot
composite (no ``model_type``, or ``OmniConfig`` overrides) with its
``OmniCollator`` (which the reference also builds for ``qwen2_5_omni``;
the port trains that thinker through ``build_foundation_model`` and the
train step), ``janus``, and Ulysses or context parallelism on this trainer.
"""

from __future__ import annotations

import json
import os

from veomni_tpu_torch.data.data_loader import build_dataloader
from veomni_tpu_torch.data.data_transform import build_data_transform
from veomni_tpu_torch.trainer.base import BATCH_KEYS, SUPPORTED_DATA_TYPES, BaseTrainer

OMNI_MODEL_TYPES = ("qwen3_omni_moe", "qwen3_omni_moe_thinker")
# what the gate names for the other omni trainer families (ROADMAP.md queue 1)
_NOT_PORTED = {
    "janus": "DiT and the generators with Janus (JanusCollator), slice F",
    "qwen2_5_omni": "the slot VLM with seed_omni and its OmniCollator, slice F",
    "qwen2_5_omni_thinker": "the slot VLM with seed_omni and its OmniCollator, slice F",
}
_SEED_OMNI = "the slot VLM with seed_omni and its OmniCollator, slice F"
_ULYSSES = "Ulysses and context parallelism on the omni trainer, slice F"


def omni_gate(args) -> str:
    """The model_type the omni trainer would build, or ``NotImplementedError``
    naming the ROADMAP.md item of a family or layout it does not have."""
    m, t = args.model, args.train
    if t.ulysses_parallel_size > 1 or t.context_parallel_size > 1:
        raise NotImplementedError(f"OmniTrainer: train.ulysses_parallel_size / "
                                  f"context_parallel_size > 1 is not ported yet ({_ULYSSES} "
                                  "of ROADMAP.md queue 1)")
    model_type = m.config_overrides.get("model_type") or m.model_type
    if not model_type and m.config_path:
        with open(os.path.join(m.config_path, "config.json")) as f:
            model_type = json.load(f).get("model_type", "")
    if model_type not in OMNI_MODEL_TYPES:
        item = _NOT_PORTED.get(model_type, _SEED_OMNI)
        raise NotImplementedError(f"OmniTrainer: model_type {model_type or 'seed_omni'!r} is not "
                                  f"ported yet ({item} of ROADMAP.md queue 1); the port's omni "
                                  "trainer trains qwen3_omni_moe")
    return model_type


class OmniTrainer(BaseTrainer):
    BATCH_KEYS = BATCH_KEYS + ("pixel_values", "vis_pos_hw", "vis_pos_interp_idx",
                               "vis_pos_interp_w", "vis_seg_full", "vis_merged_mask",
                               "audio_chunks", "aud_frame_gather", "aud_seg", "aud_frame_mask")
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES + ("qwen3_omni",)

    def __init__(self, args):
        omni_gate(args)  # before the mesh is laid out
        super().__init__(args)

    def _budgets(self):
        """(rows of the global micro-batch, this rank's patch buffer, its
        chunk buffer): the rank's share of ``data.max_patches`` (a multiple
        of the merge unit) and of ``data.max_audio_chunks``."""
        d, cfg = self.args.data, self.model.config
        global_mb = max(1, self.args.train.micro_batch_size * self.parallel_state.dp_size)
        local_mb = self.data_shard()["rows"]
        unit = cfg.vision.merge_unit
        patches = d.max_patches * local_mb // global_mb
        return global_mb, max(unit, patches - patches % unit), max(
            1, d.max_audio_chunks * local_mb // global_mb)

    def _build_data_transform(self):
        d, cfg = self.args.data, self.model.config
        global_mb, _, _ = self._budgets()
        acfg = cfg.audio
        self.data_transform = build_data_transform(
            "qwen3_omni", tokenizer=self.tokenizer, omni_config=cfg, max_seq_len=d.max_seq_len,
            max_patches_per_sample=max(cfg.vision.merge_unit, d.max_patches // global_mb),
            max_mel_frames_per_sample=max(acfg.chunk_len,
                                          d.max_audio_chunks * acfg.chunk_len // global_mb),
            text_keys=d.text_keys,
        )

    def _build_dataloader(self):
        from veomni_tpu_torch.data.omni_data import Qwen3OmniCollator

        t, d = self.args.train, self.args.data
        ps = self.parallel_state
        self.grad_accum_steps = self.args.compute_grad_accum(ps.dp_size)
        shard = self.data_shard()
        _, patches, chunks = self._budgets()
        collator = Qwen3OmniCollator(self.model.config, d.max_seq_len, shard["rows"],
                                     max_patches=patches, max_audio_chunks=chunks,
                                     sp_size=ps.sp_size)
        self.dataloader = build_dataloader(
            d.dataloader_type, dataset=self.dataset, collate_fn=collator,
            micro_batch_size=shard["rows"], grad_accum_steps=self.grad_accum_steps,
            samples_per_micro_batch=shard["rows"],  # 1:1, no packing
            seed=t.seed, dp_rank=shard["dp_rank"], dp_size=shard["dp_size"],
            drop_last=d.drop_last, infinite=True,
        )
