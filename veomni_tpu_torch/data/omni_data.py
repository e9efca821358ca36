"""The Qwen3-Omni data pipeline: the row transform and the collator.

Port of ``veomni_tpu/data/omni_data.py``: ``build_qwen3_omni_transform``
(``:23-120``, registered as ``qwen3_omni``) turns a row with raw media into
its placeholder-expanded tokens, its image patches and its mel features;
``Qwen3OmniCollator`` (``:123-216``) pads a micro-batch to [B, S] text, ONE
packed patch buffer of ``max_patches`` rows with the Qwen3-VL index plan,
ONE padded chunk buffer of ``max_audio_chunks`` chunks with the audio plan
(``models/qwen3_omni_moe.py::audio_metadata``) and the omni 3-stream
position ids [B, 3, S].

Rows: {"text" | "input_ids", "images": [HWC arrays or paths], "audios": [wav
or ``.npy`` paths, 1-D arrays at 16 kHz, or precomputed mel [n_mels, T]]}.
Each medium becomes its placeholder run at the head of the sequence:
``audio_start`` + one ``audio`` token a conv frame, then ``vision_start`` +
one ``image`` token a merged patch group.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from veomni_tpu_torch.data.data_collator import IGNORE_INDEX
from veomni_tpu_torch.data.data_transform import DATA_TRANSFORM_REGISTRY
from veomni_tpu_torch.data.media import load_audio, log_mel_spectrogram
from veomni_tpu_torch.data.multimodal import _as_image, image_to_qwen_patches


@DATA_TRANSFORM_REGISTRY.register("qwen3_omni")
def build_qwen3_omni_transform(tokenizer=None, *, omni_config=None, max_seq_len: int = 0,
                               max_patches_per_sample: int = 0,
                               max_mel_frames_per_sample: int = 0, text_keys: str = "text",
                               **_):
    """The row transform of a ``Qwen3OmniMoeConfig``. Images past the patch
    budget, audios past the mel budget and media whose placeholder runs
    would not fit ``max_seq_len`` are dropped (the last ones first, images
    before audios), so placeholders, patches and chunks stay consistent."""
    from veomni_tpu_torch.models.qwen3_omni_moe import audio_output_lengths

    cfg = omni_config
    vcfg, acfg = cfg.vision, cfg.audio
    m = vcfg.spatial_merge_size

    def to_mel(item) -> np.ndarray:
        arr = None if isinstance(item, str) else np.asarray(item, np.float32)
        if arr is not None and arr.ndim == 2 and arr.shape[0] == acfg.num_mel_bins:
            return arr  # precomputed mel features
        wav = load_audio(item if arr is None else arr)
        return log_mel_spectrogram(wav, n_mels=acfg.num_mel_bins).T  # [mel, T]

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        patches_list, grids = [], []
        for im in row.get("images", []):
            px, grid = image_to_qwen_patches(_as_image(im), vcfg)
            if (max_patches_per_sample
                    and sum(p.shape[0] for p in patches_list) + px.shape[0]
                    > max_patches_per_sample):
                break
            patches_list.append(px)
            grids.append(grid)
        mels: List[np.ndarray] = []
        for au in row.get("audios", []):
            mel = to_mel(au)
            if (max_mel_frames_per_sample
                    and sum(x.shape[1] for x in mels) + mel.shape[1] > max_mel_frames_per_sample):
                break
            mels.append(mel)

        if "input_ids" in row:
            text_ids = list(row["input_ids"])
        else:
            text_ids = tokenizer(row[text_keys], add_special_tokens=True)["input_ids"]
        # a literal placeholder id in the text would desync the media walk
        stray = {cfg.image_token_id, cfg.video_token_id, cfg.audio_token_id}
        kept = [(t, lab) for t, lab in zip(text_ids, row.get("labels", text_ids))
                if t not in stray]
        text_ids = [t for t, _ in kept]
        text_labels = [lab for _, lab in kept]

        def header_len():
            n = sum(1 + t * (gh // m) * (gw // m) for t, gh, gw in grids)
            return n + sum(1 + audio_output_lengths(x.shape[1]) for x in mels)

        while max_seq_len and (grids or mels) and header_len() >= max_seq_len:
            if grids:
                grids.pop()
                patches_list.pop()
            else:
                mels.pop()

        ids: List[int] = []
        labels: List[int] = []
        for mel in mels:
            n_tok = audio_output_lengths(mel.shape[1])
            ids += [cfg.audio_start_token_id] + [cfg.audio_token_id] * n_tok
            labels += [IGNORE_INDEX] * (n_tok + 1)
        for t, gh, gw in grids:
            n_merged = t * (gh // m) * (gw // m)
            ids += [cfg.vision_start_token_id] + [cfg.image_token_id] * n_merged
            labels += [IGNORE_INDEX] * (n_merged + 1)
        ids += text_ids
        labels += text_labels
        if max_seq_len:
            ids, labels = ids[:max_seq_len], labels[:max_seq_len]
        return {
            "input_ids": ids,
            "labels": labels,
            "vis_patches": np.concatenate(patches_list) if patches_list
            else np.zeros((0, vcfg.patch_dim), np.float32),
            "vis_grids": grids,
            "audio_mels": mels,
        }

    return transform


class Qwen3OmniCollator:
    """Batch assembly for the Qwen3-Omni-MoE thinker: [B, S] text, the packed
    patch buffer (the Qwen3-VL contract), the padded audio chunk buffer (the
    ``audio_metadata`` contract) and the omni position ids [B, 3, S]."""

    def __init__(self, omni_config, seq_len: int, micro_batch_size: int, max_patches: int,
                 max_audio_chunks: int, sp_size: int = 1):
        if seq_len % max(sp_size, 1):
            raise ValueError(f"seq_len {seq_len} % sp_size {sp_size} != 0")
        unit = omni_config.vision.merge_unit
        if max_patches % unit:
            raise ValueError(f"max_patches {max_patches} % merge_unit {unit} != 0")
        self.cfg = omni_config
        self.seq_len = seq_len
        self.micro_batch_size = micro_batch_size
        self.max_patches = max_patches
        self.max_audio_chunks = max_audio_chunks

    @property
    def max_audio_frames(self) -> int:
        return self.max_audio_chunks * self.cfg.audio.chunk_out_len

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        from veomni_tpu_torch.models.qwen3_omni_moe import (
            audio_metadata, omni_position_ids, pack_audio_chunks,
        )
        from veomni_tpu_torch.models.qwen3_vl import vision_metadata

        cfg, vcfg, acfg = self.cfg, self.cfg.vision, self.cfg.audio
        b, s = self.micro_batch_size, self.seq_len
        out: Dict[str, np.ndarray] = {
            "input_ids": np.zeros((b, s), np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
        }
        all_patches, all_grids, all_mels = [], [], []
        n_patches = n_chunks = 0
        for i, sample in enumerate(samples[:b]):
            ids = np.asarray(sample["input_ids"], np.int32)[:s]
            lab = np.asarray(sample["labels"], np.int32)[: len(ids)]
            px = sample.get("vis_patches")
            mels = list(sample.get("audio_mels", []))
            n_chunks += sum(-(-mel.shape[1] // acfg.chunk_len) for mel in mels)
            if n_chunks > self.max_audio_chunks:
                raise ValueError(f"micro-batch exceeds max_audio_chunks={self.max_audio_chunks}")
            if px is not None and len(px):
                if n_patches + len(px) > self.max_patches:
                    raise ValueError(f"micro-batch exceeds max_patches={self.max_patches}")
                n_patches += len(px)
                all_patches.append(np.asarray(px))
            all_grids += list(sample.get("vis_grids", []))
            all_mels += mels
            n = len(ids)
            out["input_ids"][i, :n] = ids
            out["labels"][i, :n] = np.concatenate([lab[1:], [IGNORE_INDEX]]).astype(np.int32)
            out["segment_ids"][i, :n] = 1

        out["position_ids"] = omni_position_ids(
            out["input_ids"].astype(np.int64), cfg, image_grid_thw=all_grids,
            audio_lens=[x.shape[1] for x in all_mels]).astype(np.int32)
        vmeta = vision_metadata(all_grids, vcfg, self.max_patches)
        px_buf = np.zeros((self.max_patches, vcfg.patch_dim), np.float32)
        if all_patches:
            cat = np.concatenate(all_patches)
            px_buf[: len(cat)] = cat
        out["pixel_values"] = px_buf
        out["vis_pos_hw"] = vmeta["pos_hw"]
        out["vis_pos_interp_idx"] = vmeta["pos_interp_idx"]
        out["vis_pos_interp_w"] = vmeta["pos_interp_w"]
        out["vis_seg_full"] = vmeta["seg_full"]
        out["vis_merged_mask"] = vmeta["merged_mask"]
        ameta = audio_metadata([x.shape[1] for x in all_mels], acfg, self.max_audio_chunks,
                               self.max_audio_frames)
        out["audio_chunks"] = pack_audio_chunks(all_mels, acfg, self.max_audio_chunks)
        out["aud_frame_gather"] = ameta["frame_gather"]
        out["aud_seg"] = ameta["seg"]
        out["aud_frame_mask"] = ameta["frame_mask"]
        return out
