"""The Qwen2-VL / Qwen2.5-VL data pipeline: images to patches, the row
transforms and the packed-patch collators.

Port of the qwen-vl part of ``veomni_tpu/data/multimodal.py``: ``load_image``
(``:27-45``), ``frames_to_qwen_patches`` and ``image_to_qwen_patches``
(``:152-183``), the ``qwen2_vl``/``qwen2_5_vl``/``qwen3_vl`` transform
(``:186-279``), the ``qwen2_5_vl_conversation`` transform (``:282-351``),
``Qwen25VLCollator`` and ``Qwen2VLCollator`` (``:354-542``) and
``Qwen3VLCollator`` (``:545-569``). The slot VLM's
``build_vlm_transform``/``VLMCollator`` wait for their model (ROADMAP.md
slice F). ``per_row`` is the per-row patch
budgets of a batch split over ranks.

Static shapes: each micro-batch row is one padded sample (no cross-sample
packing of text), and every image of the micro-batch goes into ONE packed
patch sequence of ``max_patches`` rows with the family's index plan
(``models/qwen2_5_vl.py::vision_metadata``) and mrope position ids
[B, 3, S]. An image is an HWC array (uint8 or float in [0, 1]) or a path,
which PIL reads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from veomni_tpu_torch.data.data_collator import IGNORE_INDEX
from veomni_tpu_torch.data.data_transform import DATA_TRANSFORM_REGISTRY
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_image(source, image_size: int) -> np.ndarray:
    """An ndarray [H, W, C], nested lists, or a file path -> float32 [H, W, 3]
    in [0, 1], resized to ``image_size`` square when it is nonzero."""
    if isinstance(source, str):
        from PIL import Image

        img = Image.open(source).convert("RGB")
        if image_size:
            img = img.resize((image_size, image_size))
        return np.asarray(img, np.float32) / 255.0
    arr = np.asarray(source, np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if image_size and arr.shape[:2] != (image_size, image_size):
        # nearest-neighbour resize without PIL
        ys = (np.linspace(0, arr.shape[0] - 1, image_size)).astype(np.int64)
        xs = (np.linspace(0, arr.shape[1] - 1, image_size)).astype(np.int64)
        arr = arr[ys][:, xs]
    return arr


def frames_to_qwen_patches(frames: np.ndarray, vcfg) -> Tuple[np.ndarray, tuple]:
    """[T*tp, H, W, C] float in [0, 1] (tp consecutive distinct frames a
    temporal patch, the HF ``Qwen2VLImageProcessor`` contract) -> (patches
    [t*gh*gw, patch_dim] in merge-block order, grid (t, gh, gw)). A patch
    row flattens (C, T, Ph, Pw), as the Conv3d weight does."""
    p, m, tp = vcfg.patch_size, vcfg.spatial_merge_size, vcfg.temporal_patch_size
    nt, ih, iw = frames.shape[0], frames.shape[1], frames.shape[2]
    t = nt // tp
    unit = p * m
    h = max(unit, (ih // unit) * unit)
    w = max(unit, (iw // unit) * unit)
    if (ih, iw) != (h, w):
        ys = np.linspace(0, ih - 1, h).astype(np.int64)
        xs = np.linspace(0, iw - 1, w).astype(np.int64)
        frames = frames[:, ys][:, :, xs]
    x = (frames.astype(np.float32) - 0.5) / 0.5       # [nt, H, W, C]
    gh, gw = h // p, w // p
    x = x.reshape(t, tp, h, w, vcfg.in_channels)
    x = x.transpose(0, 4, 1, 2, 3)                     # [t, C, tp, H, W]
    x = x.reshape(t, vcfg.in_channels, tp, gh, p, gw, p)
    x = x.transpose(0, 3, 5, 1, 2, 4, 6).reshape(t, gh, gw, -1)
    x = x.reshape(t, gh // m, m, gw // m, m, -1).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(t * gh * gw, -1), (t, gh, gw)


def image_to_qwen_patches(img: np.ndarray, vcfg) -> Tuple[np.ndarray, tuple]:
    """[H, W, C] still image: the temporal dim repeats the frame
    (temporal_patch_size copies, a t = 1 grid), as the HF processor does."""
    frames = np.stack([img] * vcfg.temporal_patch_size)
    return frames_to_qwen_patches(frames, vcfg)


def _as_image(im) -> np.ndarray:
    arr = load_image(im, image_size=0) if isinstance(im, str) else np.asarray(im, np.float32)
    return arr / 255.0 if arr.max() > 1.5 else arr


@DATA_TRANSFORM_REGISTRY.register("qwen2_vl")
@DATA_TRANSFORM_REGISTRY.register("qwen2_5_vl")
@DATA_TRANSFORM_REGISTRY.register("qwen3_vl")
def build_qwen25_vl_transform(tokenizer=None, *, vlm_config=None, max_seq_len: int = 0,
                              max_patches_per_sample: int = 0, text_keys: str = "text",
                              channel_list=None, **_):
    """Rows {"text" | "input_ids", "images": [HWC arrays or paths]}: each
    image becomes ``vision_start`` + its merged-token count of placeholder
    tokens at the head of the sequence (inline '<image>' markers are the
    conversation transform's). The config carries the family's geometry."""
    cfg = vlm_config
    vcfg = cfg.vision
    channel_index = {name: i for i, name in enumerate(channel_list or [])}
    m = vcfg.spatial_merge_size

    def header_len(gs):
        return sum(1 + t * (gh // m) * (gw // m) for t, gh, gw in gs)

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        patches_list, grids = [], []
        budget = max_patches_per_sample
        for im in row.get("images", []):
            px, grid = image_to_qwen_patches(_as_image(im), vcfg)
            if budget and sum(p.shape[0] for p in patches_list) + px.shape[0] > budget:
                break  # keep placeholders and the patch budget consistent
            patches_list.append(px)
            grids.append(grid)
        if "input_ids" in row:
            text_ids: List[int] = list(row["input_ids"])
        else:
            text_ids = tokenizer(row[text_keys], add_special_tokens=True)["input_ids"]
        # a literal placeholder id in the text would desync the grid <-> token
        # walk (mrope and the feature scatter key on these ids): drop it, and
        # its label with it
        stray = {cfg.image_token_id, cfg.video_token_id}
        text_labels: List[int] = list(row.get("labels", text_ids))
        kept = [(t, lab) for t, lab in zip(text_ids, text_labels) if t not in stray]
        text_ids = [t for t, _ in kept]
        text_labels = [lab for _, lab in kept]
        # drop trailing images whose placeholder run would not fit: a cut run
        # would desync the grid <-> token walk
        while max_seq_len and grids and header_len(grids) >= max_seq_len:
            grids.pop()
            patches_list.pop()
        ids: List[int] = []
        labels: List[int] = []
        for (t, gh, gw) in grids:
            n_merged = t * (gh // m) * (gw // m)
            ids += [cfg.vision_start_token_id] + [cfg.image_token_id] * n_merged
            labels += [IGNORE_INDEX] * (n_merged + 1)
        ids += text_ids
        labels += text_labels
        if max_seq_len:
            ids, labels = ids[:max_seq_len], labels[:max_seq_len]
        out = {
            "input_ids": ids,
            "labels": labels,
            "vis_patches": np.concatenate(patches_list) if patches_list
            else np.zeros((0, vcfg.patch_dim), np.float32),
            "vis_grids": grids,
        }
        if "channel" in row:
            ch = row["channel"]
            if isinstance(ch, (int, np.integer)):
                out["channel"] = int(ch)
            elif ch in channel_index:
                out["channel"] = channel_index[ch]
            else:
                # -1 drops the row from the per-channel accounting
                logger.warning_once("unknown channel %r (known: %s): tokens excluded from "
                                    "per-channel accounting", ch, sorted(channel_index))
                out["channel"] = -1
        return out

    return transform


@DATA_TRANSFORM_REGISTRY.register("qwen2_5_vl_conversation")
def build_qwen25_vl_conversation_transform(tokenizer=None, *, vlm_config=None,
                                           max_seq_len: int = 0, messages_key: str = "messages",
                                           video_kwargs=None, **_):
    """Conversation rows with inline media parts (HF-conversations format)
    through the multimodal chat template (``qwen_vl_chat_template``):
    placeholders land where the media sit in the dialog, and labels
    supervise the assistant turns only."""
    from veomni_tpu_torch.data.chat_template import qwen_vl_chat_template

    template = qwen_vl_chat_template(tokenizer, vlm_config, video_kwargs=video_kwargs)
    vcfg = vlm_config.vision
    m = vcfg.spatial_merge_size
    image_like = (vlm_config.image_token_id, vlm_config.video_token_id)

    def transform(row: Dict[str, Any]) -> Dict[str, Any]:
        enc = template.encode_messages(row[messages_key])
        ids, labels = enc["input_ids"], enc["labels"]
        patches_list = enc.get("vis_patches", [])
        grids = enc.get("vis_grids", [])
        if max_seq_len and len(ids) > max_seq_len:
            # a cut may orphan media: keep the grids and patches of the
            # placeholder runs that survive whole, and cut a partial trailing
            # run (it would desync the grid <-> token walk)
            ids = ids[:max_seq_len]
            labels = labels[:max_seq_len]
            runs = []  # (start, length) of the placeholder runs
            i = 0
            while i < len(ids):
                if ids[i] in image_like:
                    j = i
                    while j < len(ids) and ids[j] in image_like:
                        j += 1
                    runs.append((i, j - i))
                    i = j
                else:
                    i += 1
            expected = [t * (gh // m) * (gw // m) for (t, gh, gw) in grids]
            keep = 0
            for (start, length), exp in zip(runs, expected):
                if length == exp:
                    keep += 1
                else:  # a partial trailing run: cut before its vision_start
                    cut = (start - 1 if start and ids[start - 1] == vlm_config.vision_start_token_id
                           else start)
                    ids = ids[:cut]
                    labels = labels[:cut]
                    break
            grids = grids[:keep]
            patches_list = patches_list[:keep]
        return {
            "input_ids": ids,
            "labels": labels,
            "vis_patches": np.concatenate(patches_list) if patches_list
            else np.zeros((0, vcfg.patch_dim), np.float32),
            "vis_grids": [tuple(g) for g in grids],
        }

    return transform


class Qwen25VLCollator:
    """Pads samples to [B, S] text plus ONE packed, window-ordered patch
    sequence a micro-batch (the static ``max_patches`` budget) with the full
    index plan (``vision_metadata``) and mrope position ids [B, 3, S].

    ``per_row=True`` is the per-row patch-budget layout of a batch split
    over ranks (``:366-390``): each row gets its own ``max_patches //
    micro_batch_size`` buffer and index plan, so the vision arrays gain a
    row dim ([B, Pr, ...]) and the model flattens them with per-row offsets
    (``models/qwen2_5_vl.py::flatten_per_row_vision``)."""

    def __init__(self, seq_len: int, micro_batch_size: int, vlm_config, max_patches: int,
                 sp_size: int = 1, per_row: bool = False, with_channels: bool = False):
        if seq_len % max(sp_size, 1):
            raise ValueError(f"seq_len {seq_len} % sp_size {sp_size} != 0")
        unit = vlm_config.vision.merge_unit
        if max_patches % unit:
            raise ValueError(f"max_patches {max_patches} % merge_unit {unit} != 0")
        self.seq_len = seq_len
        self.micro_batch_size = micro_batch_size
        self.cfg = vlm_config
        self.per_row = per_row
        self.with_channels = with_channels
        if per_row:
            row = max_patches // micro_batch_size
            row -= row % unit
            if row <= 0:
                raise ValueError(f"per-row budget {row} (= max_patches {max_patches} / "
                                 f"micro_batch {micro_batch_size}) too small")
            self.max_patches = row  # a row's budget in this layout
        else:
            self.max_patches = max_patches

    def _sync_grids(self, ids, lab, grids):
        """Keep grids and placeholder runs consistent after the seq_len cut:
        a run cut mid-image would desync the grid iterator of
        ``mrope_position_ids`` and shift every later image's features in the
        scatter. A cut or absent run is cut from ids, with its grid and
        patches."""
        cfg, vcfg = self.cfg, self.cfg.vision
        m = vcfg.spatial_merge_size
        expected = [t * (gh // m) * (gw // m) for (t, gh, gw) in grids]
        patch_counts = [t * gh * gw for (t, gh, gw) in grids]
        vis = (ids == cfg.image_token_id) | (ids == cfg.video_token_id)
        kept = 0
        i = 0
        n = len(ids)
        while i < n and kept < len(expected):
            if not vis[i]:
                i += 1
                continue
            j = i
            while j < n and vis[j]:
                j += 1
            if j - i == expected[kept]:
                kept += 1
                i = j
            else:
                # a cut run: cut it (and its vision_start marker) off
                cut = i - 1 if i > 0 and ids[i - 1] == cfg.vision_start_token_id else i
                ids, lab = ids[:cut], lab[:cut]
                break
        return ids, lab, grids[:kept], sum(patch_counts[:kept])

    def _assemble_text(self, samples) -> Tuple[Dict[str, np.ndarray], np.ndarray, list]:
        """(text arrays, the patch buffer, the grids). Packed: the buffer
        [max_patches, patch_dim] and the micro-batch's grids in reading
        order; per row: [B, max_patches, patch_dim] and each row's grids."""
        b, s = self.micro_batch_size, self.seq_len
        vcfg = self.cfg.vision
        out = {
            "input_ids": np.zeros((b, s), np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
        }
        if self.with_channels:
            out["channel_ids"] = np.full((b, s), -1, np.int32)
        row_patches: List[Any] = [None] * b
        row_grids: List[list] = [[] for _ in range(b)]
        total = 0
        for i, sample in enumerate(samples[:b]):
            ids = np.asarray(sample["input_ids"], np.int32)[:s]
            lab = np.asarray(sample["labels"], np.int32)[: len(ids)]
            px, grids = sample.get("vis_patches"), list(sample.get("vis_grids", []))
            ids, lab, grids, n_keep_patches = self._sync_grids(ids, lab, grids)
            if px is not None and n_keep_patches:
                px = np.asarray(px)[:n_keep_patches]
                used = len(px) if self.per_row else total + len(px)
                if used > self.max_patches:
                    scope = "row" if self.per_row else "micro-batch"
                    raise ValueError(f"{scope} exceeds max_patches={self.max_patches}; raise "
                                     "data.max_patches or lower image resolution")
                total += len(px)
                row_patches[i] = px
                row_grids[i] = grids
            shifted = np.concatenate([lab[1:], [IGNORE_INDEX]]).astype(np.int32)
            n = len(ids)
            out["input_ids"][i, :n] = ids
            out["labels"][i, :n] = shifted
            out["segment_ids"][i, :n] = 1
            if self.with_channels:
                out["channel_ids"][i, :n] = int(sample.get("channel", -1))
        if self.per_row:
            px = np.zeros((b, self.max_patches, vcfg.patch_dim), np.float32)
            for i, rp in enumerate(row_patches):
                if rp is not None:
                    px[i, : len(rp)] = rp
            return out, px, row_grids
        px = np.zeros((self.max_patches, vcfg.patch_dim), np.float32)
        cat = [rp for rp in row_patches if rp is not None]
        if cat:
            cat = np.concatenate(cat)
            px[: len(cat)] = cat
        return out, px, [g for row in row_grids for g in row]

    def _plan(self, grids, vision_metadata):
        """The index plan: one for the micro-batch, or each row's stacked."""
        if not self.per_row:
            return vision_metadata(grids, self.cfg.vision, self.max_patches)
        metas = [vision_metadata(g, self.cfg.vision, self.max_patches) for g in grids]
        return {k: np.stack([m[k] for m in metas]) for k in metas[0]}

    def _flat(self, grids):
        return [g for row in grids for g in row] if self.per_row else grids

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        from veomni_tpu_torch.models.qwen2_5_vl import mrope_position_ids, vision_metadata

        out, px, grids = self._assemble_text(samples)
        out["position_ids"] = mrope_position_ids(
            out["input_ids"].astype(np.int64), self._flat(grids), self.cfg).astype(np.int32)
        meta = self._plan(grids, vision_metadata)
        if self.per_row:
            out["pixel_values"] = np.take_along_axis(
                px, meta["patch_gather"][..., None].astype(np.int64), axis=1)
        else:
            out["pixel_values"] = px[meta["patch_gather"]]
        out["vis_pos_hw"] = meta["pos_hw"]
        out["vis_seg_window"] = meta["seg_window"]
        out["vis_seg_full"] = meta["seg_full"]
        out["vis_reverse"] = meta["reverse"]
        out["vis_merged_mask"] = meta["merged_mask"]
        return out


class Qwen2VLCollator(Qwen25VLCollator):
    """Qwen2-VL: the patches stay in processor (merge-block) order and every
    layer attends within a frame, so the plan is (pos_hw, per-frame
    segments, merged_mask)."""

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        from veomni_tpu_torch.models.qwen2_vl import mrope_position_ids, vision_metadata

        out, px, grids = self._assemble_text(samples)
        out["position_ids"] = mrope_position_ids(
            out["input_ids"].astype(np.int64), self._flat(grids), self.cfg).astype(np.int32)
        meta = self._plan(grids, vision_metadata)
        out["pixel_values"] = px
        out["vis_pos_hw"] = meta["pos_hw"]
        out["vis_seg"] = meta["seg"]
        out["vis_merged_mask"] = meta["merged_mask"]
        return out


class Qwen3VLCollator(Qwen25VLCollator):
    """Qwen3-VL: the patches stay in processor (merge-block) order, and the
    plan carries the bilinear plan of the learnable position embedding in
    place of window segments (``:545-569``)."""

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        from veomni_tpu_torch.models.qwen3_vl import mrope_position_ids, vision_metadata

        out, px, grids = self._assemble_text(samples)
        out["position_ids"] = mrope_position_ids(
            out["input_ids"].astype(np.int64), self._flat(grids), self.cfg).astype(np.int32)
        meta = self._plan(grids, vision_metadata)
        out["pixel_values"] = px
        out["vis_pos_hw"] = meta["pos_hw"]
        out["vis_pos_interp_idx"] = meta["pos_interp_idx"]
        out["vis_pos_interp_w"] = meta["pos_interp_w"]
        out["vis_seg_full"] = meta["seg_full"]
        out["vis_merged_mask"] = meta["merged_mask"]
        return out
