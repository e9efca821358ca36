"""The port's Qwen2.5-VL (``veomni_tpu_torch/models/qwen2_5_vl.py``)
against the JAX package's, on the CPU, f32, at toy size (LM 2 layers of
width 64; tower 3 blocks of width 32 at head dim 16, windows of 4 patches a
side, block 1 full-attention), inputs from numpy seeds.

Tolerances as ``tests/test_torch_qwen2_vl.py``: the index plan (window
permutation, ``seg_window``/``seg_full``, ``reverse``) exactly equal; the
tower and merger rtol 1e-5 (atol 1e-5); the loss rtol 1e-5 and each
gradient leaf within 1e-5 of its largest |value|; against transformers
4.57's ``Qwen2_5_VLForConditionalGeneration`` the loss rtol 1e-5. Also
``freeze_vision``, and one ``VLMTrainer`` step through ``tasks/train_vlm.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen2_5_vl as jq25
from veomni_tpu_torch.models import qwen2_5_vl as tq25
from test_torch_qwen2_vl import (
    GRIDS, IMG, TEXT, VID, VSTART, assert_tree_close, carried_model, configs, hf_loss_case,
    loss_and_grads, vl_batch, write_vlm_run,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

VISION = dict(depth=3, hidden_size=32, intermediate_size=48, num_heads=2, patch_size=2,
              spatial_merge_size=2, window_size=8, fullatt_block_indexes=[1], out_hidden_size=64)
# windows of 2 merged tokens a side: (1, 4, 6) has a partial window, (1, 8, 12) six;
# still images only (t = 1), where the reference's full-attention segments are
# HF's (a grid of t > 1 frames: test_multi_frame_grid_attends_per_frame)
GRIDS_25 = [(1, 4, 6), (1, 8, 4), (1, 8, 12)]


@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = configs("qwen2_5_vl", VISION)
    params, module = carried_model(jq25, jcfg, tcfg)
    return jcfg, tcfg, params, module


def test_window_plan_and_metadata_match_jax(toy):
    jcfg, tcfg, _, _ = toy
    for t, h, w in GRIDS_25:
        got = tq25._per_image_window_plan(t, h, w, tcfg.vision)
        ref = jq25._per_image_window_plan(t, h, w, jcfg.vision)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
    for grids, npad in ((GRIDS_25, 256), ([(1, 2, 2)], 8), ([], 16)):
        got = tq25.vision_metadata(grids, tcfg.vision, npad)
        ref = jq25.vision_metadata(grids, jcfg.vision, npad)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    meta = tq25.vision_metadata(GRIDS_25, tcfg.vision, 256)
    # the window order is a permutation of the real patches; reverse undoes it
    n = sum(t * h * w for t, h, w in GRIDS_25)
    assert sorted(meta["patch_gather"][:n]) == list(range(n))
    m = n // 4
    np.testing.assert_array_equal(
        (meta["patch_gather"][:n].reshape(m, 4)[:, 0] // 4)[meta["reverse"][:m]], np.arange(m))


def test_multi_frame_grid_attends_per_frame(toy):
    """A grid of t frames: the full-attention layers attend within a frame
    (HF ``cu_seqlens``); the reference gives the whole grid one segment
    (ROADMAP.md queue 3, diverges on purpose). The other plan keys agree."""
    jcfg, tcfg, _, _ = toy
    grids = [(1, 4, 6), (2, 4, 4)]
    got = tq25.vision_metadata(grids, tcfg.vision, 64)
    ref = jq25.vision_metadata(grids, jcfg.vision, 64)
    for k in ref:
        if k != "seg_full":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["seg_full"], np.r_[[1] * 24, [2] * 16, [3] * 16, [0] * 8])
    np.testing.assert_array_equal(ref["seg_full"], np.r_[[1] * 24, [2] * 32, [0] * 8])


def test_tower_and_merger_match_jax(toy):
    jcfg, tcfg, params, module = toy
    batch = vl_batch(jq25, jcfg, GRIDS_25, seed=1)
    names = ("pixel_values", "vis_pos_hw", "vis_seg_window", "vis_seg_full", "vis_reverse")
    ref = jax.jit(lambda p, *a: jq25.vision_forward(p, jcfg.vision, *a, dtype=jnp.float32))(
        params["vision_tower"], *(jnp.asarray(batch[k]) for k in names))
    t = {k: torch.from_numpy(batch[k]) for k in names}
    with torch.no_grad():
        got = module.vision_tower(t["pixel_values"], t["vis_pos_hw"],
                                  {k: t[k] for k in ("vis_seg_window", "vis_seg_full")},
                                  t["vis_reverse"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("freeze", [False, True], ids=["trained", "freeze_vision"])
def test_loss_and_grads_match_jax(toy, freeze):
    if freeze:
        jcfg, tcfg = configs("qwen2_5_vl", VISION, freeze_vision=True)
        params, module = carried_model(jq25, jcfg, tcfg, seed=3)
    else:
        jcfg, tcfg, params, module = toy
    jl, tl, jg, tg = loss_and_grads(jq25, jcfg, params, module,
                                    vl_batch(jq25, jcfg, GRIDS_25, seed=2))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_tree_close(tg, jg)
    if freeze:
        assert all(p.grad is None for p in module.vision_tower.parameters())


def test_loss_from_hf_dir_matches_transformers(tmp_path):
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration

    text = {k: TEXT[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                 "num_hidden_layers", "num_attention_heads",
                                 "num_key_value_heads", "rope_scaling")}
    cfg = Qwen2_5_VLConfig(
        text_config=dict(text, max_position_embeddings=512, rope_theta=10000.0,
                         tie_word_embeddings=False),
        vision_config=dict(depth=3, hidden_size=32, intermediate_size=48, num_heads=2,
                           in_channels=3, patch_size=2, temporal_patch_size=2,
                           spatial_merge_size=2, window_size=8, fullatt_block_indexes=[1],
                           out_hidden_size=64),
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART)
    torch.manual_seed(0)
    hf_model = Qwen2_5_VLForConditionalGeneration(cfg).eval()
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    # one still image and a grid of two frames (hf_loss_case's grids)
    ref, got, fm, batch = hf_loss_case(hf_model, str(tmp_path / "hf"), tq25, seed=4)
    assert fm.config.model_type == "qwen2_5_vl" and fm.config.vision.fullatt_block_indexes == (1,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the reference, whose full-attention layers see both frames at once, is off
    from veomni_tpu.models import build_foundation_model as j_build

    jm = j_build(str(tmp_path / "hf"), dtype="float32")
    jparams = jm.load_hf(str(tmp_path / "hf"))
    meta = jq25.vision_metadata([(1, 4, 6), (2, 4, 4)], jm.config.vision, 56)
    batch = {**batch, "vis_seg_full": meta["seg_full"]}
    loss_sum, metrics = jm.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss_sum) / float(metrics["ntokens"]) - ref) / ref > 1e-5


def test_vlm_trainer_step_through_train_vlm(tmp_path):
    from veomni_tpu_torch.tasks import train_vlm

    trainer = train_vlm.main([write_vlm_run(tmp_path, "qwen2_5_vl", VISION),
                              "--train.platform=cpu"])
    assert trainer.model.config.model_type == "qwen2_5_vl"
    with open(tmp_path / "out" / "metrics_rank0.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines and np.isfinite(lines[0]["loss"]) and lines[0]["loss"] > 0
