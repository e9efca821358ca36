"""The port's Qwen2.5-Omni thinker (``veomni_tpu_torch/models/qwen2_5_omni.py``)
against the JAX package's, on the CPU, f32, at the reference test's toy size
(``tests/test_qwen2_5_omni.py``: LM 2 layers of width 64; tower 2 blocks of
width 32, windows of 8 pixels, block 1 full; audio encoder 2 layers of
width 32 over 16 mel bins, chunks of 16 frames, a 32-frame slot), inputs
from numpy seeds.

Tolerances: the audio encoder's features rtol 1e-5 (atol 1e-5); the loss
rtol 2e-5 and each gradient leaf within 2e-4 of its largest |value|;
against transformers 4.57's ``Qwen2_5OmniThinkerForConditionalGeneration``
the encoder rtol 2e-4 (atol 2e-4) and the loss rtol 2e-4 (the reference
test's); the HF export read back bit-equal and equal, tensor for tensor, to
the directory transformers wrote (but for the encoder's generation-only
``audio_bos_eos_token``); the JAX package's ``save_hf_checkpoint`` read by
the port bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen2_5_omni as jo
from veomni_tpu.models import qwen2_5_vl as jq25
from veomni_tpu_torch.models import qwen2_5_omni as to
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from test_torch_qwen2_vl import assert_tree_close, torch_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

IMG, VID, VSTART = 9, 10, 8
AUD, ASTART, AEND = 5, 6, 7
AUDIO = dict(num_mel_bins=16, d_model=32, encoder_layers=2, encoder_attention_heads=2,
             encoder_ffn_dim=64, n_window=8, max_source_positions=64, output_dim=64)
VISION = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2, in_channels=3,
              patch_size=2, temporal_patch_size=2, spatial_merge_size=2, window_size=8,
              fullatt_block_indexes=[1], out_hidden_size=64)
TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
            tie_word_embeddings=False, rope_scaling={"type": "default", "mrope_section": [2, 3, 3]})
TOKENS = dict(audio_token_index=AUD, image_token_index=IMG, video_token_index=VID,
              vision_start_token_id=VSTART, audio_start_token_id=ASTART,
              audio_end_token_id=AEND, position_id_per_seconds=25)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import (
        Qwen2_5OmniThinkerConfig, Qwen2_5OmniThinkerForConditionalGeneration,
    )

    cfg = Qwen2_5OmniThinkerConfig(audio_config=AUDIO, vision_config=VISION,
                                   text_config=TEXT, **TOKENS)
    torch.manual_seed(0)
    model = Qwen2_5OmniThinkerForConditionalGeneration(cfg).eval()
    out = tmp_path_factory.mktemp("q25omni") / "hf_thinker"
    model.save_pretrained(out, safe_serialization=True)
    return model, str(out)


@pytest.fixture(scope="module")
def toy(hf_dir):
    """(JAX config, params, the port's model with the same weights): the
    reference's own import of the transformers directory (a 32-frame slot)."""
    from veomni_tpu.models import build_foundation_model as j_build

    jm = j_build(hf_dir[1], dtype="float32", audio_max_frames=32)
    params = jax.tree.map(np.asarray, jm.load_hf(hf_dir[1]))
    from veomni_tpu_torch.models.auto import build_foundation_model

    fm = build_foundation_model(hf_dir[1], dtype="float32", audio_max_frames=32)
    module = fm.init(torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(module, params)
    return jm.config, params, fm, module


def thinker_batch(cfg, seed):
    """Two rows, each an audio (a 32-frame slot -> 8 tokens) and an image (a
    4x4 grid -> 4 merged tokens), the second audio's run masked off."""
    rng = np.random.default_rng(seed)
    acfg, vcfg = cfg.audio, cfg.vision
    grids = [(1, 4, 4), (1, 4, 4)]
    rows = []
    for _ in range(2):
        rows.append([ASTART] + [AUD] * acfg.tokens_per_audio + [AEND]
                    + list(rng.integers(11, 256, 4)) + [VSTART] + [IMG] * 4
                    + list(rng.integers(11, 256, 6)))
    input_ids = np.asarray(rows, np.int64)
    labels = np.where((input_ids == AUD) | (input_ids == IMG), -100, input_ids)
    px = rng.standard_normal((32, vcfg.patch_dim)).astype(np.float32)
    meta = jq25.vision_metadata(grids, vcfg, 32)
    return dict(
        input_ids=input_ids.astype(np.int32),
        labels=np.concatenate([labels[:, 1:], np.full((2, 1), -100)], 1).astype(np.int32),
        position_ids=jq25.mrope_position_ids(input_ids, grids, cfg).astype(np.int32),
        segment_ids=np.ones_like(input_ids, np.int32),
        pixel_values=px[meta["patch_gather"]], vis_pos_hw=meta["pos_hw"],
        vis_seg_window=meta["seg_window"], vis_seg_full=meta["seg_full"],
        vis_reverse=meta["reverse"], vis_merged_mask=meta["merged_mask"],
        audio_features=rng.standard_normal((2, acfg.max_frames, acfg.num_mel_bins)
                                           ).astype(np.float32),
        audio_mask=np.asarray([True, False]))


def test_audio_encoder_matches_jax_and_transformers(hf_dir, toy):
    jcfg, params, fm, module = toy
    acfg = jcfg.audio
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, acfg.max_frames, acfg.num_mel_bins)).astype(np.float32)
    ref = jax.jit(lambda p, x: jo.audio_encoder_forward(p, acfg, x, dtype=jnp.float32))(
        params["audio_tower"], jnp.asarray(mel))
    with torch.no_grad():
        got = module.audio_tower(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        hf = hf_dir[0].audio_tower(torch.from_numpy(mel[0].T.copy()),
                                   feature_lens=torch.tensor([acfg.max_frames]),
                                   aftercnn_lens=torch.tensor([acfg.max_frames // 2]))
    np.testing.assert_allclose(got[0].numpy(), hf.last_hidden_state.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_loss_and_grads_match_jax(toy):
    jcfg, params, fm, module = toy
    batch = thinker_batch(jcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jo.loss_fn(p, jcfg, b),
                                             has_aux=True))(params, jb)
    module.zero_grad(set_to_none=True)
    tl, _ = module.loss_fn(torch_batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    tg = to_jax_tree(module, grads=True)
    assert set(tg) == {"language_model", "vision_tower", "audio_tower"}
    assert_tree_close(tg, jax.tree.map(np.asarray, jg), rel=2e-4)


def test_loss_matches_transformers(hf_dir, toy):
    """The reference test's case: one audio and one image, the audio run's
    labels masked."""
    jcfg, _, fm, _ = toy
    from veomni_tpu_torch.models.auto import build_foundation_model

    back = build_foundation_model(hf_dir[1], weights_path=hf_dir[1], device="cpu",
                                  dtype="float32", audio_max_frames=32)
    batch = thinker_batch(jcfg, seed=3)
    one = {k: (v[:1] if k in ("input_ids", "labels", "position_ids", "segment_ids",
                              "audio_features") else v) for k, v in batch.items()}
    one["audio_mask"] = np.asarray([True])
    one["pixel_values"], one["vis_pos_hw"] = batch["pixel_values"][:16], batch["vis_pos_hw"][:16]
    meta = jq25.vision_metadata([(1, 4, 4)], jcfg.vision, 16)
    for key in ("seg_window", "seg_full", "reverse", "merged_mask"):
        one[f"vis_{key}"] = meta[key]
    rng = np.random.default_rng(3)
    px = rng.standard_normal((16, jcfg.vision.patch_dim)).astype(np.float32)
    one["pixel_values"] = px[meta["patch_gather"]]
    ids = one["input_ids"].astype(np.int64)
    labels = ids.copy()
    labels[:, :jcfg.audio.tokens_per_audio + 2] = -100
    with torch.no_grad():
        ref = float(hf_dir[0](
            input_ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
            input_features=torch.from_numpy(one["audio_features"].transpose(0, 2, 1).copy()),
            feature_attention_mask=torch.ones(1, jcfg.audio.max_frames, dtype=torch.bool),
            pixel_values=torch.from_numpy(px), image_grid_thw=torch.tensor([(1, 4, 4)])).loss)
    shifted = np.full_like(labels, -100)
    shifted[:, :-1] = labels[:, 1:]
    one["labels"] = shifted.astype(np.int32)
    with torch.no_grad():
        loss_sum, metrics = back.module.loss_fn(torch_batch(one))
    np.testing.assert_allclose(float(loss_sum) / float(metrics["ntokens"]), ref, rtol=2e-4)


def test_hf_round_trip(hf_dir, toy, tmp_path):
    from veomni_tpu_torch.models import hf_io
    from veomni_tpu_torch.models.auto import build_foundation_model

    jcfg, params, fm, _ = toy
    back = build_foundation_model(hf_dir[1], weights_path=hf_dir[1], device="cpu",
                                  dtype="float32", audio_max_frames=32)
    out = str(tmp_path / "export")
    back.save_hf(out)
    written, on_disk = hf_io.LazyHFTensors(out), hf_io.LazyHFTensors(hf_dir[1])
    # the encoder's audio_bos_eos_token embedding is for generation: neither
    # package reads it
    assert set(on_disk.keys()) - set(written.keys()) == {"audio_tower.audio_bos_eos_token.weight"}
    assert set(written.keys()) <= set(on_disk.keys())
    for name in written.keys():
        assert torch.equal(written.read(name), on_disk.read(name)), name
    again = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32",
                                   audio_max_frames=32)
    assert again.config.audio.max_frames == 32 and again.config.vision.tokens_per_second == 25
    for (name, a), (_, b) in zip(back.module.named_parameters(), again.module.named_parameters()):
        assert torch.equal(a, b), name
    # the reference's own export, read by the port
    jo.save_hf_checkpoint(jax.tree.map(jnp.asarray, params), jcfg, str(tmp_path / "jax"))
    from_jax = build_foundation_model(str(tmp_path / "jax"), weights_path=str(tmp_path / "jax"),
                                      device="cpu", dtype="float32", audio_max_frames=32)
    for (name, a), (_, b) in zip(back.module.named_parameters(),
                                 from_jax.module.named_parameters()):
        assert torch.equal(a, b), name
    with pytest.raises(NotImplementedError, match="thinker"):
        to.load_hf_checkpoint(None, back.module, tensors={"thinker.lm_head.weight":
                                                          torch.zeros(1)})
