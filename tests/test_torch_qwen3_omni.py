"""The port's Qwen3-Omni-MoE thinker (``veomni_tpu_torch/models/qwen3_omni_moe.py``,
``data/omni_data.py``, ``trainer/omni_trainer.py``) against the JAX package's,
on the CPU, f32, at the reference test's toy size (``tests/test_qwen3_omni_moe.py``:
LM 2 layers of width 64, 4 experts top-2; tower 2 blocks of width 32 with a
deepstack tap after block 0; audio tower 2 layers of width 32 over 32 mel
bins, chunks of 100 frames, ``n_window_infer`` 200 so a window spans two
chunks), inputs from numpy seeds.

Tolerances: the audio plan, the omni position ids and every collated batch
array exactly equal; the audio tower's features rtol 1e-5 (atol 1e-5); the
loss rtol 2e-5 and each gradient leaf within 2e-4 of its largest |value|
(f32 sums in another order); against transformers 4.57's
``Qwen3OmniMoeThinkerForConditionalGeneration`` the audio tower rtol 3e-4
(atol 3e-4, the reference test's) and the HF export read back bit-equal,
with and without the full model's ``thinker.`` prefix; ``OmniTrainer``
against the JAX ``OmniTrainer`` over 3 steps, losses rtol 2e-5. Also the
entry point ``tasks/train_omni_model.py`` on the CPU with its HF export read
back, the FLOPs of the composite counted through its text config as the
reference counts them, and the trainer's gates (seed_omni, janus,
qwen2_5_omni, Ulysses).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen3_omni_moe as jq
from veomni_tpu_torch.models import qwen3_omni_moe as tq
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from test_torch_qwen2_vl import assert_tree_close, carried_model, torch_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

IMG, VID, AUD, VSTART, ASTART = 9, 10, 11, 8, 7
TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_experts=4, num_experts_per_tok=2, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16,
            rope_scaling={"rope_type": "default", "mrope_section": [2, 3, 3]})
VISION = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=2, patch_size=2,
              spatial_merge_size=2, out_hidden_size=64, num_position_embeddings=16,
              deepstack_visual_indexes=[0])
AUDIO = dict(d_model=32, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=64,
             num_mel_bins=32, max_source_positions=200, n_window=50, n_window_infer=200,
             downsample_hidden_size=16, output_dim=64)
IDS = dict(image_token_id=IMG, video_token_id=VID, audio_token_id=AUD,
           vision_start_token_id=VSTART, audio_start_token_id=ASTART)
AUDIO_LENS = [130, 97, 260]  # two chunks, one, three (a window of two and one of one)
GRIDS = [(1, 4, 4), (1, 4, 6)]


def configs():
    from veomni_tpu.models.auto import build_config as j_build_config
    from veomni_tpu_torch.models.auto import build_config

    kw = dict(TEXT, dtype="float32", vision=dict(VISION), audio=dict(AUDIO), **IDS)
    return j_build_config("qwen3_omni_moe", **kw), build_config("qwen3_omni_moe", **kw)


@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = configs()
    params, module = carried_model(jq, jcfg, tcfg)
    return jcfg, tcfg, params, module


def omni_batch(cfg, seed, n_chunk_pad=8, n_frame_pad=64, pad_patches=16):
    """Two rows: row 0 an audio, text, an image and another audio; row 1 an
    image, then an audio, then text (the plans over the micro-batch in
    reading order)."""
    rng = np.random.default_rng(seed)
    aud = [jq.audio_output_lengths(n) for n in AUDIO_LENS]
    nm = [t * (h // 2) * (w // 2) for t, h, w in GRIDS]
    rows = [[ASTART] + [AUD] * aud[0] + list(rng.integers(12, 256, 5)) + [VSTART]
            + [IMG] * nm[0] + list(rng.integers(12, 256, 4)) + [ASTART] + [AUD] * aud[1]
            + list(rng.integers(12, 256, 6)),
            [VSTART] + [IMG] * nm[1] + [ASTART] + [AUD] * aud[2]
            + list(rng.integers(12, 256, 7))]
    s = max(len(r) for r in rows) + 3
    input_ids = np.zeros((2, s), np.int64)
    for i, r in enumerate(rows):
        input_ids[i, :len(r)] = r
    mels = [rng.standard_normal((cfg.audio.num_mel_bins, n)).astype(np.float32)
            for n in AUDIO_LENS]
    n = sum(t * h * w for t, h, w in GRIDS)
    px = np.zeros((n + pad_patches, cfg.vision.patch_dim), np.float32)
    px[:n] = rng.standard_normal((n, cfg.vision.patch_dim))
    vmeta = jq.qwen3_vl.vision_metadata(GRIDS, cfg.vision, n + pad_patches)
    ameta = jq.audio_metadata(AUDIO_LENS, cfg.audio, n_chunk_pad, n_frame_pad)
    labels = np.where((input_ids == IMG) | (input_ids == AUD), -100, input_ids)
    return dict(
        input_ids=input_ids.astype(np.int32),
        labels=np.concatenate([labels[:, 1:], np.full((2, 1), -100)], 1).astype(np.int32),
        position_ids=jq.omni_position_ids(input_ids, cfg, image_grid_thw=GRIDS,
                                          audio_lens=AUDIO_LENS).astype(np.int32),
        segment_ids=(input_ids != 0).astype(np.int32),
        pixel_values=px, vis_pos_hw=vmeta["pos_hw"], vis_pos_interp_idx=vmeta["pos_interp_idx"],
        vis_pos_interp_w=vmeta["pos_interp_w"], vis_seg_full=vmeta["seg_full"],
        vis_merged_mask=vmeta["merged_mask"],
        audio_chunks=jq.pack_audio_chunks(mels, cfg.audio, n_chunk_pad),
        aud_frame_gather=ameta["frame_gather"], aud_seg=ameta["seg"],
        aud_frame_mask=ameta["frame_mask"])


def test_audio_plan_and_positions_match_jax():
    jcfg, tcfg = configs()
    for n in range(1, 420):
        assert tq.audio_output_lengths(n) == jq.audio_output_lengths(n)
    rng = np.random.default_rng(0)
    for lens, chunks, frames in ((AUDIO_LENS, 8, 64), ([100, 1, 199], 4, 40), ([], 2, 16)):
        got = tq.audio_metadata(lens, tcfg.audio, chunks, frames)
        ref = jq.audio_metadata(lens, jcfg.audio, chunks, frames)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        mels = [rng.standard_normal((32, n)).astype(np.float32) for n in lens]
        np.testing.assert_array_equal(tq.pack_audio_chunks(mels, tcfg.audio, chunks),
                                      jq.pack_audio_chunks(mels, jcfg.audio, chunks))
    with pytest.raises(ValueError, match="exceed the static budget"):
        tq.audio_metadata(AUDIO_LENS, tcfg.audio, 5, 64)
    with pytest.raises(ValueError, match="exceed the budget"):
        tq.audio_metadata(AUDIO_LENS, tcfg.audio, 8, 40)
    ids = omni_batch(jcfg, seed=3)["input_ids"].astype(np.int64)
    got = tq.omni_position_ids(ids, tcfg, image_grid_thw=GRIDS, audio_lens=AUDIO_LENS)
    np.testing.assert_array_equal(
        got, jq.omni_position_ids(ids, jcfg, image_grid_thw=GRIDS, audio_lens=AUDIO_LENS))
    # a video grid at 2 seconds a grid: t scaled by position_id_per_seconds
    vid = np.asarray([[5, VID, VID, VID, VID, 6, 7]])
    got = tq.omni_position_ids(vid, tcfg, video_grid_thw=[(2, 2, 4)], second_per_grids=[2.0])
    np.testing.assert_array_equal(got, jq.omni_position_ids(
        vid, jcfg, video_grid_thw=[(2, 2, 4)], second_per_grids=[2.0]))


def test_flops_count_the_text_model():
    """The MFU meter and the census count the composite through its text
    config, as the reference's ``FlopsCounter.from_config`` does."""
    from veomni_tpu.utils.count_flops import FlopsCounter as JFlops
    from veomni_tpu_torch.utils.count_flops import FlopsCounter

    jcfg, tcfg = configs()
    got = FlopsCounter.from_config(tcfg).batch_flops(4096, 2048)
    assert got == FlopsCounter.from_config(tcfg.text).batch_flops(4096, 2048)
    assert got == JFlops.from_config(jcfg).batch_flops(4096, 2048)


def test_audio_tower_matches_jax(toy):
    jcfg, tcfg, params, module = toy
    batch = omni_batch(jcfg, seed=1)
    names = ("audio_chunks", "aud_frame_gather", "aud_seg")
    ref = jax.jit(lambda p, *a: jq.audio_forward(p, jcfg.audio, *a, dtype=jnp.float32))(
        params["audio_tower"], *(jnp.asarray(batch[k]) for k in names))
    with torch.no_grad():
        got = module.audio_tower(*(torch.from_numpy(batch[k]) for k in names))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_jax(toy):
    jcfg, tcfg, params, module = toy
    batch = omni_batch(jcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jq.loss_fn(p, jcfg, b),
                                             has_aux=True))(params, jb)
    module.zero_grad(set_to_none=True)
    tl, metrics = module.loss_fn(torch_batch(batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    tg, jg = to_jax_tree(module, grads=True), jax.tree.map(np.asarray, jg)
    assert set(tg) == {"language_model", "vision_tower", "audio_tower"}
    # the key bias shifts every score of a query alike: its true gradient is
    # 0, and both sides hold f32 noise (~1e-11) there
    for tree in (tg, jg):
        assert np.abs(tree["audio_tower"]["layers"].pop("k_b")).max() < 1e-9
    assert_tree_close(tg, jg, rel=2e-4)
    # freeze_audio: the same loss, no gradient into the audio tower
    module.cfg.freeze_audio = True
    try:
        module.zero_grad(set_to_none=True)
        frozen, _ = module.loss_fn(torch_batch(batch))
        frozen.backward()
        assert float(frozen.detach()) == float(tl.detach())
        assert all(p.grad is None for p in module.audio_tower.parameters())
        assert module.language_model.embed_tokens.grad is not None
    finally:
        module.cfg.freeze_audio = False


def _wav(path, rate, dtype, seconds, rng, channels=1):
    from scipy.io import wavfile

    t = np.arange(int(rate * seconds)) / rate
    x = 0.5 * np.sin(2 * np.pi * (200 + 300 * t) * t) + 0.05 * rng.standard_normal(len(t))
    if channels == 2:
        x = np.stack([x, 0.5 * x], -1)
    if dtype == np.int16:
        x = (x * 32000).astype(np.int16)
    wavfile.write(str(path), rate, x.astype(np.float32) if dtype == np.float32 else x)
    return str(path)


def test_transform_and_collator_match_jax(tmp_path):
    from veomni_tpu.data.omni_data import Qwen3OmniCollator as JCollator
    from veomni_tpu.data.omni_data import build_qwen3_omni_transform as j_transform
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.omni_data import Qwen3OmniCollator

    jcfg, tcfg = configs()
    rng = np.random.default_rng(4)
    wavs = [_wav(tmp_path / "a.wav", 16000, np.int16, 1.3, rng),
            _wav(tmp_path / "b.wav", 44100, np.float32, 0.6, rng, channels=2)]
    rows = [
        {"input_ids": rng.integers(12, 256, 20).tolist() + [AUD],  # a stray placeholder
         "images": [rng.integers(0, 256, (8, 12, 3)).astype(np.uint8)], "audios": [wavs[0]]},
        {"input_ids": rng.integers(12, 256, 9).tolist(),
         "audios": [rng.standard_normal((32, 60)).astype(np.float32), wavs[1]]},
        {"input_ids": rng.integers(12, 256, 30).tolist(),
         "images": [rng.random((8, 8, 3)), rng.random((16, 8, 3))]},
    ]
    for max_seq_len, mel_budget in ((0, 0), (160, 100), (40, 0)):
        kw = dict(max_seq_len=max_seq_len, max_patches_per_sample=64,
                  max_mel_frames_per_sample=mel_budget)
        got = [build_data_transform("qwen3_omni", omni_config=tcfg, **kw)(r) for r in rows]
        ref = [j_transform(omni_config=jcfg, **kw)(r) for r in rows]
        for g, r in zip(got, ref):
            assert g["input_ids"] == r["input_ids"] and g["labels"] == r["labels"]
            assert g["vis_grids"] == r["vis_grids"]
            np.testing.assert_array_equal(g["vis_patches"], r["vis_patches"])
            assert len(g["audio_mels"]) == len(r["audio_mels"])
            for a, b in zip(g["audio_mels"], r["audio_mels"]):
                np.testing.assert_array_equal(a, b)
        s = max_seq_len or 256
        out = Qwen3OmniCollator(tcfg, s, 3, max_patches=192, max_audio_chunks=8)(got)
        want = JCollator(jcfg, s, 3, max_patches=192, max_audio_chunks=8)(ref)
        assert set(out) == set(want)
        for k in want:
            assert out[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="max_audio_chunks"):
        Qwen3OmniCollator(tcfg, 256, 3, max_patches=192, max_audio_chunks=2)(got)


def _hf_thinker(tmp_path):
    from transformers.models.qwen3_omni_moe.configuration_qwen3_omni_moe import (
        Qwen3OmniMoeThinkerConfig,
    )
    from transformers.models.qwen3_omni_moe.modeling_qwen3_omni_moe import (
        Qwen3OmniMoeThinkerForConditionalGeneration,
    )

    text = dict(TEXT, norm_topk_prob=True, router_aux_loss_coef=0.0, output_router_logits=False,
                max_position_embeddings=512, rope_theta=10000.0, tie_word_embeddings=False,
                rope_scaling=dict(TEXT["rope_scaling"], mrope_interleaved=True))
    cfg = Qwen3OmniMoeThinkerConfig(
        text_config=text, vision_config=dict(VISION, in_channels=3, temporal_patch_size=2),
        audio_config=dict(AUDIO, conv_chunksize=500), position_id_per_seconds=13, **IDS)
    torch.manual_seed(0)
    model = Qwen3OmniMoeThinkerForConditionalGeneration(cfg).eval()
    with torch.no_grad():  # draw the biases and the experts HF leaves at 0
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".experts." in name:
                p.normal_(0.0, 0.02)
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    return model, str(tmp_path / "hf")


def test_hf_import_export_round_trip(tmp_path):
    from veomni_tpu_torch.models import hf_io
    from veomni_tpu_torch.models.auto import build_foundation_model

    hf_model, ckpt = _hf_thinker(tmp_path)
    fm = build_foundation_model(ckpt, weights_path=ckpt, device="cpu", dtype="float32")
    assert fm.config.model_type == "qwen3_omni_moe" and fm.config.audio.n_window_infer == 200
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((32, n)).astype(np.float32) for n in AUDIO_LENS]
    with torch.no_grad():
        ref = hf_model.audio_tower(torch.from_numpy(np.concatenate(mels, 1)),
                                   feature_lens=torch.tensor(AUDIO_LENS)).last_hidden_state
        meta = tq.audio_metadata(AUDIO_LENS, fm.config.audio, 8, 64)
        got = fm.module.audio_tower(torch.from_numpy(tq.pack_audio_chunks(
            mels, fm.config.audio, 8)), torch.from_numpy(meta["frame_gather"]),
            torch.from_numpy(meta["seg"]))
    np.testing.assert_allclose(got.numpy()[meta["frame_mask"]], ref.numpy(), rtol=3e-4,
                               atol=3e-4)
    on_disk = hf_io.LazyHFTensors(ckpt)
    for prefix in ("", "thinker."):
        out = str(tmp_path / f"export{prefix}")
        tq.save_hf_checkpoint(fm.module, out, prefix=prefix)
        written = hf_io.LazyHFTensors(out)
        assert sorted(written.keys()) == sorted(prefix + k for k in on_disk.keys())
        for name in on_disk.keys():
            assert torch.equal(written.read(prefix + name), on_disk.read(name)), name
        on_disk = hf_io.LazyHFTensors(ckpt)
        back = build_foundation_model(out, weights_path=out, device="cpu", dtype="float32")
        for (name, a), (_, b) in zip(fm.module.named_parameters(),
                                     back.module.named_parameters()):
            assert torch.equal(a, b), name


def write_rows(path):
    """The rows of ``tests/test_qwen3_omni_moe.py::test_qwen3_omni_trainer_e2e``."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(16):
            row = {"input_ids": rng.integers(12, 256, int(rng.integers(8, 20))).tolist()}
            if i % 2 == 0:  # 8x8 pixels -> a 4x4 patch grid (patch 2)
                row["images"] = [rng.random((8, 8, 3)).tolist()]
            if i % 3 == 0:  # a precomputed mel [n_mels, T]
                row["audios"] = [rng.standard_normal((32, 60)).tolist()]
            f.write(json.dumps(row) + "\n")


def omni_args(args, tmp_path, steps=3):
    write_rows(tmp_path / "data.jsonl")
    args.model.config_overrides = {"model_type": "qwen3_omni_moe", **TEXT, "vision": dict(VISION),
                                   "audio": dict(AUDIO, max_source_positions=64), **IDS}
    args.data.train_path = str(tmp_path / "data.jsonl")
    args.data.data_type = "pretokenized"
    args.data.max_seq_len = 64
    args.data.max_patches = 256
    args.data.max_audio_chunks = 8
    for k, v in {"train_steps": steps, "bf16": False, "async_save": False, "lr": 1e-3,
                 "save_hf_weights": False, "log_steps": 1,
                 "output_dir": str(tmp_path / "out")}.items():
        setattr(args.train, k, v)
    return args


def test_omni_trainer_matches_jax_trainer(tmp_path):
    from veomni_tpu.arguments import VeOmniArguments as JArgs
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer import OmniTrainer as JOmniTrainer
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import OmniTrainer

    from test_torch_trainer import port_args, record_steps

    (tmp_path / "j").mkdir()
    # the reference on the conftest's 4 virtual devices takes a row a device
    j_args = omni_args(JArgs(), tmp_path / "j")
    j_args.train.micro_batch_size = 1
    j_trainer = JOmniTrainer(j_args)
    params = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    (tmp_path / "t").mkdir()
    trainer = OmniTrainer(omni_args(port_args(tmp_path / "t"), tmp_path / "t"))
    load_jax_params(trainer.train_state.model, params)
    seen = record_steps(trainer)
    assert trainer.train().global_step == 3
    destroy_parallel_state()
    got, ref = np.array(seen), np.array(j_seen)
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=2e-5, err_msg="loss")


def test_train_omni_model_entry_point(tmp_path):
    """``python -m veomni_tpu_torch.tasks.train_omni_model cfg.yaml
    --train.platform=cpu``: a step, its checkpoint and the HF export, which
    the registry reads back."""
    from veomni_tpu_torch.models.auto import build_foundation_model
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.tasks import train_omni_model

    write_rows(tmp_path / "data.jsonl")
    # qk_norm: Qwen3's, as its HF config reads back
    cfg = {"model": {"config_overrides": {"model_type": "qwen3_omni_moe", **TEXT, "qk_norm": True,
                                          "vision": VISION, "audio": AUDIO, **IDS}},
           "data": {"train_path": str(tmp_path / "data.jsonl"), "data_type": "pretokenized",
                    "max_seq_len": 64, "max_patches": 128, "max_audio_chunks": 4},
           "train": {"output_dir": str(tmp_path / "out"), "micro_batch_size": 2,
                     "train_steps": 1, "bf16": False, "async_save": False,
                     "save_hf_weights": True, "log_steps": 1, "prefetch_depth": 0}}
    (tmp_path / "run.yaml").write_text(json.dumps(cfg))  # JSON is YAML
    try:
        trainer = train_omni_model.main([str(tmp_path / "run.yaml"), "--train.platform=cpu"])
    finally:
        destroy_parallel_state()
    assert trainer.model.config.model_type == "qwen3_omni_moe"
    assert (tmp_path / "out" / "checkpoints" / "global_step_1").exists()
    hf_dir = str(tmp_path / "out" / "hf_ckpt")
    back = build_foundation_model(hf_dir, weights_path=hf_dir, device="cpu", dtype="float32")
    for (name, a), (_, b) in zip(trainer.train_state.model.named_parameters(),
                                 back.module.named_parameters()):
        assert torch.equal(a.detach(), b), name


@pytest.mark.parametrize("case,item", [
    ("seed_omni", "the slot VLM with seed_omni"),
    ("janus", "DiT and the generators with Janus"),
    ("qwen2_5_omni", "the slot VLM with seed_omni"),
    ("ulysses", "Ulysses and context parallelism on the omni trainer"),
])
def test_omni_trainer_gates_name_their_roadmap_items(tmp_path, case, item):
    from veomni_tpu_torch.trainer import OmniTrainer

    from test_torch_trainer import port_args

    args = omni_args(port_args(tmp_path), tmp_path)
    if case == "seed_omni":
        args.model.config_overrides = {"text": TEXT, "max_images": 1}
    elif case in ("janus", "qwen2_5_omni"):
        args.model.config_overrides = {"model_type": case}
    else:
        args.train.ulysses_parallel_size = 2
    with pytest.raises(NotImplementedError, match=item):
        OmniTrainer(args)
