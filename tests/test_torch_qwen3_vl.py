"""The port's Qwen3-VL and Qwen3-VL-MoE (``veomni_tpu_torch/models/qwen3_vl.py``)
against the JAX package's, on the CPU, f32, at toy size (LM 3 layers of
width 64, the MoE 4 experts top-2; tower 4 blocks of width 32 at head dim
16, deepstack taps after blocks 0 and 2, a 16-entry position grid), inputs
from numpy seeds.

Tolerances as ``tests/test_torch_qwen2_vl.py``: the index plan (the
bilinear position plan, per-frame segments), mrope position ids and the
collated batch exactly equal; the tower's merged features and its deepstack
taps rtol 1e-5 (atol 1e-5); the loss rtol 1e-5 and each gradient leaf
within 1e-5 of its largest |value|; against transformers 4.57's
``Qwen3VLForConditionalGeneration`` and ``Qwen3VLMoeForConditionalGeneration``
the loss rtol 1e-5, and the HF export (the MoE's fused gate | up experts)
read back bit-equal. Also ``VLMTrainer`` with ``model.lora`` (the text's and
the tower's qkv adapters) against the reference's trainer over 2 steps,
losses rtol 1e-5, and its merged HF export (the adapted leaves merged, the
others the base's, bit for bit).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen3_vl as jq3
from veomni_tpu_torch.models import qwen3_vl as tq3
from test_torch_qwen2_vl import (
    IMG, TEXT, VID, VSTART, assert_tree_close, carried_model, configs, hf_loss_case,
    loss_and_grads, vl_batch,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

VISION = dict(depth=4, hidden_size=32, intermediate_size=48, num_heads=2, patch_size=2,
              spatial_merge_size=2, out_hidden_size=64, num_position_embeddings=16,
              deepstack_visual_indexes=[0, 2])
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
# a still image, a two-frame grid (the plan and positions repeat per frame) and a wide one
GRIDS = [(1, 4, 6), (2, 4, 4), (1, 8, 4)]
FAMILIES = {"qwen3_vl": {}, "qwen3_vl_moe": MOE}


@pytest.fixture(scope="module", params=list(FAMILIES))
def toy(request):
    jcfg, tcfg = configs(request.param, VISION, num_hidden_layers=3, **FAMILIES[request.param])
    params, module = carried_model(jq3, jcfg, tcfg)
    return jcfg, tcfg, params, module


def test_plan_positions_and_collator_match_jax():
    from veomni_tpu.data.multimodal import Qwen3VLCollator as JCollator
    from veomni_tpu_torch.data.multimodal import Qwen3VLCollator

    jcfg, tcfg = configs("qwen3_vl", VISION)
    for grids, npad in ((GRIDS, 128), ([(1, 2, 2)], 8), ([], 16)):
        got = tq3.vision_metadata(grids, tcfg.vision, npad)
        ref = jq3.vision_metadata(grids, jcfg.vision, npad)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert tq3.split_video_grids(GRIDS) == jq3.split_video_grids(GRIDS)
    batch = vl_batch(jq3, jcfg, GRIDS, seed=5)
    got = tq3.mrope_position_ids(batch["input_ids"], GRIDS, tcfg)
    np.testing.assert_array_equal(got, jq3.mrope_position_ids(batch["input_ids"], GRIDS, jcfg))
    rng = np.random.default_rng(6)
    samples = []
    for grid in ([(1, 4, 6)], [(1, 8, 4), (1, 4, 4)]):
        n = sum(t * h * w for t, h, w in grid)
        ids = []
        for t, h, w in grid:
            ids += [VSTART] + [IMG] * (t * h * w // 4)
        ids += list(rng.integers(11, 256, 6))
        samples.append({"input_ids": ids, "labels": ids,
                        "vis_patches": rng.standard_normal((n, tcfg.vision.patch_dim)),
                        "vis_grids": grid})
    for per_row in (False, True):
        got = Qwen3VLCollator(48, 2, tcfg, 160, per_row=per_row)(samples)
        ref = JCollator(48, 2, jcfg, 160, per_row=per_row)(samples)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{per_row} {k}")


def test_tower_and_deepstack_taps_match_jax(toy):
    jcfg, tcfg, params, module = toy
    batch = vl_batch(jq3, jcfg, GRIDS, seed=1)
    names = ("pixel_values", "vis_pos_hw", "vis_pos_interp_idx", "vis_pos_interp_w",
             "vis_seg_full")
    merged, deepstack = jax.jit(lambda p, *a: jq3.vision_forward(
        p, jcfg.vision, *a, dtype=jnp.float32))(params["vision_tower"],
                                                *(jnp.asarray(batch[k]) for k in names))
    t = {k: torch.from_numpy(batch[k]) for k in names}
    with torch.no_grad():
        got, taps = module.vision_tower(
            t["pixel_values"], t["vis_pos_hw"], {"vis_seg_full": t["vis_seg_full"]},
            interp=(t["vis_pos_interp_idx"], t["vis_pos_interp_w"]))
    assert taps.shape == (2,) + tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(merged), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taps.numpy(), np.asarray(deepstack), rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_jax(toy):
    jcfg, tcfg, params, module = toy
    jl, tl, jg, tg = loss_and_grads(jq3, jcfg, params, module, vl_batch(jq3, jcfg, GRIDS, seed=2))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_tree_close(tg, jg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_from_hf_dir_matches_transformers(tmp_path, family):
    import transformers

    from veomni_tpu_torch.models.auto import build_foundation_model

    moe = family == "qwen3_vl_moe"
    prefix = "Qwen3VLMoe" if moe else "Qwen3VL"
    text = {k: TEXT[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                 "num_attention_heads", "num_key_value_heads")}
    text.update(num_hidden_layers=3, head_dim=16, max_position_embeddings=512,
                rope_theta=10000.0, tie_word_embeddings=False,
                rope_scaling={"rope_type": "default", "mrope_section": [2, 3, 3],
                              "mrope_interleaved": True})
    if moe:
        # transformers adds no balance term unless asked for router logits
        text.update(MOE, decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=True,
                    router_aux_loss_coef=0.0)
    vision = {k: v for k, v in VISION.items()}
    vision.update(in_channels=3, temporal_patch_size=2)
    cfg = getattr(transformers, f"{prefix}Config")(
        text_config=text, vision_config=vision, image_token_id=IMG, video_token_id=VID,
        vision_start_token_id=VSTART, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = getattr(transformers, f"{prefix}ForConditionalGeneration")(cfg).eval()
    with torch.no_grad():  # HF zero-initializes the experts; draw them
        for name, p in hf_model.named_parameters():
            if ".experts." in name:
                p.normal_(0.0, 0.02)
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    ref, got, fm, _ = hf_loss_case(hf_model, str(tmp_path / "hf"), tq3, seed=4)
    assert fm.config.model_type == family and fm.config.vision.head_dim == 16
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    fm.save_hf(str(tmp_path / "export"))
    from veomni_tpu_torch.models import hf_io

    names = hf_io.LazyHFTensors(str(tmp_path / "export")).keys()
    assert ("model.language_model.layers.0.mlp.experts.gate_up_proj" in names) == moe
    back = build_foundation_model(str(tmp_path / "export"), weights_path=str(tmp_path / "export"),
                                  device="cpu", dtype="float32")
    pairs = list(zip(fm.module.named_parameters(), back.module.named_parameters()))
    assert len(pairs) == len(list(fm.module.parameters()))
    for (name, a), (name_b, b) in pairs:
        assert name == name_b and torch.equal(a, b), name


def _vlm_args(args, tmp_path):
    """A Qwen3-VL toy run on pretokenized rows with images, ``model.lora``
    on the text's projections and the tower's qkv, 2 steps of 4 rows."""
    rng = np.random.default_rng(0)
    with open(tmp_path / "data.jsonl", "w") as f:
        for i in range(8):
            img = rng.integers(0, 256, (8 + 4 * (i % 2), 8, 3)).tolist()
            ids = rng.integers(11, 256, int(rng.integers(8, 24))).tolist()
            f.write(json.dumps({"input_ids": ids, "images": [img]}) + "\n")
    args.model.config_overrides = {**{k: v for k, v in TEXT.items() if k != "dtype"},
                                   "qk_norm": True,  # Qwen3's, as its HF config reads back
                                   "model_type": "qwen3_vl", "vision": dict(VISION)}
    args.model.lora = {"rank": 4, "alpha": 8, "target_patterns": [
        r"layers\.(q_proj|v_proj|up_proj)$", r"blocks\.qkv_w$"]}
    args.data.train_path = str(tmp_path / "data.jsonl")
    args.data.data_type = "pretokenized"
    args.data.max_seq_len = 64
    args.data.max_patches = 256
    for k, v in {"train_steps": 2, "bf16": False, "lr": 1e-2,
                 "async_save": False, "save_hf_weights": False, "log_steps": 1,
                 "output_dir": str(tmp_path / "out")}.items():
        setattr(args.train, k, v)
    return args


def test_lora_vlm_trainer_matches_jax_trainer(tmp_path):
    from veomni_tpu.arguments import VeOmniArguments as JArgs
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer.vlm_trainer import VLMTrainer as JVLMTrainer
    from veomni_tpu_torch.models.jax_weights import load_jax_adapters, load_jax_params
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import VLMTrainer

    from test_torch_trainer import port_args, record_steps

    (tmp_path / "j").mkdir()
    # the reference on the conftest's 4 virtual devices takes a row a device
    j_args = _vlm_args(JArgs(), tmp_path / "j")
    j_args.train.micro_batch_size = 1
    j_trainer = JVLMTrainer(j_args)
    base = jax.tree.map(np.asarray, j_trainer.base_params)
    lora = jax.tree.map(np.asarray, j_trainer.train_state.params)
    assert any(k.startswith("vision_tower") for k in lora)
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    (tmp_path / "t").mkdir()
    args = _vlm_args(port_args(tmp_path / "t"), tmp_path / "t")
    trainer = VLMTrainer(args)
    load_jax_params(trainer.base_model, base)
    load_jax_adapters(trainer.train_state.model, lora)
    assert "vision_tower.blocks.qkv_w" in trainer.train_state.model.paths
    seen = record_steps(trainer)
    assert trainer.train().global_step == 2
    destroy_parallel_state()
    got, ref = np.array(seen), np.array(j_seen)
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    # the merged export of the composite: W + scale * A @ B where adapted
    from veomni_tpu_torch.lora import save_merged_hf
    from veomni_tpu_torch.models.auto import build_foundation_model

    adapters, base = trainer.train_state.model, trainer.base_model
    save_merged_hf(base, adapters, str(tmp_path / "merged"))
    back = build_foundation_model(str(tmp_path / "merged"), weights_path=str(tmp_path / "merged"),
                                  device="cpu", dtype="float32").module
    with adapters.merged():
        for got_w, owner, name in ((back.vision_tower.blocks[1].qkv_w, base.vision_tower.blocks[1],
                                    "qkv_w"),
                                   (back.language_model.layers[1].q_proj,
                                    base.language_model.layers[1], "q_proj")):
            assert torch.equal(got_w, owner.w(name).detach()), name
    assert torch.equal(back.vision_tower.blocks[1].proj_w, base.vision_tower.blocks[1].proj_w)
