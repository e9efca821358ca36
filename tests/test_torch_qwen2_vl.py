"""The port's Qwen2-VL (``veomni_tpu_torch/models/qwen2_vl.py``) against
the JAX package's, on the CPU, f32, at toy size (LM 2 layers of width 64,
tower 2 blocks of width 32 at head dim 16), inputs from numpy seeds.

Tolerances: index plans, mrope position ids and collated batches exactly
equal; mrope tables rtol 1e-6; the tower and merger rtol 1e-5 (atol 1e-5);
the whole-model loss rtol 1e-5 and every gradient leaf within 1e-5 of its
largest |value| (f32 sums in another order); against transformers 4.57's
``Qwen2VLForConditionalGeneration`` the loss rtol 1e-5. Also: the HF
directory round trip bit-equal, ``freeze_vision`` (zero tower gradients,
AdamW still decays the tower), one ``VLMTrainer`` step through
``tasks/train_vlm.py --train.platform=cpu``, and the reference's shipped
``configs/multimodal/qwen2_vl_toy.yaml``, which builds no config in either
package (the same ``TypeError``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen2_vl as jq2
from veomni_tpu.models.auto import build_config as j_build_config
from veomni_tpu_torch.models import qwen2_vl as tq2
from veomni_tpu_torch.models.auto import FoundationModel, build_config, build_foundation_model
from veomni_tpu_torch.models.jax_weights import load_jax_params, to_jax_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, VID, VSTART = 9, 10, 8
TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
            image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART,
            dtype="float32")
VISION = dict(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2, patch_size=2,
              spatial_merge_size=2)
GRIDS = [(1, 4, 6), (2, 4, 4), (1, 8, 4)]


def configs(mt, vision, **extra):
    kw = {**TEXT, **extra}
    return (j_build_config(mt, vision=dict(vision), **kw),
            build_config(mt, vision=dict(vision), **kw))


def carried_model(jm, jcfg, tcfg, seed=0):
    """(JAX params, the port's model with the same weights)."""
    params = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    module = FoundationModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(module, jax.tree.map(np.asarray, params))
    return params, module


def vl_batch(jm, jcfg, grids, seed, n_pad_extra=16):
    """One packed batch of two rows (the family's plan, mrope positions,
    labels shifted) from a numpy seed."""
    rng = np.random.default_rng(seed)
    m = jcfg.vision.spatial_merge_size
    rows, half = [], (len(grids) + 1) // 2
    for part in (grids[:half], grids[half:]):
        ids = []
        for t, h, w in part:
            ids += [VSTART] + [IMG] * (t * (h // m) * (w // m)) + list(rng.integers(11, 256, 5))
        rows.append(ids)
    s = max(len(r) for r in rows) + 3
    input_ids = np.zeros((2, s), np.int64)
    for i, r in enumerate(rows):
        input_ids[i, :len(r)] = r
    n = sum(t * h * w for t, h, w in grids)
    npad = n + n_pad_extra
    px = np.zeros((npad, jcfg.vision.patch_dim), np.float32)
    px[:n] = rng.standard_normal((n, jcfg.vision.patch_dim))
    meta = jm.vision_metadata(grids, jcfg.vision, npad)
    labels = np.where(input_ids == IMG, -100, input_ids)
    batch = dict(
        input_ids=input_ids.astype(np.int32),
        labels=np.concatenate([labels[:, 1:], np.full((2, 1), -100)], 1).astype(np.int32),
        position_ids=jm.mrope_position_ids(input_ids, grids, jcfg).astype(np.int32),
        segment_ids=(input_ids != 0).astype(np.int32),
        pixel_values=px[meta["patch_gather"]] if "patch_gather" in meta else px,
        vis_pos_hw=meta["pos_hw"], vis_merged_mask=meta["merged_mask"])
    for key in ("seg", "seg_window", "seg_full", "reverse", "pos_interp_idx", "pos_interp_w"):
        if key in meta:
            batch[f"vis_{key}"] = meta[key]
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def assert_tree_close(got, ref, rel=1e-5, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
        for k in ref:
            assert_tree_close(got[k], ref[k], rel, f"{path}.{k}")
        return
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=path)


def loss_and_grads(jm, jcfg, params, module, batch):
    # one compiled program: faster on the CPU than the op-by-op trace
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, jcfg, b),
                                             has_aux=True))(params, jb)
    module.zero_grad(set_to_none=True)
    tl, _ = module.loss_fn(torch_batch(batch))
    tl.backward()
    return float(jl), float(tl.detach()), jax.tree.map(np.asarray, jg), to_jax_tree(module,
                                                                                   grads=True)


@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = configs("qwen2_vl", VISION)
    params, module = carried_model(jq2, jcfg, tcfg)
    return jcfg, tcfg, params, module


def test_vision_metadata_matches_jax(toy):
    jcfg, tcfg, _, _ = toy
    for grids, npad in ((GRIDS, 128), ([(1, 2, 2)], 8), ([], 16)):
        got = tq2.vision_metadata(grids, tcfg.vision, npad)
        ref = jq2.vision_metadata(grids, jcfg.vision, npad)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="exceed the static budget"):
        tq2.vision_metadata(GRIDS, tcfg.vision, 64)


@pytest.mark.parametrize("layout", ["text-only", "images", "cut"])
def test_mrope_positions_and_tables_match_jax(toy, layout):
    from veomni_tpu.ops.rotary import rotary_tables as j_tables
    from veomni_tpu_torch.ops.rotary import rotary_tables

    jcfg, tcfg, _, _ = toy
    rng = np.random.default_rng(3)
    if layout == "text-only":
        ids, grids = rng.integers(11, 256, (2, 20)), []
    else:
        row = []
        for t, h, w in GRIDS:
            row += [VSTART] + [IMG] * (t * (h // 2) * (w // 2)) + list(rng.integers(11, 256, 4))
        grids = GRIDS
        if layout == "cut":  # a row cut inside its last image, synced as the collators do
            from veomni_tpu.data.multimodal import Qwen2VLCollator as JCollator
            from veomni_tpu_torch.data.multimodal import Qwen2VLCollator

            cut = np.asarray(row[:30], np.int32)
            synced = [c(30, 1, cfg, 64)._sync_grids(cut, cut.copy(), GRIDS)
                      for c, cfg in ((JCollator, jcfg), (Qwen2VLCollator, tcfg))]
            np.testing.assert_array_equal(synced[0][0], synced[1][0])
            assert synced[0][2:] == synced[1][2:] == (GRIDS[:2], 24 + 32)
            row, grids = list(synced[1][0]), synced[1][2]
        ids = np.asarray([row])
    got = tq2.mrope_position_ids(ids, grids, tcfg)
    ref = jq2.mrope_position_ids(ids, grids, jcfg)
    np.testing.assert_array_equal(got, ref)
    pos = got.astype(np.int32)
    rs = tcfg.text.rope_scaling
    cos_t, sin_t = rotary_tables(torch.from_numpy(pos), 16, 1e4, rope_scaling=rs)
    cos_j, sin_j = j_tables(jnp.asarray(pos), 16, 1e4, rope_scaling=rs)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("section", [[2, 3, 3], [4, 2, 2]])
def test_mrope_interleaved_tables_match_jax(section):
    """The qwen3-vl layout (frequency j of stream j % 3 while that stream's
    section lasts), the same function as the sectioned one."""
    from veomni_tpu.ops.rotary import rotary_tables as j_tables
    from veomni_tpu_torch.ops.rotary import rotary_tables

    rng = np.random.default_rng(7)
    pos = rng.integers(0, 300, (2, 3, 24)).astype(np.int32)
    rs = {"rope_type": "default", "mrope_section": section, "mrope_interleaved": True}
    got = rotary_tables(torch.from_numpy(pos), 16, 1e4, rope_scaling=rs)
    want = j_tables(jnp.asarray(pos), 16, 1e4, rope_scaling=rs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_tower_and_merger_match_jax(toy):
    jcfg, tcfg, params, module = toy
    batch = vl_batch(jq2, jcfg, GRIDS, seed=1)
    ref = jax.jit(lambda p, *a: jq2.vision_forward(p, jcfg.vision, *a, dtype=jnp.float32))(
        params["vision_tower"], jnp.asarray(batch["pixel_values"]),
        jnp.asarray(batch["vis_pos_hw"]), jnp.asarray(batch["vis_seg"]))
    with torch.no_grad():
        got = module.vision_tower(torch.from_numpy(batch["pixel_values"]),
                                  torch.from_numpy(batch["vis_pos_hw"]),
                                  {"vis_seg": torch.from_numpy(batch["vis_seg"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_merge_vision_features_matches_jax():
    from veomni_tpu.models.qwen2_5_vl import merge_vision_features as j_merge
    from veomni_tpu_torch.models.qwen2_5_vl import merge_vision_features

    rng = np.random.default_rng(4)
    ids = rng.integers(11, 256, (2, 12))
    ids[0, 2:6] = IMG
    ids[1, 0:3] = VID
    ids[1, 8:12] = IMG  # more placeholders than features: the tail keeps its embedding
    embeds = rng.standard_normal((2, 12, 8)).astype(np.float32)
    feats = rng.standard_normal((8, 8)).astype(np.float32)
    mask = np.array([True] * 7 + [False])
    got = merge_vision_features(torch.from_numpy(embeds), torch.from_numpy(ids),
                                torch.from_numpy(feats), torch.from_numpy(mask), IMG, VID)
    ref = j_merge(jnp.asarray(embeds), jnp.asarray(ids), jnp.asarray(feats), jnp.asarray(mask),
                  IMG, VID)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_loss_and_grads_match_jax(toy):
    jcfg, tcfg, params, module = toy
    jl, tl, jg, tg = loss_and_grads(jq2, jcfg, params, module, vl_batch(jq2, jcfg, GRIDS, 2))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_tree_close(tg, jg)


def test_freeze_vision_zeroes_tower_grads_and_adamw_decays_it():
    from veomni_tpu_torch.optim import build_optimizer

    jcfg, tcfg = configs("qwen2_vl", VISION, freeze_vision=True)
    params, module = carried_model(jq2, jcfg, tcfg, seed=5)
    jl, tl, jg, tg = loss_and_grads(jq2, jcfg, params, module, vl_batch(jq2, jcfg, GRIDS, 6))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_tree_close(tg, jg)
    assert all(p.grad is None for p in module.vision_tower.parameters())
    assert all(not np.any(v) for v in jax.tree.leaves(jg["vision_tower"]))
    # the train step gives a gradient-less parameter a zero gradient; AdamW
    # then shrinks it by lr * weight_decay, as optax does behind stop_gradient
    for p in module.vision_tower.parameters():
        p.grad = torch.zeros_like(p)
    opt = build_optimizer(module, lr=lambda n: 1e-2, weight_decay=0.1)
    before = module.vision_tower.blocks[0].fc1_w.detach().clone()
    opt.step()
    np.testing.assert_allclose(module.vision_tower.blocks[0].fc1_w.detach().numpy(),
                               (before * (1 - 1e-2 * 0.1)).numpy(), rtol=1e-6)


def _tiny_hf(tmp_path):
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    text = {k: TEXT[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                 "num_hidden_layers", "num_attention_heads",
                                 "num_key_value_heads", "rope_scaling")}
    cfg = Qwen2VLConfig(
        text_config=dict(text, max_position_embeddings=512, rope_theta=10000.0,
                         tie_word_embeddings=False),
        vision_config=dict(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2,
                           in_channels=3, patch_size=2, temporal_patch_size=2,
                           spatial_merge_size=2),
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART)
    torch.manual_seed(0)
    model = Qwen2VLForConditionalGeneration(cfg).eval()
    out = tmp_path / "hf"
    model.save_pretrained(out, safe_serialization=True)
    return model, str(out)


def hf_loss_case(hf_model, ckpt, family, seed):
    """(transformers' loss, the port's loss from the HF directory, the port's
    model, its batch) on one row with a still image and a grid of two
    frames."""
    fm = build_foundation_model(ckpt, weights_path=ckpt, device="cpu", dtype="float32")
    grids = [(1, 4, 6), (2, 4, 4)]
    rng = np.random.default_rng(seed)
    nm = [t * (h // 2) * (w // 2) for t, h, w in grids]
    ids = [VSTART] + [IMG] * nm[0] + list(rng.integers(11, 256, 5))
    ids += [VSTART] + [IMG] * nm[1] + list(rng.integers(11, 256, 6))
    input_ids = np.asarray([ids], np.int64)
    labels = input_ids.copy()
    labels[:, :nm[0] + 1] = -100
    n = sum(t * h * w for t, h, w in grids)
    pixel_values = rng.standard_normal((n, fm.config.vision.patch_dim)).astype(np.float32)
    with torch.no_grad():
        ref = float(hf_model(input_ids=torch.from_numpy(input_ids),
                             labels=torch.from_numpy(labels),
                             pixel_values=torch.from_numpy(pixel_values),
                             image_grid_thw=torch.tensor(grids)).loss)
    meta = family.vision_metadata(grids, fm.config.vision, n)
    shifted = np.full_like(labels, -100)
    shifted[:, :-1] = labels[:, 1:]
    batch = dict(input_ids=input_ids.astype(np.int32), labels=shifted.astype(np.int32),
                 position_ids=family.mrope_position_ids(input_ids, grids,
                                                        fm.config).astype(np.int32),
                 segment_ids=np.ones_like(input_ids, np.int32),
                 pixel_values=pixel_values[meta["patch_gather"]] if "patch_gather" in meta
                 else pixel_values, vis_pos_hw=meta["pos_hw"],
                 vis_merged_mask=meta["merged_mask"])
    for key in ("seg", "seg_window", "seg_full", "reverse", "pos_interp_idx", "pos_interp_w"):
        if key in meta:
            batch[f"vis_{key}"] = meta[key]
    with torch.no_grad():
        loss_sum, metrics = fm.module.loss_fn(torch_batch(batch))
    return ref, float(loss_sum) / float(metrics["ntokens"]), fm, batch


def test_loss_from_hf_dir_matches_transformers(tmp_path):
    hf_model, ckpt = _tiny_hf(tmp_path)
    ref, got, fm, batch = hf_loss_case(hf_model, ckpt, tq2, seed=2)
    assert fm.config.model_type == "qwen2_vl" and fm.config.vision.embed_dim == 32
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the export reads back bit-equal
    fm.save_hf(str(tmp_path / "export"))
    back = build_foundation_model(str(tmp_path / "export"), weights_path=str(tmp_path / "export"),
                                  device="cpu", dtype="float32")
    pairs = list(zip(fm.module.named_parameters(), back.module.named_parameters()))
    assert len(pairs) == len(list(fm.module.parameters()))
    for (name, a), (name_b, b) in pairs:
        assert name == name_b and torch.equal(a, b), name


def test_hf_reader_takes_the_older_key_names(toy, tmp_path):
    """Checkpoints before transformers 4.52 name the text ``model.*`` and
    the tower ``visual.*``; both layouts load into the same parameters."""
    from veomni_tpu_torch.models import hf_io

    _, tcfg, _, module = toy
    tq2.save_hf_checkpoint(module, str(tmp_path / "new"))
    tensors = {}
    for name in os.listdir(tmp_path / "new"):
        if name.endswith(".safetensors"):
            tensors.update(hf_io.load_file(str(tmp_path / "new" / name)))
    assert any(k.startswith("model.language_model.") for k in tensors)
    old = {k.replace("model.language_model.", "model.").replace("model.visual.", "visual."): v
           for k, v in tensors.items()}
    os.makedirs(tmp_path / "old")
    hf_io.save_file(old, str(tmp_path / "old" / "model.safetensors"))
    for layout in ("new", "old"):
        back = FoundationModel(tcfg).load_hf(str(tmp_path / layout), device="cpu")
        for (name, a), (_, b) in zip(module.named_parameters(), back.named_parameters()):
            assert torch.equal(a, b), (layout, name)


def write_vlm_run(tmp_path, model_type, vision, steps=1):
    """A pretokenized corpus with HWC uint8 images and the YAML of a CPU run."""
    rng = np.random.default_rng(0)
    with open(tmp_path / "data.jsonl", "w") as f:
        for i in range(8):
            img = rng.integers(0, 256, (8 + 4 * (i % 2), 8, 3)).tolist()
            ids = rng.integers(11, 256, int(rng.integers(8, 24))).tolist()
            f.write(json.dumps({"input_ids": ids, "images": [img]}) + "\n")
    overrides = {**{k: v for k, v in TEXT.items() if k != "dtype"}, "model_type": model_type,
                 "vision": vision}
    cfg = {"model": {"config_overrides": overrides},
           "data": {"train_path": str(tmp_path / "data.jsonl"), "data_type": "pretokenized",
                    "max_seq_len": 64, "max_patches": 256},
           "train": {"output_dir": str(tmp_path / "out"), "micro_batch_size": 2,
                     "train_steps": steps, "bf16": False, "async_save": False,
                     "save_hf_weights": False, "log_steps": 1, "prefetch_depth": 0}}
    path = tmp_path / "run.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return str(path)


def test_vlm_trainer_step_through_train_vlm(tmp_path):
    from veomni_tpu_torch.tasks import train_vlm

    trainer = train_vlm.main([write_vlm_run(tmp_path, "qwen2_vl", VISION),
                              "--train.platform=cpu"])
    assert trainer.model.config.model_type == "qwen2_vl"
    with open(tmp_path / "out" / "metrics_rank0.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines and np.isfinite(lines[0]["loss"]) and lines[0]["loss"] > 0


def test_shipped_toy_yaml_builds_no_config_in_either_package():
    """``configs/multimodal/qwen2_vl_toy.yaml`` passes ViT fields
    (``image_size``) to the Qwen2-VL vision config: both packages raise the
    same TypeError (a later fix of either package shows here)."""
    import yaml

    with open(os.path.join(REPO, "configs", "multimodal", "qwen2_vl_toy.yaml")) as f:
        model = yaml.safe_load(f)["model"]
    overrides = dict(model["config_overrides"])
    model_type = overrides.pop("model_type", model.get("model_type", ""))
    errors = []
    for build in (j_build_config, build_config):
        with pytest.raises(TypeError, match="unexpected keyword argument 'image_size'") as e:
            build(model_type, **overrides)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
