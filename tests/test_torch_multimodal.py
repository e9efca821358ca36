"""The port's qwen-vl data path (``veomni_tpu_torch/data/{multimodal,media,
chat_template}.py``) and the VLM pieces around the trainer against the JAX
package's, on the CPU, numpy only (no model runs here).

Exact equality throughout: image patches and grids, the ``qwen2_vl`` /
``qwen2_5_vl`` row transforms, the ``qwen2_5_vl_conversation`` transform
through the repo's fixture tokenizers (transformers' reader on the JAX
side, the port's ``data/tokenizer.py`` on its own), both collators' batches
key by key (rows cut inside an image at ``max_seq_len``, an empty row, a
micro-batch over budget), ``smart_resize``, the tower's FLOPs term
(``vit_flops_fwd``) and the MFU meter's tower term, and the weight-decay
mask of the composite's tree.
"""

import os

import numpy as np
import pytest
import torch

from veomni_tpu.data import multimodal as jmm
from veomni_tpu.data.data_transform import build_data_transform as j_build_data_transform
from veomni_tpu.models.auto import build_config as j_build_config
from veomni_tpu_torch.data import multimodal as tmm
from veomni_tpu_torch.data.data_transform import build_data_transform
from veomni_tpu_torch.models.auto import build_config
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "tokenizers")
TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2,
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
            image_token_id=9, video_token_id=10, vision_start_token_id=8)
VISION = {
    "qwen2_vl": dict(depth=1, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2,
                     patch_size=2, spatial_merge_size=2),
    "qwen2_5_vl": dict(depth=2, hidden_size=32, intermediate_size=48, num_heads=2, patch_size=2,
                       spatial_merge_size=2, window_size=8, fullatt_block_indexes=[1],
                       out_hidden_size=64),
}
FAMILIES = ("qwen2_vl", "qwen2_5_vl")
COLLATORS = {"qwen2_vl": ("Qwen2VLCollator",), "qwen2_5_vl": ("Qwen25VLCollator",)}


def configs(mt, **text):
    kw = {**TEXT, **text}
    return (j_build_config(mt, vision=dict(VISION[mt]), **kw),
            build_config(mt, vision=dict(VISION[mt]), **kw))


def rows(seed=0, n=6):
    """Pretokenized rows with HWC uint8 images of several sizes, one row with
    none and one with a stray placeholder id in its text."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        images = [rng.integers(0, 256, (4 + 4 * ((i + j) % 3), 8 + 2 * j, 3), dtype=np.uint8)
                  for j in range(i % 3)]
        ids = rng.integers(11, 256, int(rng.integers(6, 20))).tolist()
        if i == 4:
            ids[2] = TEXT["image_token_id"]
        out.append({"input_ids": ids, "images": images})
    return out


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert list(got[k]) == list(want[k]), k


def test_image_patches_match_jax():
    _, tcfg = configs("qwen2_vl")
    rng = np.random.default_rng(1)
    for shape in ((8, 8, 3), (12, 6, 3), (5, 9, 3)):
        img = rng.random(shape).astype(np.float32)
        got = tmm.image_to_qwen_patches(img, tcfg.vision)
        want = jmm.image_to_qwen_patches(img, tcfg.vision)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    frames = rng.random((4, 8, 12, 3)).astype(np.float32)
    got, want = (m.frames_to_qwen_patches(frames, tcfg.vision) for m in (tmm, jmm))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == (2, 4, 6)
    arr = rng.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tmm.load_image(arr, 4), jmm.load_image(arr, 4))


@pytest.mark.parametrize("family", FAMILIES)
def test_row_transform_matches_jax(family):
    jcfg, tcfg = configs(family)
    for max_seq_len, budget in ((0, 0), (24, 64), (64, 40)):
        got = build_data_transform(family, vlm_config=tcfg, max_seq_len=max_seq_len,
                                   max_patches_per_sample=budget)
        want = j_build_data_transform(family, vlm_config=jcfg, max_seq_len=max_seq_len,
                                      max_patches_per_sample=budget)
        for row in rows():
            assert_same_sample(got(row), want(row))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seq_len", [64, 20], ids=["whole", "cut"])
def test_collator_batches_match_jax(family, seq_len):
    """Batches key by key; at seq_len 20 rows are cut inside an image run,
    which the collators cut whole with its grid and patches."""
    jcfg, tcfg = configs(family)
    name = COLLATORS[family][0]
    samples = [j_build_data_transform(family, vlm_config=jcfg)(r) for r in rows(2)]
    for mb in (2, 3):
        for start in range(0, len(samples) - mb + 1, mb):
            part = samples[start:start + mb]
            got = getattr(tmm, name)(seq_len, mb, tcfg, 128)(part)
            want = getattr(jmm, name)(seq_len, mb, jcfg, 128)(part)
            assert_same_sample(got, want)
    with pytest.raises(ValueError, match="exceeds max_patches"):
        getattr(tmm, name)(64, 3, tcfg, 32)(samples[3:6])
    with pytest.raises(NotImplementedError, match="slice C"):
        getattr(tmm, name)(64, 2, tcfg, 128, per_row=True)


@pytest.fixture(scope="module")
def bytelevel():
    from transformers import PreTrainedTokenizerFast

    from veomni_tpu_torch.models.auto import build_tokenizer

    path = os.path.join(FIXTURES, "bytelevel")
    return PreTrainedTokenizerFast.from_pretrained(path), build_tokenizer(path)


def test_conversation_transform_matches_jax(bytelevel):
    hf, port = bytelevel
    jcfg, tcfg = configs("qwen2_5_vl")
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((8, 8, 3), (12, 16, 3), (6, 10, 3))]
    conv = {"messages": [
        {"role": "system", "content": "Describe what you see."},
        {"role": "user", "content": [{"type": "image", "image": images[0]},
                                     {"type": "text", "text": "What is in this picture?"}]},
        {"role": "assistant", "content": "A grid of coloured squares."},
        {"role": "user", "content": [{"type": "text", "text": "And these two?"},
                                     {"type": "image", "image": images[1]},
                                     {"type": "image", "image": images[2]}]},
        {"role": "assistant", "content": [{"type": "text", "text": "Two more grids."}]},
    ]}
    for max_seq_len in (0, 40, 60):
        got = build_data_transform("qwen2_5_vl_conversation", tokenizer=port, vlm_config=tcfg,
                                   max_seq_len=max_seq_len)(conv)
        want = j_build_data_transform("qwen2_5_vl_conversation", tokenizer=hf, vlm_config=jcfg,
                                      max_seq_len=max_seq_len)(conv)
        assert_same_sample(got, want)
        assert -100 in got["labels"]
    with pytest.raises(NotImplementedError, match="slice F"):
        build_data_transform("qwen2_5_vl_conversation", tokenizer=port, vlm_config=tcfg)(
            {"messages": [{"role": "user", "content": [{"type": "video", "video": "v.mp4"}]}]})


def test_chat_template_patch_budget_matches_jax(bytelevel):
    from veomni_tpu.data.chat_template import qwen_vl_chat_template as j_template
    from veomni_tpu_torch.data.chat_template import qwen_vl_chat_template

    hf, port = bytelevel
    jcfg, tcfg = configs("qwen2_vl")
    img = np.random.default_rng(4).integers(0, 256, (24, 20, 3), dtype=np.uint8)
    msgs = [{"role": "user", "content": [{"type": "image", "image": img}]}]
    for budget in (0, 16, 40):
        got = qwen_vl_chat_template(port, tcfg, max_patches_per_sample=budget)
        want = j_template(hf, jcfg, max_patches_per_sample=budget)
        for kw in ({}, {"patch_budget": 8}):
            g, w = got.encode_messages(msgs, **kw), want.encode_messages(msgs, **kw)
            assert g["input_ids"] == w["input_ids"] and g["vis_grids"] == w["vis_grids"]
            np.testing.assert_array_equal(g["vis_patches"][0], w["vis_patches"][0])


def test_smart_resize_matches_jax():
    from veomni_tpu.data.media import smart_resize as j_smart_resize
    from veomni_tpu_torch.data.media import smart_resize

    for hw in ((10, 10), (224, 224), (448, 1344), (4000, 3000), (30, 900), (57, 29)):
        for kw in ({}, {"factor": 14, "min_pixels": 1024, "max_pixels": 200_000}):
            assert smart_resize(*hw, **kw) == j_smart_resize(*hw, **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_tower_flops_match_jax(family):
    """``vit_flops_fwd`` and the MFU meter's tower term (windows of
    ``window_size`` pixels for Qwen2.5-VL) against the reference's."""
    from types import SimpleNamespace

    from veomni_tpu.trainer.callbacks import EnvironMeterCallback as JCallback
    from veomni_tpu.utils.count_flops import vit_flops_fwd as j_vit_flops_fwd
    from veomni_tpu_torch.trainer.callbacks import EnvironMeterCallback
    from veomni_tpu_torch.utils.count_flops import vit_flops_fwd

    jcfg, tcfg = configs(family)
    for n, window in ((256, None), (1000, 16)):
        assert vit_flops_fwd(tcfg.vision, n, window) == j_vit_flops_fwd(jcfg.vision, n, window)
    samples = [j_build_data_transform(family, vlm_config=jcfg)(r) for r in rows(5)]
    batch = getattr(jmm, COLLATORS[family][0])(64, 6, jcfg, 256)(samples)
    got = EnvironMeterCallback._tower_flops(SimpleNamespace(model=SimpleNamespace(config=tcfg)),
                                            batch)
    want = JCallback._tower_flops(SimpleNamespace(model=SimpleNamespace(config=jcfg)), batch)
    assert got == want > 0


def test_decay_mask_of_the_composite_tree():
    """AdamW decays what ``ndim > 1`` picks on the reference's tree: every
    stacked leaf (the LM's layers, the tower's blocks) and every matrix,
    not the LM's final norm nor the merger's 1-D leaves."""
    from veomni_tpu_torch.models.auto import FoundationModel
    from veomni_tpu_torch.optim.optimizer import _decayed

    for family in FAMILIES:
        _, tcfg = configs(family)
        module = FoundationModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
        skipped = sorted(n for n, p in module.named_parameters() if not _decayed(n, p))
        merger_1d = sorted(f"vision_tower.merger.{n}"
                           for n, p in module.vision_tower.merger.named_parameters()
                           if p.ndim == 1)
        assert skipped == sorted(["language_model.norm", *merger_1d]), skipped
