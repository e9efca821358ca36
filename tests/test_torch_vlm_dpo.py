"""The port's VLM-DPO (``veomni_tpu_torch/trainer/dpo_trainer.py``:
``vlm_dpo`` transform, ``VLMDPOPairCollator``, ``VLMDPOTrainer``;
``VisionLanguageModel.sequence_logprob_sums``) against the JAX package's,
on the CPU, f32, on a Qwen2.5-VL toy (LM 2 layers of width 64, the
``bytelevel`` fixture tokenizer's 4096 ids; tower 3 blocks of width 32).

* The transform and the pair collator give the reference's arrays on the
  same preference rows (a prompt with one or two images, text answers).
* ``sequence_logprob_sums`` of the composite: rtol 1e-5.
* The trainers from the same initial weights (the JAX trainer's, carried
  over), full-parameter and with LoRA: two steps' losses rtol 1e-5 and grad
  norms rtol 1e-4; step 1's loss is ln 2 per pair (policy = reference).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import qwen2_5_vl as jq25
from test_torch_qwen2_vl import TEXT, carried_model, configs, torch_batch
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "tests", "fixtures", "tokenizers", "bytelevel")
VISION = dict(depth=3, hidden_size=32, intermediate_size=48, num_heads=2, patch_size=2,
              spatial_merge_size=2, window_size=8, fullatt_block_indexes=[1], out_hidden_size=64)
VOCAB = 4096


def pair_rows(n, seed=0):
    """Preference rows: a user turn with one or two HWC uint8 images and a
    question, chosen and rejected text answers."""
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "a", "mat", "red", "blue", "image", "shows"]
    rows = []
    for i in range(n):
        images = [{"type": "image", "image": rng.integers(0, 256, (8, 8 + 4 * j, 3)).tolist()}
                  for j in range(1 + i % 2)]
        question = " ".join(rng.choice(words, int(rng.integers(3, 8))))
        rows.append({"messages": [{"role": "user",
                                   "content": images + [{"type": "text", "text": question}]}],
                     "chosen": " ".join(rng.choice(words, int(rng.integers(2, 9)))),
                     "rejected": " ".join(rng.choice(words, int(rng.integers(2, 9))))})
    return rows


def vl_config(args, data, out, steps=2, lora=False):
    args.model.config_overrides = {**{k: v for k, v in TEXT.items() if k != "dtype"},
                                   "vocab_size": VOCAB, "model_type": "qwen2_5_vl",
                                   "vision": dict(VISION)}
    args.model.tokenizer_path = TOKENIZER
    if lora:
        args.model.lora = {"rank": 4, "alpha": 8}
    args.data.train_path = str(data)
    args.data.data_type = "dpo"
    args.data.max_seq_len = 64
    args.data.max_patches = 256
    for k, v in {"train_steps": steps, "bf16": False, "lr": 1e-2, "async_save": False,
                 "save_hf_weights": False, "log_steps": 1, "output_dir": str(out)}.items():
        setattr(args.train, k, v)
    return args


def test_transform_collator_and_logprob_sums_match_jax():
    from veomni_tpu.data.data_transform import build_data_transform as j_transform
    from veomni_tpu.trainer.dpo_trainer import VLMDPOPairCollator as JCollator
    from veomni_tpu_torch.data.data_transform import build_data_transform
    from veomni_tpu_torch.data.tokenizer import Tokenizer
    from veomni_tpu_torch.trainer.dpo_trainer import VLMDPOPairCollator

    jcfg, tcfg = configs("qwen2_5_vl", VISION, vocab_size=VOCAB)
    tok = Tokenizer.from_pretrained(TOKENIZER)
    rows = pair_rows(3)
    kw = dict(tokenizer=tok, vlm_config=None, max_seq_len=64, max_patches_per_sample=48)
    samples = [build_data_transform("vlm_dpo", **{**kw, "vlm_config": tcfg})(r) for r in rows]
    j_samples = [j_transform("vlm_dpo", **{**kw, "vlm_config": jcfg})(r) for r in rows]
    for got, ref in zip(samples, j_samples):
        assert got.keys() == ref.keys() and got["vis_grids"] == ref["vis_grids"]
        for k in ("chosen_input_ids", "chosen_labels", "rejected_input_ids", "rejected_labels"):
            assert list(got[k]) == list(ref[k]), k
        for a, b in zip(got["vis_patches"], ref["vis_patches"]):
            np.testing.assert_array_equal(a, b)
    got = VLMDPOPairCollator(64, 2, tcfg, 256)(samples)
    ref = JCollator(64, 2, jcfg, 256)(j_samples)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the composite's per-row log-prob sums on that micro-batch
    params, module = carried_model(jq25, jcfg, tcfg, seed=1)
    want = jax.jit(lambda p, b: jq25.sequence_logprob_sums(p, jcfg, b))(
        params, {k: jnp.asarray(v) for k, v in ref.items()})
    with torch.no_grad():
        sums = module.sequence_logprob_sums(torch_batch(got))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_vlm_dpo_trainer_matches_jax(tmp_path, lora):
    from veomni_tpu.arguments import VeOmniArguments as JArgs
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer.dpo_trainer import VLMDPOTrainer as JVLMDPOTrainer
    from veomni_tpu_torch.arguments import VeOmniArguments
    from veomni_tpu_torch.models.jax_weights import load_jax_adapters, load_jax_params
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import VLMDPOTrainer

    from test_torch_dpo import record_metrics

    data = tmp_path / "pairs.jsonl"
    with open(data, "w") as f:
        for row in pair_rows(8):
            f.write(json.dumps(row) + "\n")
    # the reference on the conftest's 4 virtual devices takes a pair a device
    j_args = vl_config(JArgs(), data, tmp_path / "j", lora=lora)
    j_args.train.micro_batch_size = 1
    j_trainer = JVLMDPOTrainer(j_args)
    init = jax.tree.map(np.asarray, j_trainer.base_params if lora
                        else j_trainer.train_state.params)
    adapters = jax.tree.map(np.asarray, j_trainer.train_state.params) if lora else None
    j_seen = record_metrics(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    args = vl_config(VeOmniArguments(), data, tmp_path / "t", lora=lora)
    args.train.platform, args.train.micro_batch_size, args.train.prefetch_depth = "cpu", 4, 0
    trainer = VLMDPOTrainer(args)
    if lora:
        load_jax_params(trainer.base_model, init)
        load_jax_adapters(trainer.train_state.model, adapters)
    else:
        load_jax_params(trainer.train_state.model, init)
    seen = record_metrics(trainer)
    assert trainer.train().global_step == 2
    trainer.checkpointer.close()
    if lora:
        assert trainer.reference is trainer.base_model
    destroy_parallel_state()
    got, ref = np.array(seen), np.array(j_seen)
    assert got.shape == ref.shape == (2, 2)
    assert got[0, 0] == np.float32(math.log(2))
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-4, err_msg="grad_norm")
