"""The port's trainer on the SFT path: conversation data through the port's
tokenizer, LoRA, and the optimizer's parameter groups, on the CPU.

* Parity: the port's ``TextTrainer`` and the JAX one on the same arguments
  (the e2e toy at vocab 4096, ``data_type: conversation`` rendered by the
  ``bytelevel`` fixture tokenizer's jinja template, ``model.lora`` rank 4,
  ``freeze_modules`` on the v_proj adapters, ``module_lr_scales`` 0.1 on
  the q_proj ones) for 2 steps from the same base weights and adapters
  (the JAX trainer's, carried over): every step's loss and grad_norm
  within rtol 1e-5. The JAX trainer reads the tokenizer with
  ``transformers``, the port with ``data/tokenizer.py``.
* LoRA state: 4 straight steps against 2 steps + save + a fresh trainer
  that auto-resumes + 2 steps: the adapters, their AdamW state and the
  update count bit-identical; the checkpoint holds the adapters alone; the
  base weights bit-unchanged; the exported adapter reloads bit-equal and
  the merged HF export equals ``W + scale * A @ B`` worked out here.
* ``configs/text/lora_sft.yaml`` with its paths pointed at a local HF
  directory (a toy llama with the ``bytefallback`` fixture tokenizer) and
  a conversation jsonl passes the port's gates and builds the trainer at its
  own knobs (rank 16, alpha 32, seq 4096, micro-batch 2): frozen base,
  adapters on the seven projections, a first batch of masked prompts.
"""

import json
import os
import shutil

import numpy as np
import torch

from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
from veomni_tpu_torch.models.hf_io import hf_to_params
from veomni_tpu_torch.models.jax_weights import load_jax_adapters, load_jax_params
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextTrainer

from test_e2e_training import TOY, _make_args, _write_dummy_data
from test_torch_trainer import StopAt, assert_bit_identical, port_args, record_steps
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "tokenizers")
VOCAB = 4096


def write_conversations(path, n=48, seed=0):
    """Chat rows from the paragraphs of docs/testing.md: an optional system
    turn, then one or two user/assistant pairs of at most 160 characters."""
    with open(os.path.join(REPO, "docs", "testing.md"), encoding="utf-8") as f:
        paras = [p.strip().replace("\n", " ") for p in f.read().split("\n\n") if p.strip()]
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            msgs = [{"role": "system", "content": "Answer briefly."}] if rng.random() < 0.5 else []
            for _ in range(int(rng.integers(1, 3))):
                for role in ("user", "assistant"):
                    p = paras[int(rng.integers(len(paras)))]
                    start = int(rng.integers(max(1, len(p) - 160)))
                    msgs.append({"role": role, "content": p[start:start + 160]})
            f.write(json.dumps({"messages": msgs}) + "\n")


def sft(args, tokenizer_dir):
    args.model.config_overrides = dict(TOY, vocab_size=VOCAB)
    args.model.tokenizer_path = tokenizer_dir
    args.model.lora = {"rank": 4, "alpha": 8}
    args.model.freeze_modules = [r"layers\.v_proj\."]
    args.train.module_lr_scales = {r"q_proj": 0.1}
    args.data.data_type = "conversation"
    args.train.train_steps = 2
    return args


def test_lora_conversation_trainer_matches_jax_trainer(tmp_path):
    import jax

    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer

    write_conversations(tmp_path / "data.jsonl")
    tok = os.path.join(FIXTURES, "bytelevel")
    j_trainer = JaxTextTrainer(sft(_make_args(tmp_path), tok))
    base = jax.tree.map(np.asarray, j_trainer.base_params)
    lora = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    trainer = TextTrainer(sft(port_args(tmp_path), tok))
    load_jax_params(trainer.base_model, base)
    load_jax_adapters(trainer.train_state.model, lora)
    assert len(trainer.grad_mask) == 3  # the v_proj adapter's lora_a, lora_b, scale
    seen = record_steps(trainer)
    assert trainer.train().global_step == 2
    got, ref = np.array(seen), np.array(j_seen)
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-5, err_msg="grad_norm")


def adapter_state(trainer):
    opt = trainer.train_state.optimizer
    out = {f"param.{n}": p.detach().clone()
           for n, p in trainer.train_state.model.named_jax_parameters()}
    for n, p in trainer.train_state.model.named_jax_parameters():
        for k, v in opt.state[p].items():
            out[f"opt.{n}.{k}"] = v.detach().clone()
    out["num_updates"] = torch.tensor(opt.num_updates)
    return out


def test_lora_resume_and_exports(tmp_path):
    _write_dummy_data(tmp_path / "data.jsonl")

    def lora_args(name, **kw):
        args = port_args(tmp_path, name, train_steps=4, **kw)
        args.model.lora = {"rank": 4, "alpha": 8}
        return args

    trainer_a = TextTrainer(lora_args("a", save_hf_weights=True))
    base = {n: p.detach().clone() for n, p in trainer_a.base_model.named_parameters()}
    losses_a = record_steps(trainer_a)
    trainer_a.train()
    ref = adapter_state(trainer_a)
    for n, p in trainer_a.base_model.named_parameters():
        assert torch.equal(p, base[n]), n
    out = tmp_path / "a"
    # the exported adapter and the merged model
    from veomni_tpu_torch.lora import LoraConfig, init_lora_params, load_adapter

    back = load_adapter(str(out / "lora_adapter"),
                        init_lora_params(None, trainer_a.base_model, LoraConfig(rank=4, alpha=8)))
    for (n, a), (_, b) in zip(back.named_jax_parameters(),
                              trainer_a.train_state.model.named_jax_parameters()):
        assert torch.equal(a, b), n
    merged = hf_to_params(str(out / "hf_ckpt"), trainer_a.base_model.cfg,
                          type(trainer_a.base_model)(trainer_a.base_model.cfg, None, device="cpu"))
    leaf = trainer_a.train_state.model.leaf("layers.q_proj")
    for i, layer in enumerate(trainer_a.base_model.layers):
        want = layer.q_proj + leaf.scale * (leaf.lora_a[i] @ leaf.lora_b[i])
        torch.testing.assert_close(merged.layers[i].q_proj, want, rtol=1e-6, atol=1e-7)
        assert not torch.equal(merged.layers[i].gate_proj, layer.gate_proj)  # adapted too
    assert torch.equal(merged.embed_tokens, trainer_a.base_model.embed_tokens)
    trainer_a.checkpointer.close()
    destroy_parallel_state()

    trainer_b1 = TextTrainer(lora_args("b", save_steps=2))
    trainer_b1.callbacks.append(StopAt(2))
    losses_b = record_steps(trainer_b1)
    assert trainer_b1.train().global_step == 2
    trainer_b1.checkpointer.close()
    destroy_parallel_state()
    payload = torch.load(tmp_path / "b" / "checkpoints" / "global_step_2" / "train_state"
                         / "model.pt")
    assert all(k.startswith("leaves.") for k in payload) and len(payload) == 3 * 7

    trainer_b2 = TextTrainer(lora_args("b", save_steps=2))
    losses_b2 = record_steps(trainer_b2)
    assert trainer_b2.train().global_step == 4
    assert losses_b + losses_b2 == losses_a
    assert_bit_identical(ref, adapter_state(trainer_b2), "resumed adapter state")
    trainer_b2.checkpointer.close()


def test_lora_sft_yaml_trains_from_an_hf_directory(tmp_path):
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.hf_io import save_hf_checkpoint
    from veomni_tpu_torch.trainer.base import check_supported

    hf = tmp_path / "hf"
    cfg = TransformerConfig(model_type="llama", vocab_size=VOCAB, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, tie_word_embeddings=False)
    save_hf_checkpoint(Transformer(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg,
                       str(hf))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(FIXTURES, "bytefallback", name), hf / name)
    write_conversations(tmp_path / "data.jsonl", n=16)
    args = parse_args(VeOmniArguments, [
        os.path.join(REPO, "configs", "text", "lora_sft.yaml"),
        f"--model.config_path={hf}", f"--model.model_path={hf}",
        f"--data.train_path={tmp_path / 'data.jsonl'}",
        f"--train.output_dir={tmp_path / 'out'}", "--train.platform=cpu",
        "--train.train_steps=1", "--train.save_hf_weights=false", "--train.async_save=false",
        "--train.bf16=false"])
    assert args.model.lora == {"rank": 16, "alpha": 32}
    assert (args.data.data_type, args.data.max_seq_len) == ("conversation", 4096)
    assert args.train.micro_batch_size == 2
    check_supported(args)
    trainer = TextTrainer(args)
    assert trainer.tokenizer.bos_token == "<s>"
    assert len(trainer.train_state.model.paths) == 7  # q/k/v/o and the MLP
    assert all(not p.requires_grad for p in trainer.base_model.parameters())
    batch = next(iter(trainer.dataloader))
    assert batch["input_ids"].shape == (1, 2, 4096)
    assert (batch["labels"] == -100).any() and (batch["labels"] != -100).any()
    trainer.checkpointer.close()
