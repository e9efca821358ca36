"""The port's trainer (``veomni_tpu_torch.trainer``) against the JAX one, on the CPU.

* Parity: the port's ``TextTrainer`` and the JAX ``TextTrainer`` on the
  reference's e2e toy (``tests/test_e2e_training.py``: ``TOY``, 2 layers,
  head_dim 16, f32, ``_write_dummy_data``'s corpus) for 8 steps from the same
  initial weights (the JAX trainer's, carried over by ``load_jax_params``):
  every step's loss and grad_norm within rtol 1e-5. The JAX trainer runs on
  the test harness's 4 virtual CPU devices, so at micro_batch_size 1 its
  global micro-batch is 4 rows; the port runs at world size 1 with
  micro_batch_size 4. Both dataloaders then yield the same [1, 4, 128]
  batches from the same seed.
* Exact resume (the port's twin of ``_run_resume_case``): 8 straight steps
  against 4 steps + save + a fresh trainer that auto-resumes + 4 steps, with
  parameters, AdamW moments and step counts, ``num_updates`` and the
  dataloader cursor bit-identical, for sync and async saves; and an async
  save at step 4 whose payload equals a sync save of the same run at the
  same step, so no later in-place update leaks into it.
* The entry point ``python -m veomni_tpu_torch.tasks.train_text`` in a
  subprocess on a YAML with ``platform: cpu`` (the twin of
  ``tests/test_cli_subprocess.py``).
* From an HF directory (the JAX ``save_hf_checkpoint`` of the toy's initial
  weights, ``config_path`` and ``model_path``) with ``dyn_bsz``, prefetch 2
  and ``save_hf_weights``: the port's ``TextTrainer`` against the JAX one
  for 8 steps (loss and grad_norm within rtol 1e-5), and the JAX
  ``hf_to_params`` reads the port's export equal to its final parameters.
* The feature gate raises ``NotImplementedError`` naming each knob whose
  module is not ported yet and admits the ported ones (the eval loop, the
  channel loss and W&B among them since the post-training slice; every
  optimizer, the numerics observatory and the exporter since slice E);
  ``train.platform`` other than cpu/cuda and a launcher asking for several
  processes raise too.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from veomni_tpu_torch.arguments import VeOmniArguments, parse_args
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextTrainer
from veomni_tpu_torch.trainer.base import check_supported
from veomni_tpu_torch.trainer.callbacks import Callback

from test_e2e_training import TOY, _make_args, _write_dummy_data
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_OVERRIDES = dict(platform="cpu", micro_batch_size=4, prefetch_depth=0)


def port_args(tmp_path, out_name="port", **train_overrides):
    """The reference e2e toy's arguments for the port at world size 1."""
    args = VeOmniArguments()
    args.model.config_overrides = dict(TOY)
    args.data.train_path = str(tmp_path / "data.jsonl")
    args.data.data_type = "pretokenized"
    args.data.max_seq_len = 128
    args.train.output_dir = str(tmp_path / out_name)
    args.train.train_steps = 8
    args.train.lr = 1e-3
    args.train.bf16 = False
    args.train.async_save = False
    args.train.save_hf_weights = False
    args.train.log_steps = 100
    for k, v in {**PORT_OVERRIDES, **train_overrides}.items():
        setattr(args.train, k, v)
    return args


def record_steps(trainer):
    """Wrap the trainer's step; returns the list each step's (loss,
    grad_norm) lands in."""
    seen = []
    orig = trainer.train_step

    def wrapped(state, batch):
        out = orig(state, batch)
        seen.append((float(out[1]["loss"]), float(out[1]["grad_norm"])))
        return out

    trainer.train_step = wrapped
    return seen


class StopAt(Callback):
    def __init__(self, at):
        self.at = at

    def on_step_end(self, trainer, state):
        if state.global_step >= self.at:
            state.should_stop = True


def state_tensors(trainer):
    """Parameters, AdamW state (moments and step counts) by name, plus the
    update count, as host tensors."""
    model, opt = trainer.train_state.model, trainer.train_state.optimizer
    out = {f"param.{n}": p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in opt.state[p].items():
            out[f"opt.{n}.{k}"] = v.detach().clone()
    out["num_updates"] = torch.tensor(opt.num_updates)
    out["train_state.step"] = torch.tensor(trainer.train_state.step)
    return out


def assert_bit_identical(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (
            f"{what}: {k} differs, max abs diff "
            f"{(a[k].double() - b[k].double()).abs().max().item()}")


def test_trainer_matches_jax_trainer(tmp_path):
    """8 steps: the port's per-step loss and grad_norm against the JAX
    TextTrainer's, rtol 1e-5, from the same initial weights and batches."""
    import jax

    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer
    from veomni_tpu_torch.models.jax_weights import load_jax_params

    _write_dummy_data(tmp_path / "data.jsonl")
    j_trainer = JaxTextTrainer(_make_args(tmp_path))
    init = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    trainer = TextTrainer(port_args(tmp_path))
    load_jax_params(trainer.train_state.model, init)
    seen = record_steps(trainer)
    ctl = trainer.train()
    assert ctl.global_step == 8 and len(seen) == len(j_seen) == 8
    got, ref = np.array(seen), np.array(j_seen)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-5, err_msg="grad_norm")
    assert got[-2:, 0].mean() < got[:2, 0].mean()  # it trains


def test_hf_dir_trainer_matches_jax_trainer(tmp_path):
    """The toy from an HF directory with dyn_bsz, prefetch 2 and the HF
    export at train end, in both trainers on the same arguments: 8 steps'
    loss and grad_norm within rtol 1e-5; the port's export read by the JAX
    hf_to_params equals the port's final parameters (f32, exactly)."""
    import jax

    from veomni_tpu.models.config import TransformerConfig as JaxConfig
    from veomni_tpu.models.hf_io import hf_to_params as j_hf_to_params
    from veomni_tpu.models.hf_io import save_hf_checkpoint as j_save
    from veomni_tpu.models.transformer import init_params as j_init
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer
    from veomni_tpu_torch.models.jax_weights import to_jax_tree

    _write_dummy_data(tmp_path / "data.jsonl")
    j_cfg = JaxConfig(**TOY)
    hf = str(tmp_path / "hf")
    j_save(j_init(jax.random.PRNGKey(0), j_cfg), j_cfg, hf, max_shard_bytes=100_000)
    assert os.path.exists(os.path.join(hf, "model.safetensors.index.json"))

    def hf_args(args):
        args.model.config_overrides = {}
        args.model.config_path = args.model.model_path = hf
        args.data.dyn_bsz = True
        args.train.prefetch_depth = 2
        args.train.save_hf_weights = True
        return args

    j_trainer = JaxTextTrainer(hf_args(_make_args(tmp_path)))
    j_seen = record_steps(j_trainer)
    j_trainer.train()
    j_trainer.checkpointer.close()
    j_destroy()

    trainer = TextTrainer(hf_args(port_args(tmp_path)))
    seen = record_steps(trainer)
    ctl = trainer.train()
    assert ctl.global_step == 8 and len(seen) == len(j_seen) == 8
    got, ref = np.array(seen), np.array(j_seen)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-5, err_msg="grad_norm")
    export = os.path.join(str(tmp_path / "port"), "hf_ckpt")
    back = j_hf_to_params(export, JaxConfig.from_pretrained(export))
    final = to_jax_tree(trainer.train_state.model)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_final = dict(jax.tree_util.tree_leaves_with_path(final))
    assert len(flat_back) == len(flat_final)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_final[path], err_msg=str(path))


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_resume_is_bit_exact(tmp_path, async_save):
    """8 straight steps vs 4 steps, save, restart, 4 steps."""
    _write_dummy_data(tmp_path / "data.jsonl")
    trainer_a = TextTrainer(port_args(tmp_path, "a", async_save=async_save))
    losses_a = record_steps(trainer_a)
    assert trainer_a.train().global_step == 8
    ref = state_tensors(trainer_a)
    ref_cursor = trainer_a.dataloader.state_dict()
    trainer_a.checkpointer.close()
    destroy_parallel_state()

    # train_steps stays 8 (the lr horizon must match run A); a callback stops
    # the first leg after step 4, like a preempted job
    trainer_b1 = TextTrainer(port_args(tmp_path, "b", async_save=async_save, save_steps=4))
    trainer_b1.callbacks.append(StopAt(4))
    losses_b = record_steps(trainer_b1)
    assert trainer_b1.train().global_step == 4
    trainer_b1.checkpointer.close()
    destroy_parallel_state()

    trainer_b2 = TextTrainer(port_args(tmp_path, "b", async_save=async_save, save_steps=4))
    losses_b2 = record_steps(trainer_b2)
    assert trainer_b2.train().global_step == 8
    assert losses_b + losses_b2 == losses_a
    assert_bit_identical(ref, state_tensors(trainer_b2), "resumed train state")
    assert trainer_b2.dataloader.state_dict() == ref_cursor
    assert trainer_b2.train_state.optimizer.num_updates == 8
    trainer_b2.checkpointer.close()


class SaveAt(Callback):
    """Saves ``checkpointer`` at step ``at`` (a second, synchronous one)."""

    def __init__(self, at, checkpointer):
        self.at, self.checkpointer = at, checkpointer

    def on_step_end(self, trainer, state):
        if state.global_step == self.at:
            self.checkpointer.save(state.global_step, trainer.train_state)


def test_async_save_does_not_race_the_next_step(tmp_path, monkeypatch):
    """An async save at step 4 whose writer thread starts late, then four
    more in-place updates: its payload equals a synchronous save of the same
    run at step 4, byte for byte of every tensor."""
    from veomni_tpu_torch.checkpoint import build_checkpointer
    from veomni_tpu_torch.checkpoint import checkpointer as ckmod
    from veomni_tpu_torch.checkpoint.checkpointer import _StateWriter

    real_save = ckmod.torch.save

    def late_save(obj, f):
        if "sync_ck" not in f.name:
            time.sleep(0.5)  # the async writer starts late: the loop runs on
        return real_save(obj, f)

    monkeypatch.setattr(ckmod.torch, "save", late_save)
    _write_dummy_data(tmp_path / "data.jsonl")
    trainer = TextTrainer(port_args(tmp_path, "run", async_save=True, save_steps=4))
    sync_ck = build_checkpointer(str(tmp_path / "sync_ck"), async_save=False)
    trainer.callbacks.append(SaveAt(4, sync_ck))
    trainer.train()
    trainer.checkpointer.close()
    sync_ck.close()
    got = _StateWriter.restore(os.path.join(trainer.checkpointer.ckpt_dir, "global_step_4",
                                            "train_state"))
    ref = _StateWriter.restore(os.path.join(sync_ck.ckpt_dir, "global_step_4", "train_state"))
    assert_bit_identical(got["model"], ref["model"], "model")
    opt_got, opt_ref = got["optimizer"], ref["optimizer"]
    assert opt_got["num_updates"] == opt_ref["num_updates"] == 4
    assert opt_got["param_groups"] == opt_ref["param_groups"]
    for i in opt_ref["state"]:
        assert_bit_identical(opt_got["state"][i], opt_ref["state"][i], f"optimizer state {i}")
    # and the run went on past it: step 8 differs from step 4
    last = _StateWriter.restore(os.path.join(trainer.checkpointer.ckpt_dir, "global_step_8",
                                             "train_state"))
    assert last["optimizer"]["num_updates"] == 8
    assert not torch.equal(last["model"]["norm"], ref["model"]["norm"])


def test_train_text_entry_point_subprocess(tmp_path):
    """``python -m veomni_tpu_torch.tasks.train_text cfg.yaml`` on the CPU:
    three logged finite steps and a committed final checkpoint."""
    rng = np.random.default_rng(0)
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for _ in range(64):
            f.write(json.dumps(
                {"input_ids": rng.integers(0, 256, int(rng.integers(16, 48))).tolist()}) + "\n")
    overrides = "\n".join(f"    {k}: {json.dumps(v)}" for k, v in TOY.items())
    cfg = tmp_path / "toy.yaml"
    cfg.write_text(f"""
model:
  config_overrides:
{overrides}
data:
  train_path: {data}
  data_type: pretokenized
  max_seq_len: 64
train:
  platform: cpu
  output_dir: {tmp_path}/out
  micro_batch_size: 2
  train_steps: 3
  bf16: false
  async_save: false
  save_hf_weights: false
  prefetch_depth: 0
  log_steps: 1
""")
    env = dict(os.environ)
    env["VEOMNI_LOG_LEVEL"] = "INFO"
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "veomni_tpu_torch.tasks.train_text", str(cfg),
         "--train.lr=1e-3"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    losses = [float(m) for m in re.findall(r"step \d+/3 \| loss=([0-9.]+)", out)]
    assert len(losses) == 3 and all(np.isfinite(losses)), out[-3000:]
    step_dir = tmp_path / "out" / "checkpoints" / "global_step_3"
    assert (step_dir / "train_state" / "optimizer.pt").exists()
    assert (step_dir / "manifest.json").exists()
    with open(tmp_path / "out" / "train_config.json") as f:
        assert json.load(f)["train"]["lr"] == 1e-3


GATED = [
    ("data", "data_type", "qwen2_5_vl", "data.data_type 'qwen2_5_vl'"),
    ("train", "num_virtual_devices", 4, "train.num_virtual_devices"),
    ("train", "ulysses_async", True, "train.ulysses_async"),
]


@pytest.mark.parametrize("section,knob,value,name", GATED, ids=[g[3] for g in GATED])
def test_gate_raises_for_unported_knob(tmp_path, section, knob, value, name):
    args = port_args(tmp_path)
    check_supported(args)  # the base arguments pass
    setattr(getattr(args, section), knob, value)
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        TextTrainer(args)


PORTED = [
    ("model", "lora", {"rank": 8}, "model.lora"),
    ("model", "freeze_modules", ["^embed"], "model.freeze_modules"),
    ("train", "module_lr_scales", {"q_proj": 0.1}, "train.module_lr_scales"),
    ("data", "data_type", "conversation", "data.data_type 'conversation'"),
    ("model", "tokenizer_path", "/a/tokenizer/dir", "model.tokenizer_path"),
    ("data", "eval_path", "/nonexistent", "data.eval_path"),
    ("data", "channel_list", ["code"], "data.channel_list"),
    ("train", "use_wandb", True, "train.use_wandb"),
    # slice E: the optimizers, the numerics observatory and the exporter
    ("train", "optimizer", "muon", "train.optimizer 'muon'"),
    ("train", "optimizer", "anyprecision_adamw", "train.optimizer 'anyprecision_adamw'"),
    ("train", "optimizer", "adafactor", "train.optimizer 'adafactor'"),
    ("train", "optimizer", "sgd", "train.optimizer 'sgd'"),
    ("train", "observability_numerics_interval", 5, "train.observability_numerics_interval"),
    ("train", "observability_port", 9100, "train.observability_port"),
]


@pytest.mark.parametrize("section,knob,value,name", PORTED, ids=[g[3] for g in PORTED])
def test_gate_admits_ported_knob(tmp_path, section, knob, value, name):
    args = port_args(tmp_path)
    setattr(getattr(args, section), knob, value)
    check_supported(args)


@pytest.mark.parametrize("knob", ["ulysses_parallel_size", "expert_parallel_size",
                                  "tensor_parallel_size", "data_parallel_shard_size"])
def test_parallel_sizes_above_one_raise(tmp_path, knob):
    _write_dummy_data(tmp_path / "data.jsonl")
    with pytest.raises(NotImplementedError, match="slice C"):
        TextTrainer(port_args(tmp_path, **{knob: 2}))


def test_platform_and_launcher_guards(tmp_path, monkeypatch):
    _write_dummy_data(tmp_path / "data.jsonl")
    with pytest.raises(ValueError, match="platform 'tpu'"):
        TextTrainer(port_args(tmp_path, platform="tpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="world size 1"):
        TextTrainer(port_args(tmp_path))


def test_yaml_parses_to_the_reference_dataclasses(tmp_path):
    """The same YAML and overrides give the same argument tree in both
    packages (the port's arguments are a copy)."""
    from veomni_tpu.arguments import VeOmniArguments as JaxArguments
    from veomni_tpu.arguments import parse_args as j_parse_args

    cfg = tmp_path / "c.yaml"
    cfg.write_text("model:\n  config_overrides: {hidden_size: 64}\n"
                   "data: {max_seq_len: 256, data_type: pretokenized}\n"
                   "train: {lr: 1e-3, save_steps: 5, betas: [0.9, 0.95]}\n")
    argv = [str(cfg), "--train.micro_batch_size=3", "--train.bf16", "false"]
    got = dataclasses.asdict(parse_args(VeOmniArguments, list(argv)))
    ref = dataclasses.asdict(j_parse_args(JaxArguments, list(argv)))
    assert got == ref
    assert got["train"]["lr"] == 1e-3 and got["train"]["micro_batch_size"] == 3
