"""The trainer's remaining callbacks in the port, against the JAX package,
on the CPU: the eval loop, the channel loss, W&B and the MoE router monitor.

* ``evaluate()``: the port's ``TextTrainer`` and the JAX one on the e2e toy
  (2 layers, hidden 64, f32) from the same weights give the same
  ``eval_loss`` over ``data.eval_path``; the ``EvaluateCallback`` puts it in
  the metrics every ``eval_steps`` steps, the same value on unchanged
  weights.
* The channel loss: ``make_channel_loss_fn`` against the reference's on a
  packed batch with ``channel_ids`` (total, ``ntokens``, per-channel sums
  and counts), and on a Qwen2-VL toy's merged hidden states; three trainer
  steps with a two-channel ``data.channel_list``
  in both packages (losses, grad norms, and the callbacks' running sums and
  counts); the per-channel sums add up to each step's loss sum. A run
  stopped at step 2 and resumed ends with the uninterrupted run's totals:
  the callback sits ahead of the checkpoint, so step 2's sums are in the
  step-2 save.
* W&B: with a fake ``wandb`` module in ``sys.modules``, the port's
  ``WandbCallback`` and the reference's log the same payloads on the same
  states; a whole port run logs its synced steps and its eval losses and
  finishes the run; without ``wandb`` the callback turns itself off.
* The MoE monitor: ``capture_router_stats`` on a MoE toy (4 experts, top-2)
  against the reference's replay: the same per-layer expert load; the
  gauges are published; the callback replays the step's first micro-batch.
* The trainer's gate admits ``data.eval_path``, ``data.channel_list`` and
  ``train.use_wandb``, and still refuses slice-C and slice-E knobs.

Tolerances: losses, ``eval_loss`` and channel sums rtol 1e-5 (counts and
loads exact), grad norms rtol 1e-4.
"""

import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextTrainer
from veomni_tpu_torch.trainer.base import check_supported
from veomni_tpu_torch.trainer.callbacks import Callback, TrainerControlState

from test_e2e_training import TOY, _make_args, _write_dummy_data
from test_torch_dpo import record_metrics
from test_torch_trainer import StopAt, port_args
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

CHANNELS = ["code", "math"]


def with_eval(args, tmp_path, eval_steps=0):
    args.data.eval_path = str(tmp_path / "eval.jsonl")
    args.train.eval_batches = 2
    args.train.eval_steps = eval_steps
    return args


def test_evaluate_matches_jax(tmp_path):
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer

    _write_dummy_data(tmp_path / "data.jsonl")
    _write_dummy_data(tmp_path / "eval.jsonl", n=64, seed=1)
    j_trainer = JaxTextTrainer(with_eval(_make_args(tmp_path), tmp_path))
    ref = j_trainer.evaluate()
    init = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_trainer.checkpointer.close()

    trainer = TextTrainer(with_eval(port_args(tmp_path, train_steps=4), tmp_path, eval_steps=2))
    load_jax_params(trainer.train_state.model, init)
    got = trainer.evaluate()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert trainer.evaluate() == got  # the same slice every call

    class EvalLosses(Callback):
        def __init__(self):
            self.seen = {}

        def on_step_end(self, trainer, state):
            if "eval_loss" in state.metrics:
                self.seen[state.global_step] = state.metrics["eval_loss"]

    rec = EvalLosses()
    trainer.callbacks.append(rec)
    trainer.train()
    assert sorted(rec.seen) == [2, 4] and rec.seen[4] < got
    assert trainer.evaluate() == rec.seen[4]
    trainer.checkpointer.close()


def channel_docs(seed=0):
    """Documents of 10-60 tokens on channel 0, 1 or none (-1)."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TOY["vocab_size"], int(n)).tolist(),
             "channel": int(rng.integers(-1, 2))} for n in rng.integers(10, 60, 8)]


def test_channel_loss_fn_matches_jax():
    from veomni_tpu.data.data_collator import TextPackingCollator as JaxCollator
    from veomni_tpu.models import TransformerConfig as JaxConfig
    from veomni_tpu.models import transformer as jtf
    from veomni_tpu.train.channel_loss import make_channel_loss_fn as j_make

    from veomni_tpu_torch.data.data_collator import TextPackingCollator
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.train.channel_loss import make_channel_loss_fn

    jcfg = JaxConfig(dtype=jnp.float32, **TOY)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(TransformerConfig(dtype=torch.float32, **TOY), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    batch = JaxCollator(128, 3, with_channels=True)(channel_docs())
    port_batch = TextPackingCollator(128, 3, with_channels=True)(channel_docs())
    for k in batch:  # the port's collator stamps the same channel ids
        np.testing.assert_array_equal(port_batch[k], batch[k], err_msg=k)
    assert {-1, 0, 1} <= set(np.unique(batch["channel_ids"]))
    ref_total, ref = j_make(types.SimpleNamespace(config=jcfg), 2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        total, got = make_channel_loss_fn(2)(model, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    assert int(got["ntokens"]) == int(ref["ntokens"])
    np.testing.assert_allclose(got["channel_loss_sums"].numpy(),
                               np.asarray(ref["channel_loss_sums"]), rtol=1e-5)
    np.testing.assert_array_equal(got["channel_token_counts"].numpy(),
                                  np.asarray(ref["channel_token_counts"]))


def test_channel_loss_fn_on_a_vision_language_model():
    """The Qwen2-VL toy of tests/test_torch_qwen2_vl.py: the channel loss
    reads the composite's merged hidden states (the reference's
    ``_vision_merged_hidden`` preamble), so its total is the composite's own
    loss (held to the JAX one by that file), and each row's channel counts
    the row's supervised tokens."""
    from veomni_tpu.models import qwen2_vl as jq2

    from veomni_tpu_torch.models.auto import FoundationModel
    from veomni_tpu_torch.train.channel_loss import make_channel_loss_fn

    from test_torch_qwen2_vl import GRIDS, VISION, configs, torch_batch, vl_batch

    jcfg, tcfg = configs("qwen2_vl", VISION)
    module = FoundationModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    batch = vl_batch(jq2, jcfg, GRIDS, seed=0)
    # one channel a row (the toy's rows supervise their padding too)
    batch["channel_ids"] = np.repeat(np.arange(2, dtype=np.int32)[:, None],
                                     batch["input_ids"].shape[1], axis=1)
    tb = torch_batch(batch)
    with torch.no_grad():
        total, got = make_channel_loss_fn(2)(module, tb)
        plain, metrics = module.loss_fn(tb)
    np.testing.assert_allclose(float(total), float(plain), rtol=1e-6)
    assert int(got["ntokens"]) == int(metrics["ntokens"])
    np.testing.assert_allclose(got["channel_loss_sums"].sum().item(), float(total), rtol=1e-6)
    valid = batch["labels"] != -100
    np.testing.assert_array_equal(got["channel_token_counts"].numpy(), valid.sum(1))


def channel_args(args):
    args.data.channel_list = list(CHANNELS)
    args.train.train_steps = 3
    return args


def channel_callback(trainer):
    from veomni_tpu_torch.train.channel_loss import ChannelLossCallback

    return next(cb for cb in trainer.callbacks if isinstance(cb, ChannelLossCallback))


def test_channel_loss_trainer_matches_jax(tmp_path):
    from veomni_tpu.train.channel_loss import ChannelLossCallback as JaxChannelCallback
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer

    _write_dummy_data(tmp_path / "data.jsonl", channels=CHANNELS)
    j_trainer = JaxTextTrainer(channel_args(_make_args(tmp_path)))
    init = jax.tree.map(np.asarray, j_trainer.train_state.params)
    j_seen = record_metrics(j_trainer)
    j_trainer.train()
    j_state = next(cb for cb in j_trainer.callbacks
                   if isinstance(cb, JaxChannelCallback)).state_dict()
    j_trainer.checkpointer.close()

    trainer = TextTrainer(channel_args(port_args(tmp_path)))
    load_jax_params(trainer.train_state.model, init)
    seen = record_metrics(trainer, ("ntokens", "channel_loss_sums", "channel_token_counts",
                                    "loss", "grad_norm"))
    trainer.train()
    got, ref = np.array([s[3:] for s in seen]), np.array(j_seen)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-4, err_msg="grad_norm")
    state = channel_callback(trainer).state_dict()
    np.testing.assert_allclose(state["sums"], j_state["sums"], rtol=1e-5)
    assert state["counts"] == j_state["counts"]
    for ntokens, sums, counts, loss, _ in seen:
        np.testing.assert_allclose(sum(sums), loss * ntokens, rtol=1e-5)
        assert sum(counts) == ntokens  # every row of this corpus has a channel
    trainer.checkpointer.close()


def test_channel_totals_survive_a_resume(tmp_path):
    _write_dummy_data(tmp_path / "data.jsonl", channels=CHANNELS)

    def args(name, **kw):
        return channel_args(port_args(tmp_path, name, train_steps=4, **kw))

    straight = TextTrainer(args("a"))
    straight.train()
    want = channel_callback(straight).state_dict()
    straight.checkpointer.close()
    destroy_parallel_state()
    first = TextTrainer(args("b", save_steps=2))
    first.callbacks.append(StopAt(2))
    first.train()
    first.checkpointer.close()
    destroy_parallel_state()
    resumed = TextTrainer(args("b", save_steps=2))
    resumed.train()
    assert channel_callback(resumed).state_dict() == want
    assert min(want["counts"]) > 0
    resumed.checkpointer.close()


class FakeRun:
    def __init__(self, **init):
        self.init, self.logs, self.finished = init, [], False

    def log(self, payload, step):
        self.logs.append((step, dict(payload)))

    def finish(self):
        self.finished = True


@pytest.fixture
def fake_wandb(monkeypatch):
    runs = []
    module = types.ModuleType("wandb")
    module.init = lambda **kw: runs.append(FakeRun(**kw)) or runs[-1]
    monkeypatch.setitem(sys.modules, "wandb", module)
    return runs


def test_wandb_payload_matches_jax(fake_wandb):
    from veomni_tpu.observability.metrics import get_registry as j_registry
    from veomni_tpu.trainer.callbacks import WandbCallback as JaxWandbCallback

    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.trainer.callbacks import WandbCallback

    j_registry().reset()  # no export of an earlier run in this process
    get_registry().reset()

    port, ref = WandbCallback("proj", "run", config={"a": 1}), JaxWandbCallback("proj", "run",
                                                                               config={"a": 1})
    assert fake_wandb[0].init == fake_wandb[1].init == dict(project="proj", name="run",
                                                            config={"a": 1})
    states = [dict(global_step=1, synced=True, metrics={"loss": 2.5, "grad_norm": 1.0,
                                                        "vec": np.ones(2)}),
              dict(global_step=2, synced=False, metrics={"loss": torch.tensor(2.0)}),
              dict(global_step=3, synced=False, metrics={"eval_loss": 2.25}),
              dict(global_step=4, synced=True, metrics={"loss": 2.0, "eval_loss": 2.2})]
    for kw in states:
        state = TrainerControlState(**kw)
        port.on_step_end(None, state)
        ref.on_step_end(None, state)
    port.on_train_end(None, state)
    ref.on_train_end(None, state)
    assert fake_wandb[0].logs == fake_wandb[1].logs
    assert [s for s, _ in fake_wandb[0].logs] == [1, 3, 4, 4]
    assert fake_wandb[0].finished and fake_wandb[1].finished


def test_wandb_in_a_run_and_without_wandb(tmp_path, fake_wandb, monkeypatch):
    _write_dummy_data(tmp_path / "data.jsonl")
    _write_dummy_data(tmp_path / "eval.jsonl", n=64, seed=1)
    args = with_eval(port_args(tmp_path, train_steps=4, log_steps=2, use_wandb=True,
                               wandb_name="toy"), tmp_path, eval_steps=2)
    trainer = TextTrainer(args)
    trainer.train()
    run = fake_wandb[-1]
    assert run.init["name"] == "toy" and run.init["config"]["train"]["train_steps"] == 4
    logged = dict(run.logs[:2])
    assert sorted(logged) == [2, 4] and run.finished
    for step in (2, 4):
        assert {"loss", "grad_norm", "lr", "eval_loss"} <= set(logged[step])
    trainer.checkpointer.close()
    destroy_parallel_state()

    from veomni_tpu_torch.trainer.callbacks import WandbCallback

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    cb = WandbCallback("proj")
    assert cb._run is None
    cb.on_step_end(None, TrainerControlState(global_step=1, metrics={"loss": 1.0}))


MOE = dict(TOY, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32)


def test_router_stats_match_jax(tmp_path):
    from veomni_tpu.data.data_collator import TextPackingCollator as JaxCollator
    from veomni_tpu.models import TransformerConfig as JaxConfig
    from veomni_tpu.models import transformer as jtf
    from veomni_tpu.utils.moe_monitor import capture_router_stats as j_capture

    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.observability.metrics import get_registry
    from veomni_tpu_torch.utils.moe_monitor import (
        MoERouterMonitorCallback,
        capture_router_stats,
        publish_router_stats,
    )

    jcfg = JaxConfig(dtype=jnp.float32, **MOE)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(TransformerConfig(dtype=torch.float32, **MOE), None, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    batch = JaxCollator(128, 2)([{"input_ids": rng.integers(0, 256, int(n)).tolist()}
                                 for n in rng.integers(10, 60, 6)])
    ref = j_capture(types.SimpleNamespace(config=jcfg), params,
                    {k: jnp.asarray(v) for k, v in batch.items()})["expert_load"]
    load = capture_router_stats(model, {k: torch.from_numpy(v) for k, v in batch.items()})[
        "expert_load"]
    assert load.shape == (2, 4)
    np.testing.assert_allclose(load.sum(1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(load, np.asarray(ref))
    publish_router_stats(load)
    reg = get_registry()
    assert reg.gauge("moe.layer1.max_load").value == load[1].max()
    nz = load[0][load[0] > 0]
    assert reg.gauge("moe.layer0.entropy").value == float(-(nz * np.log(nz)).sum())

    # the callback on a MoE trainer: the replay of the step's first micro-batch
    _write_dummy_data(tmp_path / "data.jsonl")
    args = port_args(tmp_path, train_steps=2)
    args.model.config_overrides = dict(MOE)
    trainer = TextTrainer(args)
    trainer.callbacks.append(MoERouterMonitorCallback(every_steps=2))
    trainer.train()
    micro = {k: torch.from_numpy(v[0]) for k, v in trainer.current_batch.items()}
    want = capture_router_stats(trainer.train_state.model, micro)["expert_load"]
    for li in range(2):
        assert reg.gauge(f"moe.layer{li}.max_load").value == want[li].max()
    trainer.checkpointer.close()


def test_gate_admits_the_callbacks_and_refuses_other_slices(tmp_path):
    args = port_args(tmp_path)
    args.data.eval_path = "/some/eval.jsonl"
    args.data.channel_list = ["code"]
    args.train.use_wandb = True
    # slice E's knobs are ported too
    args.train.observability_numerics_interval = 5
    args.train.observability_port = 9100
    check_supported(args)
    # slice C's knobs are ported too; a multimodal data type of slice F is not
    args.train.ulysses_async = True
    args.train.num_virtual_devices = 4
    check_supported(args)
    for section, knob, value, name in (
            ("data", "data_type", "vlm", "slice F"),
            ("data", "data_type", "omni", "slice F")):
        bad = port_args(tmp_path)
        setattr(getattr(bad, section), knob, value)
        with pytest.raises(NotImplementedError, match=re.escape(name)):
            check_supported(bad)


def test_post_training_trainers_take_their_data_types(tmp_path):
    from veomni_tpu_torch.trainer import DistillTrainer, RLTrainer, TextDPOTrainer

    for cls, kind in ((TextDPOTrainer, "dpo"), (DistillTrainer, "distill"), (RLTrainer, "rl")):
        args = port_args(tmp_path)
        args.data.data_type = kind
        check_supported(args, cls.SUPPORTED_DATA_TYPES)
        with pytest.raises(NotImplementedError, match=re.escape(f"data.data_type '{kind}'")):
            check_supported(args)  # the text trainer's types
